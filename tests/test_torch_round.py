"""One dense round: the port's ``DenseBackend`` against the reference's on
the same params, minibatches, mask, ``p`` and learning rate, for both of
the reference's aggregation paths (``agg_impl`` "jnp", and "pallas" in
interpret mode) and both wire formats (none, int8).

Tolerances: MLP rtol 1e-5 / atol 1e-6; CNN and VGG rtol 1e-4 / atol 1e-5
(XLA-CPU and ATen sum in different orders). Under int8 a delta that sits
on a rounding boundary may quantize one code apart, so each element may
also differ by one quantization step of every client: sum_u c[u,l]*scale[u,l].
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fl.backends import DenseBackend as RefDenseBackend
from repro.models import paper_models as rpm
from repro_torch.convert import params_from_jax
from repro_torch.core.aggregation import layer_coefficients
from repro_torch.core.compression import compress_deltas, make_compression
from repro_torch.fl.backends import DenseBackend
from repro_torch.models import paper_models as ppm
from repro_torch.tree import tree_leaves

MODELS = {
    "mlp": (lambda m: m.make_mlp(), (28, 28, 1)),
    "cnn": (lambda m: m.make_cnn(), (28, 28, 1)),
    "vgg": (lambda m: m.make_vgg(11, width_scale=0.125), (32, 32, 3)),
}
TOL = {"mlp": dict(rtol=1e-5, atol=1e-6), "cnn": dict(rtol=1e-4, atol=1e-5),
       "vgg": dict(rtol=1e-4, atol=1e-5)}
U, S_MAX, ETA = 4, 6, 0.5


def _round_inputs(name):
    make, feat = MODELS[name]
    ref_model, model = make(rpm), make(ppm)
    rng = np.random.default_rng(0)
    # params in the reference's pytree (its init's shapes), no zero head
    np_params = jax.tree.map(
        lambda a: (rng.standard_normal(a.shape)
                   / np.sqrt(max(np.prod(a.shape[:-1]), 1))).astype(a.dtype),
        jax.eval_shape(ref_model.init, jax.random.PRNGKey(0)))
    xb = rng.standard_normal((U, S_MAX) + feat).astype(np.float32)
    yb = rng.integers(0, 10, (U, S_MAX)).astype(np.int32)
    S = rng.integers(2, S_MAX + 1, U)
    wb = ((np.arange(S_MAX)[None, :] < S[:, None]) / S[:, None]).astype(
        np.float32)
    mask = (rng.uniform(size=(U, model.L)) > 0.3).astype(np.float32)
    mask[0] = 1.0                                    # every layer has a contributor
    p = rng.uniform(0.0, 0.2, model.L).astype(np.float32)
    return ref_model, model, np_params, (xb, yb, wb, mask, p)


# MLP and CNN meet both aggregation paths and both wire formats; VGG, the
# slowest reference step to compile on the CPU, runs the int8 round (its
# gradients are held tightly in tests/test_torch_models.py)
CASES = [(name, agg_impl, comp) for name in ("mlp", "cnn")
         for agg_impl in ("jnp", "pallas") for comp in (None, "int8")]
CASES += [("vgg", "jnp", "int8")]


@pytest.mark.parametrize("name,agg_impl,comp", CASES)
def test_dense_round_matches_reference(name, agg_impl, comp):
    ref_model, model, np_params, arrays = _round_inputs(name)
    ref = RefDenseBackend(ref_model, donate=False, compression=comp,
                          agg_impl=agg_impl)
    ref_out = ref.run_round(jax.tree.map(jnp.asarray, np_params),
                            *map(jnp.asarray, arrays), jnp.float32(ETA),
                            bias_correct=True)
    params = params_from_jax(np_params, "cpu")
    backend = DenseBackend(model, compression=comp, device="cpu")
    tarrays = [torch.from_numpy(a) for a in arrays]
    out = backend.run_round(params, *tarrays, ETA, bias_correct=True)

    steps = [0.0] * len(tree_leaves(params))
    if comp == "int8":
        # one quantization step per client: sum_u c[u, l] * scale[u, l]
        c = layer_coefficients(tarrays[3], tarrays[4])
        ids = tree_leaves(model.layer_ids(params))
        payload = compress_deltas(
            backend._deltas(params, *tarrays[:3], ETA),
            model.layer_ids(params), make_compression("int8"))
        steps = [float((c[:, l] * scale[:, 0]).sum())
                 for l, (_, scale) in zip(ids, payload)]
    tol = TOL[name]
    for a, b, step in zip(tree_leaves(out), jax.tree.leaves(ref_out), steps):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype
        assert np.all(np.abs(a - b) <= tol["atol"] + tol["rtol"] * np.abs(b)
                      + 1.0001 * step), (name, np.abs(a - b).max(), step)
