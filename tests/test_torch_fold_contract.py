"""The fold's dtype contract for bf16 grads, against both reference paths.

The port keeps the kernel's contract: a fold returns the grads' dtype (as
``adel_agg`` and the reference's ``agg_impl="pallas"`` path do), and every
server update is applied in f32 and cast back to the params' dtype
(``fl/backends.py:_sub32``). The reference's default ``agg_impl="jnp"``
path contracts f32 coefficients with the bf16 leaf and returns f32 — a
trait of the reference, recorded in ROADMAP.md §3.

Tolerances: the port and the Pallas path both round one f32 sum of four
products to bf16 — equal here; against the jnp path's f32 values, half a
bf16 ulp (at most 2**-8 of the value: the rounding itself). A dense round
with bf16 params against the f32 update rounded once: the fold's own
rounding to bf16 (2**-9 of the aggregate) plus half an ulp of the update
on each side (one ulp, at most 2**-7 of the update); the temporal
backend, which folds in f32, rounds once too.
"""
import jax.numpy as jnp
import numpy as np
import torch

from repro.core.aggregation import aggregate_grads as ref_aggregate_grads
from repro.kernels.ops import adel_aggregate_pallas
from repro_torch.core.aggregation import aggregate_grads, layer_coefficients
from repro_torch.fl.backends import DenseBackend, apply_update
from repro_torch.fl.runtime import ModelAPI
from repro_torch.models.nn import cross_entropy
from repro_torch.tree import tree_leaves

U = 4


def _bf16_grads():
    rng = np.random.default_rng(0)
    f32 = {"a": rng.standard_normal((U, 3, 5)).astype(np.float32),
           "b": rng.standard_normal((U, 7)).astype(np.float32)}
    return ({k: torch.from_numpy(v).to(torch.bfloat16) for k, v in f32.items()},
            {k: jnp.asarray(v, jnp.bfloat16) for k, v in f32.items()})


def test_bf16_fold_keeps_the_grads_dtype_against_both_reference_paths():
    grads, rgrads = _bf16_grads()
    mask, p = np.ones((U, 2), np.float32), np.zeros(2, np.float32)
    out = aggregate_grads(grads, {"a": 0, "b": 1}, torch.from_numpy(mask),
                          torch.from_numpy(p))
    rids = {"a": jnp.int32(0), "b": jnp.int32(1)}
    ref_jnp = ref_aggregate_grads(rgrads, rids, jnp.asarray(mask),
                                  jnp.asarray(p))
    ref_pallas = adel_aggregate_pallas(rgrads, rids, jnp.asarray(mask),
                                       jnp.asarray(p))
    for k in ("a", "b"):
        assert out[k].dtype == torch.bfloat16
        assert ref_pallas[k].dtype == jnp.bfloat16
        assert ref_jnp[k].dtype == jnp.float32        # the reference's trait
        o = out[k].float().numpy()
        assert np.array_equal(o, np.asarray(ref_pallas[k], np.float32))
        r = np.asarray(ref_jnp[k])
        assert np.all(np.abs(o - r) <= 2.0 ** -8 * np.abs(r)), k


def _bf16_model():
    """A two-layer linear softmax model whose params are bf16: the loss
    reads them as f32, so its grads (and the client deltas) are bf16."""
    def forward(params, x):
        h = torch.relu(x @ params[0]["w"].float())
        return h @ params[1]["w"].float()

    def init(gen, device):
        return [{"w": torch.randn((6, 5), generator=gen).to(torch.bfloat16)},
                {"w": torch.randn((5, 3), generator=gen).to(torch.bfloat16)}]

    return ModelAPI(init=init, predict=forward,
                    loss=lambda params, x, y, w: cross_entropy(
                        forward(params, x), y, w),
                    layer_ids=lambda params: [{"w": 0}, {"w": 1}], L=2)


def test_bf16_dense_round_updates_in_f32_and_stays_bf16():
    model = _bf16_model()
    gen = torch.Generator().manual_seed(0)
    params = model.init(gen, "cpu")
    xb = torch.randn((U, 8, 6), generator=gen)
    yb = torch.randint(0, 3, (U, 8), generator=gen)
    wb = torch.full((U, 8), 1.0 / 8)
    mask = torch.tensor([[1.0, 1.0], [1.0, 0.0], [0.0, 1.0], [1.0, 1.0]])
    p = torch.tensor([0.1, 0.05])
    backend = DenseBackend(model, device="cpu")
    out = backend.run_round(params, xb, yb, wb, mask, p, 0.5,
                            bias_correct=True)
    deltas = backend._deltas(params, xb, yb, wb, 0.5)
    assert all(d.dtype == torch.bfloat16 for d in tree_leaves(deltas))
    agg = aggregate_grads(deltas, model.layer_ids(params), mask, p)
    # the contract: the fold in the deltas' dtype, the update in f32
    for o, e in zip(tree_leaves(out), tree_leaves(apply_update(params, agg))):
        assert o.dtype == torch.bfloat16 and torch.equal(o, e)
    # against the f32 update (the jnp path's f32 fold) rounded once
    c = layer_coefficients(mask, p)
    agg32 = [torch.einsum("u,u...->...", c[:, i], d.float())
             for i, d in enumerate(tree_leaves(deltas))]
    for o, w, a in zip(tree_leaves(out), tree_leaves(params), agg32):
        e = (w.float() - a).to(torch.bfloat16).float()
        assert torch.all((o.float() - e).abs()
                         <= 2.0 ** -9 * a.abs() + 2.0 ** -7 * e.abs()), \
            (o.float() - e).abs().max()
    assert any(bool((o != w).any()) for o, w in
               zip(tree_leaves(out), tree_leaves(params)))
    # the temporal backend accumulates the same deltas in f32
    from repro_torch.fl.backends import TemporalBackend
    tout = TemporalBackend(model, device="cpu").run_round(
        params, xb, yb, wb, mask, p, 0.5, bias_correct=True)
    for o, w, a in zip(tree_leaves(tout), tree_leaves(params), agg32):
        assert o.dtype == torch.bfloat16
        e = (w.float() - a).to(torch.bfloat16).float()
        assert torch.all((o.float() - e).abs() <= 2.0 ** -7 * e.abs())

