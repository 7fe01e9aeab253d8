"""HeteroFL in the port against the reference on the same inputs: the
width masks of the paper models, the width-overlap mean, and one hetero
dense round.

Tolerances: masks and the overlap mean's denominators exactly equal
(0/1 entries and their sums); the overlap mean of the same deltas rtol
1e-6; one hetero dense round rtol 1e-4 (atol 1e-6), XLA-CPU and ATen
summing the local gradients in different orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as ragg
from repro.fl.backends import DenseBackend as RefDenseBackend
from repro.models import paper_models as rpm
from repro_torch.convert import params_from_jax
from repro_torch.core import aggregation as pagg
from repro_torch.fl.backends import DenseBackend
from repro_torch.models import paper_models as ppm
from repro_torch.tree import tree_leaves, tree_map

MODELS = {
    "mlp": (lambda m: m.make_mlp(), (28, 28, 1)),
    "cnn": (lambda m: m.make_cnn(), (28, 28, 1)),
    "vgg": (lambda m: m.make_vgg(11, width_scale=0.125), (32, 32, 3)),
}
RATIOS = np.asarray([1.0, 0.5, 0.25, 0.125, 0.5], np.float32)
U, S_MAX, ETA = 5, 6, 0.5


def _np_params(name, seed=0):
    make, feat = MODELS[name]
    ref_model, model = make(rpm), make(ppm)
    rng = np.random.default_rng(seed)
    np_params = jax.tree.map(
        lambda a: (rng.standard_normal(a.shape)
                   / np.sqrt(max(np.prod(a.shape[:-1]), 1))).astype(a.dtype),
        jax.eval_shape(ref_model.init, jax.random.PRNGKey(0)))
    return ref_model, model, np_params, feat, rng


@pytest.mark.parametrize("name", sorted(MODELS))
def test_width_masks_match_reference(name):
    ref_model, model, np_params, _, _ = _np_params(name)
    ref = ref_model.width_masks(jax.tree.map(jnp.asarray, np_params), RATIOS)
    out = model.width_masks(params_from_jax(np_params, "cpu"), RATIOS)
    ref_leaves, out_leaves = jax.tree.leaves(ref), tree_leaves(out)
    assert len(out_leaves) == len(ref_leaves)
    for a, b in zip(out_leaves, ref_leaves):
        assert a.dtype == torch.float32 and a.is_contiguous()
        assert np.array_equal(a.numpy(), np.asarray(b))
    # the full-width client keeps everything; the head's outputs are shared
    assert all(bool(m[0].all()) for m in out_leaves)
    assert bool(out[-1]["b"].all())


def test_overlap_mean_matches_reference():
    ref_model, model, np_params, _, rng = _np_params("cnn")
    deltas_np = jax.tree.map(
        lambda a: rng.standard_normal((U,) + a.shape).astype(np.float32),
        np_params)
    part = np.asarray([1, 0, 1, 1, 0], np.float32)
    rw = ref_model.width_masks(jax.tree.map(jnp.asarray, np_params), RATIOS)
    rnum, rden = ragg.hetero_overlap_partials(
        jax.tree.map(jnp.asarray, deltas_np), rw, jnp.asarray(part))
    ref = ragg.hetero_overlap_mean(rnum, rden)
    pw = model.width_masks(params_from_jax(np_params, "cpu"), RATIOS)
    num, den = pagg.hetero_overlap_partials(
        params_from_jax(deltas_np, "cpu"), pw, torch.from_numpy(part))
    out = pagg.hetero_overlap_mean(num, den)
    for a, b in zip(tree_leaves(den), jax.tree.leaves(rden)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(tree_leaves(out), jax.tree.leaves(ref)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
    # two halves of the cohort (a chunk sum) give the same mean
    halves = [pagg.hetero_overlap_partials(
        tree_map(lambda d: d[sl], params_from_jax(deltas_np, "cpu")),
        tree_map(lambda m: m[sl], pw), torch.from_numpy(part[sl]))
        for sl in (slice(0, 2), slice(2, U))]
    summed = tree_map(torch.add, *halves)
    for a, b in zip(tree_leaves(pagg.hetero_overlap_mean(*summed)),
                    tree_leaves(out)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", ["mlp", "cnn"])
def test_hetero_dense_round_matches_reference(name):
    ref_model, model, np_params, feat, rng = _np_params(name)
    xb = rng.standard_normal((U, S_MAX) + feat).astype(np.float32)
    yb = rng.integers(0, 10, (U, S_MAX)).astype(np.int32)
    S = rng.integers(2, S_MAX + 1, U)
    wb = ((np.arange(S_MAX)[None, :] < S[:, None]) / S[:, None]).astype(
        np.float32)
    # HeteroFL's all-or-nothing rows
    mask = np.repeat(np.asarray([[1], [1], [0], [1], [1]], np.float32),
                     model.L, axis=1)
    p = np.zeros(model.L, np.float32)
    rparams = jax.tree.map(jnp.asarray, np_params)
    ref_out = RefDenseBackend(ref_model, donate=False).run_round(
        rparams, *map(jnp.asarray, (xb, yb, wb, mask, p)), jnp.float32(ETA),
        bias_correct=False, wmasks=ref_model.width_masks(rparams, RATIOS))
    params = params_from_jax(np_params, "cpu")
    out = DenseBackend(model, device="cpu").run_round(
        params, *map(torch.from_numpy, (xb, yb, wb, mask, p)), ETA,
        bias_correct=False, wmasks=model.width_masks(params, RATIOS))
    for a, b in zip(tree_leaves(out), jax.tree.leaves(ref_out)):
        assert a.shape == b.shape and a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-6)
    # the round moved the params
    assert any(bool((a != b).any()) for a, b in zip(tree_leaves(out),
                                                     tree_leaves(params)))
