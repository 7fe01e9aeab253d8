"""The port's paper models, wire format and param conversion against the
reference on the same params and inputs.

Tolerances: MLP rtol 1e-5 / atol 1e-6; CNN and VGG rtol 1e-4 / atol 1e-5
(XLA-CPU and ATen convolve and sum in different orders). Layer ids, byte
counts, the int8 codes and the param round trip are exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as rcomp
from repro.models import nn as rnn
from repro.models import paper_models as rpm
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.core import compression as pcomp
from repro_torch.models import nn as pnn
from repro_torch.models import paper_models as ppm
from repro_torch.tree import tree_leaves, tree_map

MODELS = {
    "mlp": (lambda m: m.make_mlp(), (6, 28, 28, 1)),
    "cnn": (lambda m: m.make_cnn(), (6, 28, 28, 1)),
    "vgg": (lambda m: m.make_vgg(11, width_scale=0.125), (4, 32, 32, 3)),
}
TOL = {"mlp": dict(rtol=1e-5, atol=1e-6), "cnn": dict(rtol=1e-4, atol=1e-5),
       "vgg": dict(rtol=1e-4, atol=1e-5)}


def _np_params(ref_model, seed):
    """numpy params in the reference's pytree (its init's shapes), scaled
    normals, so no head is zero and every layer gets a gradient."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(ref_model.init, jax.random.PRNGKey(0))
    return jax.tree.map(
        lambda a: (rng.standard_normal(a.shape)
                   / np.sqrt(max(np.prod(a.shape[:-1]), 1))).astype(a.dtype),
        shapes)


def _pair(name, seed=0):
    """(reference model, port model, reference params, port params)."""
    make, _ = MODELS[name]
    ref_model, model = make(rpm), make(ppm)
    np_params = _np_params(ref_model, seed)
    return (ref_model, model, jax.tree.map(jnp.asarray, np_params),
            params_from_jax(np_params, "cpu"))


def _batch(name, seed=1):
    _, shape = MODELS[name]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    y = rng.integers(0, 10, shape[0]).astype(np.int32)
    w = np.full((shape[0],), 1.0 / shape[0], np.float32)
    return x, y, w


@pytest.mark.parametrize("name", list(MODELS))
def test_forward_loss_and_grads_match(name):
    ref_model, model, rparams, params = _pair(name)
    x, y, w = _batch(name)
    tol = TOL[name]
    args = (torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(w))
    logits, rlogits, rloss, rgrads = None, *jax.jit(
        lambda p, x, y, w: (ref_model.predict(p, x),
                            *jax.value_and_grad(ref_model.loss)(p, x, y, w)))(
        rparams, jnp.asarray(x), jnp.asarray(y), jnp.asarray(w))
    logits = model.predict(params, args[0])
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(rlogits),
                               **tol)
    grads, loss = torch.func.grad_and_value(model.loss)(params, *args)
    np.testing.assert_allclose(float(loss), float(rloss), **tol)
    for g, rg in zip(tree_leaves(grads), jax.tree.leaves(rgrads)):
        np.testing.assert_allclose(g.numpy(), np.asarray(rg), **tol)


@pytest.mark.parametrize("name", list(MODELS))
def test_layer_ids_and_payload_bytes_match(name):
    ref_model, model, rparams, params = _pair(name)
    rids = jax.tree.map(int, ref_model.layer_ids(rparams))
    ids = model.layer_ids(params)
    assert ids == rids
    assert model.L == ref_model.L
    for spec in (None, "int8", ("topk8", 0.05), ("topk8", 0.3)):
        assert pcomp.payload_bytes(params, ids, 10, pcomp.make_compression(
            spec)) == rcomp.payload_bytes(rparams, ref_model.layer_ids(
                rparams), 10, rcomp.make_compression(spec))


@pytest.mark.parametrize("name", list(MODELS))
def test_params_round_trip_is_exact(name):
    make, _ = MODELS[name]
    np_params = _np_params(make(rpm), 3)
    back = params_to_numpy(params_from_jax(np_params, "cpu"))
    for a, b in zip(jax.tree.leaves(np_params), tree_leaves(back)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_group_norm_and_pool_match():
    rng = np.random.default_rng(2)
    for C in (6, 12, 16):
        x = rng.standard_normal((2, 8, 8, C)).astype(np.float32) * 3 + 1
        g = rng.standard_normal(C).astype(np.float32)
        o = rng.standard_normal(C).astype(np.float32)
        np.testing.assert_allclose(
            pnn.group_norm(*map(torch.from_numpy, (x, g, o))).numpy(),
            np.asarray(rnn.group_norm(*map(jnp.asarray, (x, g, o)))),
            rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(
            pnn.maxpool2d(torch.from_numpy(x)).numpy(),
            np.asarray(rnn.maxpool2d(jnp.asarray(x))))


@pytest.mark.parametrize("mode", ["int8", "topk8"])
def test_wire_payload_matches_reference(mode):
    """Same deltas -> the same int8 codes and top-k indices, the same
    scales to the ulp, and the same fused fold."""
    _, model, rparams, params = _pair("mlp")
    U, L = 5, model.L
    rng = np.random.default_rng(4)
    deltas = tree_map(lambda p: rng.standard_normal((U,) + tuple(p.shape))
                      .astype(np.float32), params)
    ids = model.layer_ids(params)
    rids = jax.tree.map(jnp.int32, ids)
    cfg, rcfg = (pcomp.make_compression((mode, 0.1)),
                 rcomp.make_compression((mode, 0.1)))
    pay = pcomp.compress_deltas(tree_map(torch.from_numpy, deltas), ids, cfg)
    rpay = jax.jit(lambda d: rcomp.compress_deltas(d, rids, rcfg))(
        jax.tree.map(jnp.asarray, deltas))
    for e, re in zip(pay, rpay):
        q, rq = e[0].numpy(), np.asarray(re[0])
        # scales: jit lets XLA turn amax / 127 into a multiply, 1 ulp off
        np.testing.assert_allclose(e[1].numpy(), np.asarray(re[1]),
                                   rtol=2e-7, atol=0)
        if mode == "topk8":
            # equal magnitudes may come out in either order: compare the
            # kept (index, code) pairs sorted by index
            idx, ridx = e[2].numpy(), np.asarray(re[2])
            o, ro = np.argsort(idx, -1), np.argsort(ridx, -1)
            assert np.array_equal(np.take_along_axis(idx, o, -1),
                                  np.take_along_axis(ridx, ro, -1))
            q, rq = (np.take_along_axis(q, o, -1),
                     np.take_along_axis(rq, ro, -1))
        assert np.array_equal(q, rq)                                 # codes
    mask = (rng.uniform(size=(U, L)) > 0.3).astype(np.float32)
    p = rng.uniform(0.0, 0.2, L).astype(np.float32)
    out = pcomp.aggregate_compressed(pay, params, ids, torch.from_numpy(mask),
                                     torch.from_numpy(p), cfg=cfg)
    ref = jax.jit(lambda pay, m, p: rcomp.aggregate_compressed(
        pay, rparams, rids, m, p, cfg=rcfg))(rpay, jnp.asarray(mask),
                                             jnp.asarray(p))
    for a, b in zip(tree_leaves(out), jax.tree.leaves(ref)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)
