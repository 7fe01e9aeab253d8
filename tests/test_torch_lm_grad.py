"""Gradients through the port's LM kernels and model
(``repro_torch.kernels.flash_attention.FlashAttention``,
``repro_torch.kernels.ssd_scan.SSDScan``, ``models.transformer.loss_fn``,
``fl.tasks.make_lm_model``) against ``jax.grad`` of the reference's
training path on the same numpy inputs.

The reference trains through its jnp paths (``models.attention.
gqa_attention`` and ``models.ssm.ssd_chunked``; it has no backward kernel),
so those are the yardstick. On these CPU tensors each Function's forward is
its kernel's plain version and its backward the plain backward the card
runs too, under autograd, ``torch.func.grad`` and ``torch.func.vmap`` over
a client axis (the Functions' ``vmap`` rules).

Tolerances (all f32): a primitive's grads rtol 1e-4 / atol 1e-5 x max(1,
max |grad|) against the reference (XLA-CPU and ATen sum in different
orders; the flash backward uses the forward's output O where autodiff
uses the softmax), a model loss's per-client grads rtol 1e-4 / atol 1e-5;
the Function against autograd through
the plain forward 1e-5 (same math, another order); ``remat`` recomputes
the same ops, 1e-6.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.fl.tasks import make_lm_model as ref_make_lm_model
from repro.models import attention as rattn
from repro.models import ssm as rssm
from repro.models import transformer as rtr
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.fl.tasks import make_lm_model
from repro_torch.kernels.flash_attention import (FlashAttention,
                                                 flash_attention_plain)
from repro_torch.kernels.ops import gqa_flash, ssd_chunked_kernel
from repro_torch.kernels.ssd_scan import SSDScan, ssd_scan_plain
from repro_torch.launch.steps import make_train_step
from repro_torch.models import transformer as ptr
from repro_torch.tree import tree_leaves
from test_torch_lm import _np_params

# the kernel modules (``repro_torch.kernels`` re-exports their functions
# under the same names)
pflash = importlib.import_module("repro_torch.kernels.flash_attention")
pssd = importlib.import_module("repro_torch.kernels.ssd_scan")

REF_TOL = dict(rtol=1e-4, atol=1e-5)
PLAIN_TOL = dict(rtol=1e-5, atol=1e-5)
ARCHS = ["qwen1.5-4b", "hymba-1.5b", "mamba2-370m"]


def _normal(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _close(out, ref, tol) -> None:
    np.testing.assert_allclose(np.asarray(out.detach().float()),
                               np.asarray(ref, np.float32), **tol)


def _close_scaled(out, ref) -> None:
    """A primitive's grads: rtol 1e-4, atol 1e-5 x max(1, max |ref|) (an
    entry that sums terms of the gradient's size to near 0 keeps their
    rounding)."""
    ref = np.asarray(ref, np.float32)
    _close(out, ref, dict(rtol=1e-4,
                          atol=1e-5 * max(1.0, float(np.abs(ref).max()))))


# ---------------------------------------------------------------------------
# FlashAttention
# ---------------------------------------------------------------------------

FLASH_CASES = [  # B, H, KV, Sq, Sk, hd, causal, window
    (2, 4, 2, 33, 33, 64, True, 0),
    (1, 6, 3, 40, 40, 64, True, 8),
    (2, 2, 1, 24, 40, 64, False, 0),
    (1, 4, 4, 17, 17, 128, True, 5),
]


def _flash_inputs(B, H, KV, Sq, Sk, hd, lead=()):
    """Model-layout (…, B, S, heads, hd) q, k, v and an output weight."""
    return (_normal(lead + (B, Sq, H, hd), 0), _normal(lead + (B, Sk, KV, hd), 1),
            _normal(lead + (B, Sk, KV, hd), 2), _normal((B, Sq, H, hd), 3))


def _flash_loss(attn, w):
    def loss(q, k, v):
        o = attn(q, k, v)
        return (o * w).sum() + 0.5 * (o * o).sum()
    return loss


@pytest.mark.parametrize("vmapped", [False, True], ids=["one", "vmap3"])
@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=[f"B{c[0]}H{c[1]}KV{c[2]}S{c[3]}x{c[4]}hd{c[5]}"
                              f"c{int(c[6])}w{c[7]}" for c in FLASH_CASES])
def test_flash_grads_match_reference(case, vmapped):
    """d/d(q, k, v) of a loss through ``ops.gqa_flash`` (the Function)
    against ``jax.grad`` through the reference's ``gqa_attention``."""
    B, H, KV, Sq, Sk, hd, causal, window = case
    lead = (3,) if vmapped else ()
    q, k, v, w = _flash_inputs(B, H, KV, Sq, Sk, hd, lead)
    ref_loss = _flash_loss(lambda q, k, v: rattn.gqa_attention(
        q, k, v, causal=causal, window=window), jnp.asarray(w))
    port_loss = _flash_loss(lambda q, k, v: gqa_flash(
        q, k, v, causal=causal, window=window), torch.from_numpy(w))
    ref_g = jax.grad(ref_loss, argnums=(0, 1, 2))
    port_g = torch.func.grad(port_loss, argnums=(0, 1, 2))
    if vmapped:
        ref_g, port_g = jax.vmap(ref_g), torch.func.vmap(port_g)
    ref = ref_g(*map(jnp.asarray, (q, k, v)))
    out = port_g(*map(torch.from_numpy, (q, k, v)))
    for a, b in zip(out, ref):
        _close_scaled(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_function_matches_autograd_of_plain(dtype):
    """The Function's backward (P recomputed, the saved O in rowsum(dO*O))
    against autograd through the plain forward, under vmap over 4 clients;
    bf16 as on the card's tensor-core path (grads in bf16, 2e-2)."""
    tdt = getattr(torch, dtype)
    tol = PLAIN_TOL if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    B, H, KV, S, hd = 2, 4, 2, 48, 64
    q, k, v, w = (torch.from_numpy(a).to(tdt) for a in _flash_inputs(
        B, H, KV, S, S, hd, (4,)))
    w = w.transpose(1, 2)

    def loss(attn):
        return lambda q, k, v: (attn(q, k, v).float() * w.float()).sum()

    fn = lambda q, k, v: FlashAttention.apply(q, k, v, True, 16)  # noqa: E731
    plain = lambda q, k, v: flash_attention_plain(  # noqa: E731
        q, k, v, causal=True, window=16)
    args = [t.transpose(2, 3) for t in (q, k, v)]        # (4, B, heads, S, hd)
    g1 = torch.func.vmap(torch.func.grad(loss(fn), argnums=(0, 1, 2)))(*args)
    g2 = torch.func.vmap(torch.func.grad(loss(plain), argnums=(0, 1, 2)))(*args)
    for a, b in zip(g1, g2):
        assert a.dtype == tdt
        _close(a, b.float().numpy(), tol)


def test_flash_vmap_rule_is_one_call(monkeypatch):
    """Under vmap over 4 clients the forward runs once, on the clients
    folded into B; under plain autograd it also runs once."""
    calls = []
    real = pflash.flash_attention

    def counting(q, k, v, **kw):
        calls.append(tuple(q.shape))
        return real(q, k, v, **kw)

    monkeypatch.setattr(pflash, "flash_attention", counting)
    q, k, v, _ = _flash_inputs(2, 4, 2, 16, 16, 64, (4,))
    loss = lambda q, k, v: gqa_flash(q, k, v, causal=True).sum()  # noqa: E731
    torch.func.vmap(torch.func.grad(loss, argnums=(0, 1, 2)))(
        *map(torch.from_numpy, (q, k, v)))
    assert calls == [(8, 4, 16, 64)]
    calls.clear()
    qt = torch.from_numpy(q[0]).requires_grad_()
    gqa_flash(qt, torch.from_numpy(k[0]), torch.from_numpy(v[0])).sum() \
        .backward()
    assert calls == [(2, 4, 16, 64)] and qt.grad is not None


# ---------------------------------------------------------------------------
# SSDScan
# ---------------------------------------------------------------------------

def _ssd_inputs(B, S, H, P, N, lead=()):
    """x, dt, A, b, c and an output weight. dt is scaled so a chunk's decay
    stays within f32: where exp(cum_i - cum_j) above the diagonal overflows,
    the reference's masked exp has a NaN gradient (the port's is -inf
    masked before the exp, 0)."""
    x = _normal(lead + (B, S, H, P), 4)
    dt = 0.1 * np.log1p(np.exp(_normal(lead + (B, S, H), 5))).astype(
        np.float32)
    A = np.log1p(np.exp(_normal((H,), 6))).astype(np.float32)
    return (x, dt, A, _normal(lead + (B, S, N), 7, 0.5),
            _normal(lead + (B, S, N), 8, 0.5), _normal((B, S, H, P), 9))


@pytest.mark.parametrize("vmapped", [False, True], ids=["one", "vmap3"])
@pytest.mark.parametrize("S,chunk", [(32, 16), (64, 64), (48, 16)])
def test_ssd_grads_match_reference(S, chunk, vmapped):
    """d/d(x, dt, b, c) of a loss through ``ops.ssd_chunked_kernel`` (the
    Function) against ``jax.grad`` through the reference's ``ssd_chunked``."""
    lead = (3,) if vmapped else ()
    x, dt, A, b, c, w = _ssd_inputs(2, S, 3, 8, 4, lead)

    def loss_of(fn, w):
        def loss(x, dt, b, c):
            y = fn(x, dt, b, c)
            return (y * w).sum() + 0.5 * (y * y).sum()
        return loss

    ref_loss = loss_of(lambda x, dt, b, c: rssm.ssd_chunked(
        x, dt, jnp.asarray(A), b, c, chunk=chunk)[0], jnp.asarray(w))
    port_loss = loss_of(lambda x, dt, b, c: ssd_chunked_kernel(
        x, dt, torch.from_numpy(A), b, c, chunk=chunk), torch.from_numpy(w))
    ref_g = jax.grad(ref_loss, argnums=(0, 1, 2, 3))
    port_g = torch.func.grad(port_loss, argnums=(0, 1, 2, 3))
    if vmapped:
        ref_g, port_g = jax.vmap(ref_g), torch.func.vmap(port_g)
    ref = ref_g(*map(jnp.asarray, (x, dt, b, c)))
    out = port_g(*map(torch.from_numpy, (x, dt, b, c)))
    for a, r in zip(out, ref):
        _close_scaled(a, r)


def test_ssd_vmap_rule_is_one_call_and_tail_gets_no_gradient(monkeypatch):
    """Under vmap over 4 clients the scan runs once, its groups the clients
    x batches; the padded tail past S (the model pads S to a chunk
    multiple) gets exactly zero gradient: no output before it reads it."""
    calls = []
    real = pssd.ssd_scan

    def counting(xdt, la, b, c, **kw):
        calls.append((tuple(xdt.shape), tuple(b.shape)))
        return real(xdt, la, b, c, **kw)

    monkeypatch.setattr(pssd, "ssd_scan", counting)
    G, r, S, Spad, P, N = 2, 3, 20, 32, 8, 4
    xdt = torch.from_numpy(_normal((4, G, r, Spad, P), 0))
    la = -torch.from_numpy(np.abs(_normal((4, G, r, Spad), 1, 0.3)))
    b = torch.from_numpy(_normal((4, G, Spad, N), 2))
    c = torch.from_numpy(_normal((4, G, Spad, N), 3))

    def loss(xdt, la, b, c):
        y = SSDScan.apply(xdt, la, b, c, 16)
        return (y[..., :S, :] ** 2).sum()

    g = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1, 2, 3)))(
        xdt, la, b, c)
    assert calls == [((8, r, Spad, P), (8, Spad, N))]
    assert all(bool((t[..., S:, :] == 0).all()) for t in (g[0], g[2], g[3]))
    assert bool((g[1][..., S:] == 0).all())
    ref = torch.func.grad(lambda *a: (ssd_scan_plain(*a, chunk=16)
                                      [..., :S, :] ** 2).sum(),
                          argnums=(0, 1, 2, 3))(xdt[1], la[1], b[1], c[1])
    for a, r_ in zip(g, ref):
        _close(a[1], r_.numpy(), dict(rtol=0, atol=0))


# ---------------------------------------------------------------------------
# the model's loss
# ---------------------------------------------------------------------------

def _lm_inputs(rcfg, U, b, seq, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, rcfg.vocab, (U, b, seq + 1)).astype(np.int32)
    w = rng.uniform(0.1, 1.0, (U, b)).astype(np.float32)
    return x, np.zeros((U, b), np.int32), w / w.sum(1, keepdims=True)


@pytest.mark.parametrize("vmapped", [False, True], ids=["one", "vmap3"])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_grad_matches_reference(arch, vmapped):
    """The per-client gradient of ``make_lm_model(cfg).loss`` (reduced, f32,
    the reference's params, 24-token rows: the SSD pads to its 64-token
    chunk) against ``jax.grad`` of the reference's, one client and under
    vmap over U=3 (the backends' ``vmap(grad)``)."""
    rcfg, cfg = ref_get_config(arch).reduced(), get_config(arch).reduced()
    np_params = jax.tree.map(np.asarray, _np_params(rcfg))
    x, y, w = _lm_inputs(rcfg, 3, 2, 24)
    ref_loss, loss = ref_make_lm_model(rcfg).loss, make_lm_model(cfg).loss
    params = params_from_jax(np_params, "cpu")
    if vmapped:
        ref = jax.vmap(jax.grad(ref_loss), in_axes=(None, 0, 0, 0))(
            np_params, x, y, w)
        out = torch.func.vmap(torch.func.grad(loss), in_dims=(None, 0, 0, 0))(
            params, *map(torch.from_numpy, (x, y, w)))
    else:
        ref = jax.grad(ref_loss)(np_params, x[0], y[0], w[0])
        out = torch.func.grad(loss)(params, *(torch.from_numpy(a[0])
                                              for a in (x, y, w)))
    ref_leaves = jax.tree.leaves(ref)
    assert len(tree_leaves(out)) == len(ref_leaves)
    for a, b in zip(tree_leaves(out), ref_leaves):
        assert tuple(a.shape) == b.shape
        _close(a, b, REF_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_under_autograd_equals_no_remat(arch):
    """``forward(remat=True)`` (each block recomputed in the backward,
    ``models/transformer.py:_Remat``) gives the same loss and grads as
    ``remat=False`` under autograd."""
    cfg = get_config(arch).reduced()
    params = params_from_jax(jax.tree.map(np.asarray, rtr.init_params(
        jax.random.PRNGKey(0), ref_get_config(arch).reduced())), "cpu")
    x, _, _ = _lm_inputs(cfg, 1, 2, 16)
    tok, lab = torch.from_numpy(x[0, :, :-1]), torch.from_numpy(x[0, :, 1:])
    grads = []
    for remat in (False, True):
        leaves = [t.clone().requires_grad_() for t in tree_leaves(params)]
        from repro_torch.tree import tree_unflatten
        loss = ptr.loss_fn(tree_unflatten(params, leaves), cfg, tok, lab,
                           remat=remat)
        grads.append([loss] + list(torch.autograd.grad(loss, leaves)))
    for a, b in zip(*grads):
        _close(a, b.detach().numpy(), dict(rtol=1e-6, atol=1e-7))


def test_remat_under_torch_func_names_its_roadmap_item():
    """``remat=True`` under ``torch.func``, once refused naming ROADMAP
    1.13.5, now composes: ``torch.func.grad`` of the loss and the spatial
    train step equal ``remat=False`` bit for bit; under inference the
    forward runs as is."""
    cfg = get_config("qwen1.5-4b").reduced()
    params = ptr.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    tok = torch.randint(0, cfg.vocab, (2, 8),
                        generator=torch.Generator().manual_seed(1))
    grads = [torch.func.grad(lambda p: ptr.loss_fn(p, cfg, tok, tok,
                                                   remat=remat))(params)
             for remat in (False, True)]
    for a, b in zip(*map(tree_leaves, grads)):
        assert torch.equal(a, b)
    U = 2
    args = (tok.expand(U, 2, 8), tok.expand(U, 2, 8), torch.ones((U, cfg.L)),
            torch.zeros((cfg.L,)), 0.1)
    steps = [make_train_step(cfg, U=U, mode="spatial", remat=remat)(
        params, *args) for remat in (False, True)]
    for a, b in zip(*map(tree_leaves, steps)):
        assert torch.equal(a, b)
    with torch.inference_mode():      # nothing to recompute: runs as is
        logits = ptr.forward(params, cfg, tok, remat=True)
    assert logits.shape == (2, 8, cfg.padded_vocab)


def test_inference_prefill_unchanged_through_the_functions():
    """Under ``torch.inference_mode`` the Functions only run their forward:
    prefill logits equal the plain model path (the decode path) on a
    hybrid arch past its window."""
    cfg = dataclasses.replace(get_config("hymba-1.5b").reduced(), window=8)
    params = ptr.init_params(torch.Generator().manual_seed(1), cfg,
                             device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 12),
                           generator=torch.Generator().manual_seed(2))
    with torch.inference_mode():
        pre = ptr.prefill(params, cfg, tokens)
        cache = ptr.init_cache(cfg, 2, 12, device="cpu")
        for pos in range(12):
            dec, cache = ptr.decode_step(params, cfg, cache, tokens[:, pos],
                                         pos)
    _close(pre, dec.numpy(), dict(rtol=1e-4, atol=1e-4))
