"""``remat=True`` (``models/transformer.py:_Remat``: each block's forward
under no grad, the backward re-running it under ``torch.func.vjp``) against
``remat=False`` on the CPU, for every family at its ``reduced()`` size: the
same loss and gradients BIT FOR BIT, under autograd and under
``torch.func.vmap(torch.func.grad)`` over a client axis (the FL backends'
form), the nested flash and SSD Functions inside the recompute; and
``make_train_step`` with and without remat in both client layouts. The
recompute runs the same ops in the same order, so nothing is allowed to
differ.
"""
import importlib

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch.steps import make_train_step
from repro_torch.models import transformer as ptr
from repro_torch.tree import tree_leaves, tree_unflatten

pflash = importlib.import_module("repro_torch.kernels.flash_attention")


# dense, hybrid (flash and SSD Functions nested), moe (GQA and MLA; the aux
# output), ssm, vlm and audio (encoder, cross-attention)
ARCHS = ["qwen1.5-4b", "hymba-1.5b", "arctic-480b", "deepseek-v2-lite-16b",
         "mamba2-370m", "llava-next-34b", "seamless-m4t-medium"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small CPU tensors: the suite runs
    several test processes at once, and their thread pools contend for
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(cfg, lead=(), B=2, S=12, seed=0):
    rng = np.random.default_rng(seed)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, (*lead, B, S)))
    lab = torch.from_numpy(rng.integers(0, cfg.vocab, (*lead, B, S)))
    fr = None
    if cfg.frontend != "none":
        fr = torch.from_numpy((0.02 * rng.standard_normal(
            (*lead, B, cfg.n_frontend_tokens, cfg.d_model))).astype(
                np.float32))
    return tok, lab, fr


def _params(cfg, seed=0):
    return ptr.init_params(torch.Generator().manual_seed(seed), cfg,
                           device="cpu")


def _equal(a_list, b_list) -> None:
    assert len(a_list) == len(b_list)
    for a, b in zip(a_list, b_list):
        assert torch.equal(a, b), float((a - b).abs().max())


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_bit_identical_under_autograd(arch):
    cfg = get_config(arch).reduced()
    params = _params(cfg)
    tok, lab, fr = _inputs(cfg)
    out = []
    for remat in (False, True):
        leaves = [t.clone().requires_grad_() for t in tree_leaves(params)]
        loss = ptr.loss_fn(tree_unflatten(params, leaves), cfg, tok, lab,
                           frontend=fr, remat=remat)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        out.append([loss.detach()] + [
            torch.zeros_like(w) if g is None else g
            for w, g in zip(leaves, grads)])
    _equal(*out)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_bit_identical_under_vmap_grad(arch):
    """Three clients' gradients in one ``vmap(grad)`` call; and the value of
    ``grad_and_value`` of one client."""
    cfg = get_config(arch).reduced()
    params = _params(cfg)
    tok, lab, fr = _inputs(cfg, lead=(3,))
    out = []
    for remat in (False, True):
        def loss(p, t, l, f):
            return ptr.loss_fn(p, cfg, t, l, frontend=f, remat=remat)

        g = torch.func.vmap(torch.func.grad(loss),
                            in_dims=(None, 0, 0, None if fr is None else 0))(
            params, tok, lab, fr)
        g1, v1 = torch.func.grad_and_value(loss)(
            params, tok[0], lab[0], None if fr is None else fr[0])
        out.append(tree_leaves(g) + tree_leaves(g1) + [v1])
    _equal(*out)


def test_remat_recomputes_each_block_once(monkeypatch):
    """Under ``vmap(grad)`` over 3 clients the flash forward runs once a
    block in the forward and once more in the backward's recompute, each
    call on the clients folded into B (the nested Function's ``vmap`` rule
    holds inside the recompute); without remat, once a block."""
    cfg = get_config("seamless-m4t-medium").reduced()
    params = _params(cfg)
    tok, lab, fr = _inputs(cfg, lead=(3,))
    calls = []
    real = pflash.flash_attention

    def counting(q, k, v, **kw):
        calls.append(tuple(q.shape[:3]))
        return real(q, k, v, **kw)

    monkeypatch.setattr(pflash, "flash_attention", counting)
    per_forward = cfg.enc_layers + 2 * cfg.L     # encoder, self, cross
    for remat, n in ((False, per_forward), (True, 2 * per_forward)):
        calls.clear()
        torch.func.vmap(torch.func.grad(
            lambda p, t, l, f: ptr.loss_fn(p, cfg, t, l, frontend=f,
                                           remat=remat)),
            in_dims=(None, 0, 0, 0))(params, tok, lab, fr)
        assert len(calls) == n
        assert {c[0] for c in calls} == {3 * 2}      # U * B folded


def _step_inputs(cfg, U=3, b=2, S=8):
    tok, lab, fr = _inputs(cfg, lead=(U,), B=b, S=S, seed=4)
    mask = torch.ones((U, cfg.n_blocks_total))
    mask[0, 0] = 0.0
    mask[2, 1:] = 0.0
    p = torch.full((cfg.n_blocks_total,), 0.05)
    return (tok, lab, mask, p, 0.1) + (() if fr is None else (fr,))


@pytest.mark.parametrize("mode", ["spatial", "temporal"])
@pytest.mark.parametrize("arch", ["hymba-1.5b", "seamless-m4t-medium"])
def test_train_step_remat_equals_no_remat(arch, mode):
    """One ``make_train_step`` round with ``remat=True`` (the default) and
    with ``remat=False``: the same params bit for bit."""
    cfg = get_config(arch).reduced()
    params = _params(cfg)
    args = _step_inputs(cfg)
    out = [tree_leaves(make_train_step(cfg, U=3, mode=mode, remat=remat)(
        params, *args)) for remat in (False, True)]
    _equal(*out)


def test_inference_runs_no_recompute():
    """Under ``torch.inference_mode`` (and ``no_grad``) nothing is
    recomputed: ``remat`` is ignored and the logits are the same."""
    cfg = get_config("seamless-m4t-medium").reduced()
    params = _params(cfg)
    tok, _, fr = _inputs(cfg)
    with torch.inference_mode():
        a = ptr.forward(params, cfg, tok, frontend=fr, remat=True)
    with torch.no_grad():
        b = ptr.forward(params, cfg, tok, frontend=fr)
    assert torch.equal(a, b)


def test_first_order_graph_equals_no_remat():
    """``create_graph=True`` with no second backward (what
    ``torch.func.grad`` asks of autograd) still gives ``remat=False``'s
    gradients bit for bit."""
    cfg = get_config("qwen1.5-4b").reduced()
    params = _params(cfg)
    tok, lab, _ = _inputs(cfg)
    out = []
    for remat in (False, True):
        leaves = [t.clone().requires_grad_() for t in tree_leaves(params)]
        loss = ptr.loss_fn(tree_unflatten(params, leaves), cfg, tok, lab,
                           remat=remat)
        out.append([g.detach() for g in torch.autograd.grad(
            loss, leaves, create_graph=True)])
    _equal(*out)



def _second_order_autograd(cfg, params, tok, lab, remat):
    leaves = [t.clone().requires_grad_() for t in tree_leaves(params)]
    loss = ptr.loss_fn(tree_unflatten(params, leaves), cfg, tok, lab,
                       remat=remat)
    grads = torch.autograd.grad(loss, leaves, create_graph=True)
    return list(torch.autograd.grad(sum((g * g).sum() for g in grads),
                                    leaves))


def _grad_norm(cfg, tok, lab, remat):
    def gnorm(p):
        g = torch.func.grad(lambda q: ptr.loss_fn(q, cfg, tok, lab,
                                                  remat=remat))(p)
        return sum((t * t).sum() for t in tree_leaves(g))
    return gnorm


def _second_order_func(cfg, params, tok, lab, remat):
    return tree_leaves(torch.func.grad(_grad_norm(cfg, tok, lab, remat))(
        params))


def _second_order_autograd_over_func(cfg, params, tok, lab, remat):
    leaves = [t.clone().requires_grad_() for t in tree_leaves(params)]
    norm = _grad_norm(cfg, tok, lab, remat)(tree_unflatten(params, leaves))
    return list(torch.autograd.grad(norm, leaves))


@pytest.mark.parametrize("second_order", [
    _second_order_autograd, _second_order_func,
    _second_order_autograd_over_func],
    ids=["autograd", "func_grad_of_grad", "autograd_over_func_grad"])
def test_second_derivative_through_remat_equals_no_remat(second_order):
    """A second derivative (of the gradient's squared norm) through
    ``remat``: the recompute is recorded when one is asked for, so it
    equals ``remat=False``'s up to f32 rounding (the recorded recompute's
    double backward sums in another order), rtol 1e-4 and atol 1e-5 x
    max(1, max|d2|); a block's terms missing would be O(1)."""
    cfg = get_config("qwen1.5-4b").reduced()
    params = _params(cfg)
    tok, lab, _ = _inputs(cfg, S=6)
    want, got = (second_order(cfg, params, tok, lab, remat=r)
                 for r in (False, True))
    assert len(want) == len(got)
    scale = max(1.0, max(float(a.abs().max()) for a in want))
    for a, b in zip(want, got):
        torch.testing.assert_close(b, a, rtol=1e-4, atol=1e-5 * scale)


def _autograd_inside_func_grad(cfg, params, tok, lab, remat):
    """``torch.func.grad`` of the gradient's squared norm, the gradient
    taken inside it by ``torch.autograd.grad(create_graph=True)``."""
    def norm(p):
        leaves = tree_leaves(p)
        loss = ptr.loss_fn(tree_unflatten(p, leaves), cfg, tok, lab,
                           remat=remat)
        grads = torch.autograd.grad(loss, leaves, create_graph=True)
        return sum((g * g).sum() for g in grads)
    return tree_leaves(torch.func.grad(norm)(params))


@pytest.mark.parametrize("arch", ["hymba-1.5b", "qwen1.5-4b"])
def test_autograd_second_derivative_inside_func_grad_equals_no_remat(arch):
    """``torch.autograd.grad(create_graph=True)`` inside one
    ``torch.func.grad`` (ROADMAP 3.6): its backward runs with grad mode on,
    so the recompute is recorded and the second derivative through remat
    equals ``remat=False``'s at rtol 1e-4 (atol 1e-5 x max(1, max|d2|)),
    through the flash and SSD Functions (hymba) and a dense GQA block
    (qwen). Before the repair this backward could not be told from
    ``torch.func.grad``'s own and missed the blocks' terms."""
    cfg = get_config(arch).reduced()
    params = _params(cfg)
    tok, lab, _ = _inputs(cfg, S=6)
    want, got = (_autograd_inside_func_grad(cfg, params, tok, lab, remat=r)
                 for r in (False, True))
    assert len(want) == len(got)
    scale = max(1.0, max(float(a.abs().max()) for a in want))
    for a, b in zip(want, got):
        torch.testing.assert_close(b, a, rtol=1e-4, atol=1e-5 * scale)
