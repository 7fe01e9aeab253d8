"""The port's vlm and audio (encoder-decoder) families against the reference
on the same numpy inputs and params: llava-next-34b (patch embeddings
prepended to the text) and seamless-m4t-medium (a bidirectional encoder
over frame embeddings, cross-attention in every decoder block), each at its
``reduced()`` size (2 + 2 blocks, d_model 256, 16 frontend tokens, f32).

Params are the reference's init with its vector leaves moved off their
constant value (``test_torch_lm._np_params``), carried across with
``params_from_jax``; on these CPU tensors the flash wrapper computes its
plain version. Tolerances as ``tests/test_torch_lm.py`` and
``tests/test_torch_lm_grad.py``: logits and losses rtol = atol = 1e-4,
gradients rtol 1e-4 / atol 1e-5, decode 1e-4, a step's params rtol 1e-4 /
atol 1e-6; layer ids and param counts exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.fl.tasks import make_lm_model as ref_make_lm_model
from repro.launch.steps import make_client_grad as ref_make_client_grad
from repro.launch.steps import make_prefill_step as ref_make_prefill_step
from repro.launch.steps import make_train_step as ref_make_train_step
from repro.models import transformer as rtr
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.fl.tasks import make_lm_model
from repro_torch.launch.serve import serve
from repro_torch.launch.steps import (make_client_grad, make_prefill_step,
                                      make_train_step)
from repro_torch.models import transformer as ptr
from repro_torch.tree import tree_leaves
from test_torch_lm import _np_params

LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
ARCHS = ["llava-next-34b", "seamless-m4t-medium"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small CPU tensors: the suite runs
    several test processes at once, and their thread pools contend for
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(out, ref, tol) -> None:
    np.testing.assert_allclose(np.asarray(out.detach().float()),
                               np.asarray(ref, np.float32), **tol)


def _close_tree(out, ref, tol) -> None:
    ref_leaves = jax.tree.leaves(ref)
    assert len(tree_leaves(out)) == len(ref_leaves)
    for a, b in zip(tree_leaves(out), ref_leaves):
        assert tuple(a.shape) == b.shape
        _close(a, b, tol)


def _setup(arch, seed=0):
    rcfg, cfg = ref_get_config(arch).reduced(), get_config(arch).reduced()
    np_params = jax.tree.map(np.asarray, _np_params(rcfg, seed))
    return rcfg, cfg, np_params, params_from_jax(np_params, "cpu")


def _frontend(cfg, lead, seed=5):
    """Patch or frame embeddings (*lead, n_frontend_tokens, d_model)."""
    return (0.02 * np.random.default_rng(seed).standard_normal(
        (*lead, cfg.n_frontend_tokens, cfg.d_model))).astype(np.float32)


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape).astype(
        np.int32)


@pytest.mark.parametrize("with_frontend", [True, False],
                         ids=["frontend", "text"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, with_frontend):
    """Logits with the frontend (vision: n_front + S positions; audio: the
    encoder, then cross-attention) and without (text only), and the
    prefill step's last position."""
    rcfg, cfg, np_params, params = _setup(arch)
    tok = _tokens(cfg, (2, 12), 1)
    fr = _frontend(cfg, (2,)) if with_frontend else None
    ref, _ = rtr.forward(np_params, rcfg, tok, frontend=fr)
    out = ptr.forward(params, cfg, torch.from_numpy(tok),
                      frontend=None if fr is None else torch.from_numpy(fr))
    S_out = 12 + (cfg.n_frontend_tokens
                  if with_frontend and cfg.frontend == "vision" else 0)
    assert tuple(out.shape) == (2, S_out, cfg.padded_vocab)
    _close(out, ref, LOGIT_TOL)
    pre = make_prefill_step(cfg)(params, torch.from_numpy(tok),
                                 None if fr is None else torch.from_numpy(fr))
    _close(pre, ref_make_prefill_step(rcfg)(np_params, tok, fr), LOGIT_TOL)
    _close(pre, ref[:, -1], LOGIT_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    """``loss_fn`` with the frontend (a vision frontend's positions dropped
    before the NLL) and its gradient against ``jax.grad``, every leaf the
    encoder's and cross-attention's included; the frontend's own gradient
    too."""
    rcfg, cfg, np_params, params = _setup(arch)
    tok, lab = _tokens(cfg, (2, 10), 1), _tokens(cfg, (2, 10), 2)
    fr = _frontend(cfg, (2,))

    def ref_loss(p, f):
        return rtr.loss_fn(p, rcfg, tok, lab, frontend=f)

    ref_val, (ref_g, ref_gf) = jax.value_and_grad(ref_loss, (0, 1))(
        np_params, fr)

    def loss(p, f):
        return ptr.loss_fn(p, cfg, torch.from_numpy(tok),
                           torch.from_numpy(lab), frontend=f)

    val = loss(params, torch.from_numpy(fr))
    g, gf = torch.func.grad(loss, argnums=(0, 1))(params, torch.from_numpy(fr))
    _close(val, ref_val, LOGIT_TOL)
    _close_tree(g, ref_g, GRAD_TOL)
    _close(gf, ref_gf, GRAD_TOL)
    if cfg.enc_layers:        # the encoder and cross-attention do learn
        assert float(g["enc_blocks"]["attn"]["wq"].abs().max()) > 0
        assert float(g["blocks"]["xattn"]["wk"].abs().max()) > 0


def test_vision_loss_drops_the_frontend_positions():
    """The vlm loss is the mean NLL over the text positions alone: the
    logits past the n_front patch positions against the labels."""
    _, cfg, _, params = _setup("llava-next-34b")
    tok, lab = _tokens(cfg, (2, 10), 1), _tokens(cfg, (2, 10), 2)
    fr = torch.from_numpy(_frontend(cfg, (2,)))
    logits = ptr.forward(params, cfg, torch.from_numpy(tok), frontend=fr)
    want = ptr.token_nll(logits[:, cfg.n_frontend_tokens:],
                         torch.from_numpy(lab)).mean()
    got = ptr.loss_fn(params, cfg, torch.from_numpy(tok),
                      torch.from_numpy(lab), frontend=fr)
    assert torch.equal(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_layer_ids_match_reference(arch):
    """Decoder blocks enc_layers + arange(L), encoder blocks
    arange(enc_layers), the embedding 0 and every other leaf (``enc_norm``
    included) the last layer, leaf for leaf."""
    rcfg, cfg, np_params, params = _setup(arch)
    ref = jax.tree.leaves(rtr.layer_ids(np_params, rcfg))
    out = tree_leaves(ptr.layer_ids(params, cfg))
    assert len(out) == len(ref) == len(tree_leaves(params))
    for a, b in zip(out, ref):
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        np.testing.assert_array_equal(a, np.asarray(b))
    if cfg.enc_layers:
        ids = ptr.layer_ids(params, cfg)
        assert ids["enc_norm"] == cfg.n_blocks_total - 1
        assert ids["blocks"]["xattn"]["wq"].tolist() == [2, 3]
        assert ids["enc_blocks"]["mlp"]["wd"].tolist() == [0, 1]


def test_cross_cache_and_decode_match_reference():
    """``build_cross_cache`` of the encoder output, then two
    ``decode_step`` s with the cross cache (f32 KV cache, as ``serve``)."""
    rcfg, cfg, np_params, params = _setup("seamless-m4t-medium")
    B = 2
    fr = _frontend(cfg, (B,))
    tok = _tokens(cfg, (B, 2), 3)
    enc = rtr._run_encoder(np_params, rcfg, fr, jnp.float32)
    ref_cross = rtr.build_cross_cache(np_params, rcfg, enc)
    with torch.inference_mode():
        p_enc = ptr._run_encoder(params, cfg, torch.from_numpy(fr),
                                 torch.float32)
        cross = ptr.build_cross_cache(params, cfg, p_enc)
    _close(p_enc, enc, LOGIT_TOL)
    for a, b in zip(cross, ref_cross):
        assert tuple(a.shape) == b.shape == (cfg.L, B, cfg.n_frontend_tokens,
                                             cfg.n_kv, cfg.head_dim)
        _close(a, b, LOGIT_TOL)
    ref_cache = rtr.init_cache(rcfg, B, 8, dtype=jnp.float32)._replace(
        cross=ref_cross)
    cache = ptr.init_cache(cfg, B, 8, dtype=torch.float32,
                           device="cpu")._replace(cross=cross)
    for pos in range(2):
        ref_logits, ref_cache = rtr.decode_step(np_params, rcfg, ref_cache,
                                                tok[:, pos], jnp.int32(pos))
        with torch.inference_mode():
            logits, cache = ptr.decode_step(params, cfg, cache,
                                            torch.from_numpy(tok[:, pos]),
                                            pos)
        _close(logits, ref_logits, LOGIT_TOL)


def test_decode_with_cross_cache_matches_prefill():
    """Stepping the decode path with the cross cache through a prompt gives
    the prefill's last-position logits (the encoder read once)."""
    _, cfg, _, params = _setup("seamless-m4t-medium")
    B, S = 2, 6
    fr = torch.from_numpy(_frontend(cfg, (B,)))
    tok = torch.from_numpy(_tokens(cfg, (B, S), 4))
    with torch.inference_mode():
        pre = ptr.prefill(params, cfg, tok, frontend=fr)
        enc = ptr._run_encoder(params, cfg, fr, torch.float32)
        cache = ptr.init_cache(cfg, B, S, device="cpu")._replace(
            cross=ptr.build_cross_cache(params, cfg, enc))
        for pos in range(S):
            dec, cache = ptr.decode_step(params, cfg, cache, tok[:, pos], pos)
    _close(pre, dec.numpy(), LOGIT_TOL)


def _step_inputs(cfg, U=3, b=2, S=8):
    rng = np.random.default_rng(3)
    tok = rng.integers(0, cfg.vocab, (U, b, S)).astype(np.int32)
    lab = rng.integers(0, cfg.vocab, (U, b, S)).astype(np.int32)
    mask = np.ones((U, cfg.n_blocks_total), np.float32)
    mask[0, 0] = 0.0
    mask[2, 1:] = 0.0
    p = np.full((cfg.n_blocks_total,), 0.05, np.float32)
    return tok, lab, mask, p, _frontend(cfg, (U, b))


@pytest.mark.parametrize("mode", ["temporal", "spatial"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_with_frontend_matches_reference(arch, mode):
    """One ``make_train_step`` round with the trailing frontend (U, b,
    n_front, D), ``remat=True`` (the default: recomputed blocks, under
    autograd in temporal and ``vmap(grad)`` in spatial) against the
    reference's step."""
    rcfg, cfg, np_params, params = _setup(arch)
    tok, lab, mask, p, fr = _step_inputs(cfg)
    ref = jax.jit(ref_make_train_step(rcfg, U=3, mode=mode, remat=False))(
        np_params, tok, lab, mask, p, jnp.float32(0.1), fr)
    out = make_train_step(cfg, U=3, mode=mode)(
        params, *map(torch.from_numpy, (tok, lab, mask, p)), 0.1,
        torch.from_numpy(fr))
    _close_tree(out, ref, PARAM_TOL)


def test_client_grad_with_frontend_matches_reference():
    rcfg, cfg, np_params, params = _setup("seamless-m4t-medium")
    tok, lab, _, _, fr = _step_inputs(cfg)
    c_row = np.asarray([0.25, 0.0, 0.5, 1.0], np.float32)
    ref = ref_make_client_grad(rcfg, remat=False)(np_params, tok[0], lab[0],
                                                  c_row, fr[0])
    out = make_client_grad(cfg)(params, *map(torch.from_numpy, (
        tok[0], lab[0], c_row, fr[0])))
    _close_tree(out, ref, GRAD_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_make_lm_model_is_text_only(arch):
    """``make_lm_model`` on a vlm or audio config trains on the text alone,
    as the reference's: loss and per-client grads (vmapped over 2 clients)
    equal the reference's, the encoder's and cross-attention's grads zero,
    and L counts the encoder's blocks."""
    rcfg, cfg, np_params, params = _setup(arch)
    model, ref_model = make_lm_model(cfg), ref_make_lm_model(rcfg)
    assert model.L == ref_model.L == cfg.n_blocks_total
    rng = np.random.default_rng(7)
    x = rng.integers(0, cfg.vocab, (2, 2, 9)).astype(np.int32)
    y = np.zeros((2, 2), np.int32)
    w = np.full((2, 2), 0.5, np.float32)
    ref = jax.vmap(jax.grad(ref_model.loss), in_axes=(None, 0, 0, 0))(
        np_params, x, y, w)
    out = torch.func.vmap(torch.func.grad(model.loss),
                          in_dims=(None, 0, 0, 0))(
        params, *map(torch.from_numpy, (x, y, w)))
    _close_tree(out, ref, GRAD_TOL)
    _close(model.loss(params, *map(torch.from_numpy, (x[0], y[0], w[0]))),
           ref_model.loss(np_params, x[0], y[0], w[0]), LOGIT_TOL)
    if cfg.enc_layers:
        for t in tree_leaves(out["enc_blocks"]) + tree_leaves(
                out["blocks"]["xattn"]):
            assert not bool(t.any())


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_param_count_matches_reference(arch):
    """At the published widths the port's params on ``meta`` (nothing
    drawn) count what the reference's ``jax.eval_shape`` of its init does,
    leaf for leaf in shape."""
    rcfg, cfg = ref_get_config(arch), get_config(arch)
    shapes = jax.eval_shape(lambda k: rtr.init_params(k, rcfg),
                            jax.random.PRNGKey(0))
    params = ptr.init_params(torch.Generator(), cfg, device="meta")
    assert ptr.count_params(params) == rtr.count_params(shapes)
    assert [tuple(t.shape) for t in tree_leaves(params)] == [
        s.shape for s in jax.tree.leaves(shapes)]
    # the config's count leaves out the final (and encoder) norm
    assert ptr.count_params(params) == cfg.param_count() + cfg.d_model * (
        1 + bool(cfg.enc_layers))


def test_params_cross_packages_with_encoder_leaves():
    """``params_from_jax`` / ``params_to_numpy`` carry ``enc_blocks``,
    ``enc_norm``, ``xattn`` and ``norm_x`` across unchanged."""
    _, _, np_params, params = _setup("seamless-m4t-medium")
    assert {"enc_blocks", "enc_norm"} <= set(params)
    assert {"xattn", "norm_x"} <= set(params["blocks"])
    back = params_to_numpy(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(np_params)):
        np.testing.assert_array_equal(a, b)


def test_serve_encoder_decoder_on_cpu():
    """``serve`` encodes random frames, fills the cross cache and decodes."""
    out = serve("seamless-m4t-medium", batch=2, prompt_len=4, new_tokens=3,
                device="cpu", verbose=False)
    gen = np.asarray(out["generated"])
    assert gen.shape == (2, 3)
    V = get_config("seamless-m4t-medium").reduced().padded_vocab
    assert ((gen >= 0) & (gen < V)).all()
