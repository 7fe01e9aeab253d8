"""The port's LM path (``repro_torch.configs``, ``models.attention``,
``models.ssm``, ``models.transformer``, ``launch``) against the reference on
the same numpy inputs and params.

Params are made by the reference's ``init_params``, given random norms,
biases and SSM scalars (so no path is the identity), and carried across with
``params_from_jax``. On these CPU tensors the port's kernel wrappers compute
their plain versions. Everything is f32 (``reduced()`` sets
``dtype="float32"``): tolerance rtol = atol = 1e-4 for logits (XLA-CPU and
ATen sum in different orders over 2 blocks and a 512-wide head), 1e-5 for
the attention and SSM primitives.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get_config as ref_get_config
from repro.models import attention as rattn
from repro.models import ssm as rssm
from repro.models import transformer as rtr
from repro_torch.configs import ARCHS, INPUT_SHAPES, get_config, get_shape
from repro_torch.convert import params_from_jax
from repro_torch.launch.serve import serve
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import attention as pattn
from repro_torch.models import ssm as pssm
from repro_torch.models import transformer as ptr
from repro_torch.tree import tree_leaves

LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
PRIM_TOL = dict(rtol=1e-5, atol=1e-5)
ARCHS_COVERED = ["hymba-1.5b", "yi-6b", "mamba2-370m", "qwen1.5-4b",
                 "chatglm3-6b"]


def _normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _cfgs(arch, **kw):
    return ref_get_config(arch).reduced(**kw), get_config(arch).reduced(**kw)


def _np_params(rcfg, seed=0):
    """The reference's init, with every vector leaf (norms, biases, SSM
    scalars, fusion gains) moved off its constant init value."""
    params = rtr.init_params(jax.random.PRNGKey(seed), rcfg)
    rng = np.random.default_rng(seed + 1)

    def jitter(path, a):
        a = np.asarray(a)
        name = getattr(path[-1], "key", "")
        if name in ("wq", "wk", "wv", "wo", "wg", "wu", "wd", "in_proj",
                    "out_proj", "conv_w", "embed", "lm_head"):
            return a
        return (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)

    return jax.tree_util.tree_map_with_path(jitter, params)


def _tokens(cfg, B, S, seed=2):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)).astype(
        np.int32)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_configs_match_the_reference():
    assert sorted(ARCHS) == sorted(REF_ARCHS)
    for name, cfg in ARCHS.items():
        ref = REF_ARCHS[name]
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref), name
        assert dataclasses.asdict(cfg.reduced()) == dataclasses.asdict(
            ref.reduced()), name
        for attr in ("head_dim", "padded_vocab", "d_inner", "ssm_heads",
                     "n_blocks_total", "has_attention", "has_ssm", "is_moe",
                     "sub_quadratic"):
            assert getattr(cfg, attr) == getattr(ref, attr), (name, attr)
        assert cfg.param_count() == ref.param_count(), name
        assert cfg.active_param_count() == ref.active_param_count(), name
    assert get_config("hymba-1.5b").window == 1024
    assert get_shape("prefill_32k") == INPUT_SHAPES["prefill_32k"]
    with pytest.raises(KeyError):
        get_config("no-such-arch")


@pytest.mark.parametrize("arch,item", [
    ("llava-next-34b", "1.13.4"), ("seamless-m4t-medium", "1.13.4")])
def test_uncovered_families_name_their_roadmap_item(arch, item):
    """The vlm and audio families, once refused naming ROADMAP ``item``,
    are ported: init and the prefill step with its trailing frontend run
    (their parity with the reference is ``tests/test_torch_encdec.py``)."""
    assert item == "1.13.4"
    cfg = get_config(arch).reduced()
    ptr.check_supported(cfg)
    params = ptr.init_params(torch.Generator(), cfg, device="cpu")
    tok = torch.zeros((2, 4), dtype=torch.int64)
    fr = torch.zeros((2, cfg.n_frontend_tokens, cfg.d_model))
    logits = make_prefill_step(cfg)(params, tok, fr)
    assert tuple(logits.shape) == (2, cfg.padded_vocab)
    assert bool(torch.isfinite(logits).all())


# ---------------------------------------------------------------------------
# attention and SSM primitives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["full", "half", "none"])
@pytest.mark.parametrize("per_batch_pos", [False, True])
def test_rope_matches_reference(mode, per_batch_pos):
    x = _normal((2, 9, 3, 64), 0)
    pos = (np.arange(9)[None] + np.array([[0], [700]])) if per_batch_pos \
        else np.arange(100, 109)
    ref = rattn.rope(jnp.asarray(x), jnp.asarray(pos), mode=mode, theta=5e5)
    out = pattn.rope(torch.from_numpy(x), torch.from_numpy(pos), mode=mode,
                     theta=5e5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **PRIM_TOL)


@pytest.mark.parametrize("causal,window,q_pos0,Sk", [
    (True, 0, 0, 24), (True, 8, 0, 24), (False, 0, 0, 40), (True, 5, 16, 24)])
def test_gqa_attention_matches_reference(causal, window, q_pos0, Sk):
    q, k, v = (_normal((2, 8, 6, 16), 0), _normal((2, Sk, 3, 16), 1),
               _normal((2, Sk, 3, 16), 2))
    ref = rattn.gqa_attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                              window=window, q_pos0=q_pos0)
    out = pattn.gqa_attention(*map(torch.from_numpy, (q, k, v)),
                              causal=causal, window=window, q_pos0=q_pos0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **PRIM_TOL)


@pytest.mark.parametrize("n_valid", [1, 7, 12])
def test_decode_attention_matches_reference(n_valid):
    q, kc, vc = (_normal((2, 1, 6, 16), 0), _normal((2, 12, 2, 16), 1),
                 _normal((2, 12, 2, 16), 2))
    ref = rattn.decode_attention(*map(jnp.asarray, (q, kc, vc)),
                                 jnp.int32(n_valid))
    out = pattn.decode_attention(*map(torch.from_numpy, (q, kc, vc)), n_valid)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **PRIM_TOL)


def _ssd_args(B=2, S=64, H=3, P=8, N=4):
    x = _normal((B, S, H, P), 0)
    dt = np.log1p(np.exp(_normal((B, S, H), 1))).astype(np.float32)
    A = np.log1p(np.exp(_normal((H,), 2))).astype(np.float32)
    b, c = 0.3 * _normal((B, S, N), 3), 0.3 * _normal((B, S, N), 4)
    h0 = 0.1 * _normal((B, H, N, P), 5)
    return x, dt, A, b, c, h0


def _pair_close(out, ref, tol=PRIM_TOL):
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **tol)


@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_reference_and_chunked_match_reference(with_h0):
    *args, h0 = _ssd_args()
    h0 = h0 if with_h0 else None
    jargs = [jnp.asarray(a) for a in args]
    targs = [torch.from_numpy(a) for a in args]
    jh0 = None if h0 is None else jnp.asarray(h0)
    th0 = None if h0 is None else torch.from_numpy(h0)
    ref = rssm.ssd_reference(*jargs, h0=jh0)
    _pair_close(pssm.ssd_reference(*targs, h0=th0), ref)
    for chunk in (16, 64):
        _pair_close(pssm.ssd_chunked(*targs, chunk=chunk, h0=th0),
                    rssm.ssd_chunked(*jargs, chunk=chunk, h0=jh0),
                    dict(rtol=1e-4, atol=1e-4))
        # the chunked form against the sequential oracle
        _pair_close(pssm.ssd_chunked(*targs, chunk=chunk, h0=th0), ref,
                    dict(rtol=1e-4, atol=1e-4))


def test_ssd_decode_step_matches_reference():
    x, dt, A, b, c, h0 = _ssd_args(S=1)
    args = (x[:, 0], dt[:, 0], A, b[:, 0], c[:, 0], h0)
    _pair_close(pssm.ssd_decode_step(*map(torch.from_numpy, args)),
                rssm.ssd_decode_step(*map(jnp.asarray, args)))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_params_cross_unchanged():
    """``params_from_jax`` carries the nested stacked dicts across as they
    are, and they have the structure, shapes and dtypes of the port's own
    init; count_params and the layer ids agree."""
    rcfg, pcfg = _cfgs("qwen1.5-4b")
    np_params = _np_params(rcfg)
    params = params_from_jax(np_params, "cpu")
    own = ptr.init_params(torch.Generator().manual_seed(0), pcfg,
                          device="cpu")
    flat_ref = jax.tree_util.tree_flatten_with_path(np_params)[0]
    flat = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, jax.tree.map(lambda t: t.numpy(), params)))[0]
    flat_own = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.numpy(), own))[0]
    assert [p for p, _ in flat] == [p for p, _ in flat_ref] == [
        p for p, _ in flat_own]
    for (_, a), (_, r), (_, o) in zip(flat, flat_ref, flat_own):
        assert a.shape == r.shape == o.shape and a.dtype == r.dtype == o.dtype
        np.testing.assert_array_equal(a, np.asarray(r))
    assert ptr.count_params(params) == rtr.count_params(np_params)
    ids, rids = ptr.layer_ids(params, pcfg), rtr.layer_ids(np_params, rcfg)
    assert [int(np.max(np.asarray(i))) for i in tree_leaves(ids)] == [
        int(np.max(i)) for i in jax.tree.leaves(rids)]


@pytest.mark.parametrize("arch", ARCHS_COVERED)
def test_forward_and_prefill_match_reference(arch):
    rcfg, pcfg = _cfgs(arch)
    np_params = _np_params(rcfg)
    tokens = _tokens(rcfg, 2, 80)      # not a multiple of the SSD chunk
    ref_logits, _ = rtr.forward(np_params, rcfg, jnp.asarray(tokens))
    params = params_from_jax(np_params, "cpu")
    logits = ptr.forward(params, pcfg, torch.from_numpy(tokens))
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                               **LOGIT_TOL)
    last = make_prefill_step(pcfg)(params, torch.from_numpy(tokens))
    np.testing.assert_allclose(last.numpy(), np.asarray(ref_logits)[:, -1],
                               **LOGIT_TOL)


def test_decode_steps_wrap_the_rolling_cache():
    """80 decode steps from ``init_cache`` on reduced hymba (window 64,
    max_seq 96, so the rolling KV cache wraps at step 64): every step's
    logits, and the final KV, SSM and conv caches, match the reference."""
    rcfg, pcfg = _cfgs("hymba-1.5b")
    assert pcfg.window == 64
    np_params = _np_params(rcfg)
    params = params_from_jax(np_params, "cpu")
    B, steps, max_seq = 2, 80, 96
    toks = _tokens(rcfg, B, steps)
    rstep = jax.jit(lambda p, c, t, pos: rtr.decode_step(p, rcfg, c, t, pos))
    rcache = rtr.init_cache(rcfg, B, max_seq)
    cache = ptr.init_cache(pcfg, B, max_seq, device="cpu")
    assert cache.kv[0].shape == rcache.kv[0].shape == (2, B, 64, 1, 64)
    for pos in range(steps):
        rlogits, rcache = rstep(np_params, rcache, jnp.asarray(toks[:, pos]),
                                jnp.int32(pos))
        logits, cache = ptr.decode_step(params, pcfg, cache,
                                        torch.from_numpy(toks[:, pos]), pos)
        np.testing.assert_allclose(logits.numpy(), np.asarray(rlogits),
                                   **LOGIT_TOL, err_msg=f"step {pos}")
    for ours, ref in ((cache.kv, rcache.kv), (cache.ssm, rcache.ssm)):
        _pair_close(ours, ref, LOGIT_TOL)


def _prefill_vs_decode(forward_last, step, B, S):
    """(prefill's last-position logits, the last decode step's logits)."""
    logits = None
    for pos in range(S):
        logits = step(pos)
    return forward_last(), logits


def test_prefill_agrees_with_decode_past_the_window():
    """Prefill (windowed attention, chunked SSD) and stepping the decode path
    (rolling cache, recurrent SSD) give the same last-position logits on
    reduced hymba with a prompt of 100 tokens, past the 64-token window:
    first in the reference, then in the port."""
    rcfg, pcfg = _cfgs("hymba-1.5b")
    np_params = _np_params(rcfg, seed=3)
    params = params_from_jax(np_params, "cpu")
    B, S = 2, 100
    toks = _tokens(rcfg, B, S, seed=4)

    rcache = [rtr.init_cache(rcfg, B, S)]
    rstep = jax.jit(lambda p, c, t, pos: rtr.decode_step(p, rcfg, c, t, pos))

    def ref_step(pos):
        logits, rcache[0] = rstep(np_params, rcache[0],
                                  jnp.asarray(toks[:, pos]), jnp.int32(pos))
        return np.asarray(logits)

    ref_pre, ref_dec = _prefill_vs_decode(
        lambda: np.asarray(rtr.prefill(np_params, rcfg, jnp.asarray(toks))),
        ref_step, B, S)
    np.testing.assert_allclose(ref_pre, ref_dec, **LOGIT_TOL)

    cache = ptr.init_cache(pcfg, B, S, device="cpu")
    serve_step = make_serve_step(pcfg)
    tt = torch.from_numpy(toks)

    def port_step(pos):
        return ptr.decode_step(params, pcfg, cache, tt[:, pos], pos)[0].numpy()

    pre, dec = _prefill_vs_decode(
        lambda: make_prefill_step(pcfg)(params, tt).numpy(), port_step, B, S)
    np.testing.assert_allclose(pre, dec, **LOGIT_TOL)
    np.testing.assert_allclose(pre, ref_pre, **LOGIT_TOL)
    # the serve step's greedy token is the argmax of those logits
    cache = ptr.init_cache(pcfg, B, S, device="cpu")
    tok = None
    for pos in range(S):
        tok, cache = serve_step(params, cache, tt[:, pos], pos)
    assert tok.dtype == torch.int32
    np.testing.assert_array_equal(tok.numpy(), dec.argmax(-1))


def test_serve_runs_on_cpu_when_asked():
    out = serve("hymba-1.5b", batch=2, prompt_len=6, new_tokens=5,
                device="cpu", verbose=False)
    gen = np.asarray(out["generated"])
    assert gen.shape == (2, 5) and out["arch"] == "hymba-1.5b"
    assert ((gen >= 0) & (gen < get_config("hymba-1.5b").reduced(
    ).padded_vocab)).all()
    assert np.isfinite(out["tok_per_s"]) and out["tok_per_s"] > 0
    again = serve("hymba-1.5b", batch=2, prompt_len=6, new_tokens=5,
                  device="cpu", verbose=False)
    assert again["generated"] == out["generated"]      # seeded
