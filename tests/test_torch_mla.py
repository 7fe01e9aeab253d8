"""The port's MLA (DeepSeek-V2 multi-head latent attention:
``repro_torch.models.attention.mla_prefill`` / ``mla_decode``, the latent
cache and the MLA arm of ``decode_step``) and the deepseek-v2-lite-16b LM
against the reference's, on the same numpy inputs, at reduced size in f32.

Tolerances: ``mla_prefill``'s output and latents, ``mla_decode``'s output
rtol 1e-4 / atol 1e-5; decode over 8 positions against the reference's
``decode_step`` 1e-4 (rtol and atol), the caches it writes the same; the
decode path against a dropless prefill (``capacity_factor = n_experts``:
the reference's prefill drops at capacity 1.25 and its decode is dropless,
so the two differ by design at 1.25) 1e-4; one FL round as in
``tests/test_torch_moe.py``; the CLIs run and give finite results.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import attention as ratt
from repro.models import transformer as rtr
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as pserve
from repro_torch.launch import train as ptrain
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import attention as att
from repro_torch.models import transformer as tr
from test_torch_moe import (_round_setup, check_int8_bytes, check_round,
                            one_round_pair)

ARCH = "deepseek-v2-lite-16b"
TOL = dict(rtol=1e-4, atol=1e-5)
STEP_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def setup():
    rcfg, cfg = ref_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    np_params = jax.tree.map(np.asarray, rtr.init_params(
        jax.random.PRNGKey(0), rcfg))
    return rcfg, cfg, np_params


def _layer0_attn(np_params):
    return {k: np.array(v[0])
            for k, v in np_params["blocks"]["attn"].items()}


def test_reduced_config_is_mla_with_unequal_head_dims(setup):
    _, cfg, _ = setup
    assert cfg.attention == "mla" and cfg.is_moe and cfg.n_shared == 2
    full = get_config(ARCH)
    assert full.mla_nope_dim + full.mla_rope_dim == 192
    assert full.mla_v_dim == 128 and full.kv_lora == 512


def test_mla_prefill_matches_reference(setup):
    _, cfg, np_params = setup
    p = _layer0_attn(np_params)
    x = np.random.default_rng(0).standard_normal(
        (2, 24, cfg.d_model)).astype(np.float32)
    pos = np.arange(24)
    out, (c_kv, k_pe) = att.mla_prefill(
        torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in p.items()},
        cfg, torch.from_numpy(pos))
    rout, (rc, rpe) = ratt.mla_prefill(jnp.asarray(x), p, cfg,
                                       jnp.asarray(pos))
    for a, b in ((out, rout), (c_kv, rc), (k_pe, rpe)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    assert tuple(c_kv.shape) == (2, 24, cfg.kv_lora)
    assert tuple(k_pe.shape) == (2, 24, cfg.mla_rope_dim)


def test_mla_decode_matches_reference(setup):
    """The absorbed-matrix decode against filled latent caches, 5 of 12
    slots valid."""
    _, cfg, np_params = setup
    p = _layer0_attn(np_params)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    c = rng.standard_normal((3, 12, cfg.kv_lora)).astype(np.float32)
    pe = rng.standard_normal((3, 12, cfg.mla_rope_dim)).astype(np.float32)
    out = att.mla_decode(torch.from_numpy(x),
                         {k: torch.from_numpy(v) for k, v in p.items()},
                         cfg, torch.from_numpy(c), torch.from_numpy(pe), 4)
    ref = ratt.mla_decode(jnp.asarray(x), p, cfg, jnp.asarray(c),
                          jnp.asarray(pe), jnp.int32(4))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_init_cache_matches_reference(setup):
    rcfg, cfg, _ = setup
    cache = tr.init_cache(cfg, 2, 16, dtype=torch.float32, device="cpu")
    ref = rtr.init_cache(rcfg, 2, 16, dtype=jnp.float32)
    assert cache.kv is None and cache.ssm is None
    assert [tuple(t.shape) for t in cache.mla] == [tuple(a.shape)
                                                   for a in ref.mla]
    assert all(t.dtype == torch.float32 and not t.any() for t in cache.mla)


def test_decode_steps_match_reference(setup):
    """``decode_step`` over 8 positions (dropless MoE, latent cache written
    in place) against the reference's, logits and caches 1e-4."""
    rcfg, cfg, np_params = setup
    params = params_from_jax(np_params, "cpu")
    B, S = 2, 8
    tok = np.random.default_rng(2).integers(0, cfg.vocab, (B, S)).astype(
        np.int32)
    cache = tr.init_cache(cfg, B, S, dtype=torch.float32, device="cpu")
    rcache = rtr.init_cache(rcfg, B, S, dtype=jnp.float32)
    for pos in range(S):
        logits, cache = tr.decode_step(params, cfg, cache,
                                       torch.from_numpy(tok[:, pos]), pos)
        rlogits, rcache = rtr.decode_step(np_params, rcfg, rcache,
                                          jnp.asarray(tok[:, pos]),
                                          jnp.int32(pos))
        np.testing.assert_allclose(logits.numpy(), np.asarray(rlogits),
                                   **STEP_TOL)
    for a, b in zip(cache.mla, rcache.mla):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **STEP_TOL)


def test_decode_agrees_with_dropless_prefill(setup):
    """Stepping the decode path (dropless) against the full-sequence
    forward at ``capacity_factor = n_experts``, position by position."""
    _, cfg, np_params = setup
    params = params_from_jax(np_params, "cpu")
    dropless = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
    B, S = 2, 8
    tok = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (B, S)).astype(np.int32))
    full = tr.forward(params, dropless, tok)
    cache = tr.init_cache(cfg, B, S, dtype=torch.float32, device="cpu")
    for pos in range(S):
        logits, cache = tr.decode_step(params, cfg, cache, tok[:, pos], pos)
        np.testing.assert_allclose(logits.numpy(), full[:, pos].numpy(),
                                   **STEP_TOL)
    last = make_prefill_step(dropless)(params, tok)
    np.testing.assert_allclose(last.numpy(), full[:, -1].numpy(), rtol=0,
                               atol=0)


def test_serve_step_writes_the_latent_cache(setup):
    _, cfg, np_params = setup
    params = params_from_jax(np_params, "cpu")
    cache = tr.init_cache(cfg, 2, 4, device="cpu")
    step = make_serve_step(cfg)
    nxt, cache = step(params, cache, torch.tensor([1, 2]), 0)
    assert nxt.dtype == torch.int32 and tuple(nxt.shape) == (2,)
    c_kv = cache.mla[0]
    assert bool(c_kv[:, :, 0].any()) and not c_kv[:, :, 1:].any()


# ---------------------------------------------------------------------------
# one FL round and the CLIs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def deepseek_round():
    return _round_setup(ARCH)


@pytest.mark.parametrize("backend", ["dense", "temporal"])
def test_one_round_matches_reference(deepseek_round, backend):
    check_round(one_round_pair(deepseek_round, backend))


def test_int8_round_bytes_match_reference(deepseek_round):
    check_int8_bytes(one_round_pair(deepseek_round, "dense", "int8"))


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "arctic-480b"])
def test_serve_cli(arch, capsys):
    pserve.main(["--arch", arch, "--device", "cpu", "--prompt-len", "4",
                 "--new-tokens", "3", "--batch", "2"])
    assert "tok/s" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "arctic-480b"])
def test_train_cli(arch, capsys):
    ptrain.main(["--arch", arch, "--device", "cpu", "--rounds", "1",
                 "--tmax", "10", "--clients", "2", "--seq", "8",
                 "--backend", "temporal", "--solver-steps", "40"])
    out = capsys.readouterr().out
    assert "[train] done" in out and "nan" not in out


def test_run_training_layers_cuts_depth():
    """``layers=1`` trains the config cut to its first block: one stacked
    layer a leaf, finite losses."""
    params, hist = ptrain.run_training(
        ARCH, rounds=1, tmax=10.0, U=2, seq=8, n_seq=8, layers=1,
        solver_steps=40, eval_every=1, verbose=False, device="cpu")
    assert params["blocks"]["moe"]["wg"].shape[0] == 1
    assert np.isfinite(hist.train_loss).all()
