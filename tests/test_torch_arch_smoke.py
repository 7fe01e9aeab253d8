"""Per-architecture smoke tests of the port (the port of
``tests/test_arch_smoke.py`` for the dense, hybrid and ssm families, and of
the parts of ``tests/test_models_extra.py`` whose modules the port has).

A REDUCED variant of every arch (2 layers, d_model <= 512; the dense, moe
(GQA and MLA), hybrid, ssm, vlm and audio families) runs a forward, one
federated train step and two serve steps on the CPU: shapes check out,
nothing is NaN, the step changes params. The vlm and audio archs take
their frontend (patch or frame embeddings) in the forward and the train
step, and serve seamless with its cross-attention cache. The forward is
held against the reference's on the same params (rtol = atol = 1e-4, as
``tests/test_torch_lm.py``'s logits). GroupNorm statistics atol 1e-4 /
1e-3 and the zero-init heads' ln(10) loss 1e-3, as the reference's tests.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.models import transformer as rtr
from repro_torch.configs import ARCHS
from repro_torch.convert import params_from_jax
from repro_torch.fl.tasks import make_lm_model
from repro_torch.launch.steps import make_serve_step, make_train_step
from repro_torch.models import transformer as tr
from repro_torch.models.nn import group_norm
from repro_torch.models.paper_models import make_cnn, make_mlp, make_vgg
from repro_torch.tree import tree_leaves

ARCH_NAMES = sorted(ARCHS)
COVERED = [n for n in ARCH_NAMES if ARCHS[n].family in ("dense", "moe",
                                                        "hybrid", "ssm",
                                                        "vlm", "audio")]
UNCOVERED: dict = {}
# the families the port once refused, and the ROADMAP item that ported them
PORTED = {"llava-next-34b": "1.13.4", "seamless-m4t-medium": "1.13.4"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small CPU tensors: the suite runs
    several test processes at once, and their thread pools contend for
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _frontend(cfg, lead, seed=3):
    """Patch or frame embeddings (*lead, n_front, D), or None."""
    if cfg.frontend == "none":
        return None
    return 0.02 * torch.randn((*lead, cfg.n_frontend_tokens, cfg.d_model),
                              generator=_gen(seed))


def _ref_params(name):
    cfg = REF_ARCHS[name].reduced()
    return params_from_jax(jax.tree.map(np.asarray, rtr.init_params(
        jax.random.PRNGKey(0), cfg)), "cpu"), cfg


def test_covered_and_uncovered_partition_the_archs():
    assert sorted(COVERED + list(UNCOVERED)) == ARCH_NAMES
    assert {"hymba-1.5b", "mamba2-370m", "qwen1.5-4b", "arctic-480b",
            "deepseek-v2-lite-16b", "llava-next-34b",
            "seamless-m4t-medium"} <= set(COVERED)


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_reduced_constraints(name):
    r = ARCHS[name].reduced()
    assert r.L == 2
    assert r.d_model <= 512
    assert r.n_experts <= 4
    assert r.n_heads % r.n_kv == 0


@pytest.mark.parametrize("name", COVERED)
def test_forward_shapes_no_nan(name):
    """Logits (B, S_out, padded vocab), finite, equal to the reference's
    forward on the same params; a vlm prepends its n_front patch
    positions, an audio arch encodes its frames."""
    params, rcfg = _ref_params(name)
    cfg = ARCHS[name].reduced()
    B, S = 2, 32
    tok = np.random.default_rng(0).integers(0, cfg.vocab, (B, S)).astype(
        np.int32)
    fr = _frontend(cfg, (B,))
    logits = tr.forward(params, cfg, torch.from_numpy(tok), frontend=fr)
    S_out = S + (cfg.n_frontend_tokens if cfg.frontend == "vision" else 0)
    assert tuple(logits.shape) == (B, S_out, cfg.padded_vocab)
    assert bool(torch.isfinite(logits).all())
    ref, _ = rtr.forward(jax.tree.map(lambda t: t.numpy(), params), rcfg,
                         tok, frontend=None if fr is None else fr.numpy())
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("name", COVERED)
def test_federated_train_step(name):
    """One ADEL federated round on the reduced config (temporal, with
    remat): params change, everything finite."""
    cfg = ARCHS[name].reduced()
    params = tr.init_params(_gen(), cfg, device="cpu")
    U, b, S = 3, 2, 16
    L_tot = cfg.n_blocks_total
    tok = torch.randint(0, cfg.vocab, (U, b, S), generator=_gen(1))
    lab = torch.randint(0, cfg.vocab, (U, b, S), generator=_gen(2))
    mask = torch.ones((U, L_tot))
    mask[0, 0] = 0.0
    p = torch.full((L_tot,), 0.05)
    fr = _frontend(cfg, (U, b))
    new = make_train_step(cfg, U=U, mode="temporal")(
        params, tok, lab, mask, p, 0.1, *(() if fr is None else (fr,)))
    assert all(bool(torch.isfinite(t).all()) for t in tree_leaves(new))
    changed = sum(not torch.equal(a, b) for a, b in zip(tree_leaves(params),
                                                         tree_leaves(new)))
    assert changed > 0


@pytest.mark.parametrize("name", COVERED)
def test_serve_step(name):
    cfg = ARCHS[name].reduced()
    params = tr.init_params(_gen(), cfg, device="cpu")
    B = 2
    cache = tr.init_cache(cfg, B, 32, dtype=torch.float32, device="cpu")
    if cfg.enc_layers:
        with torch.inference_mode():
            enc = tr._run_encoder(params, cfg, _frontend(cfg, (B,)),
                                  torch.float32)
            cache = cache._replace(cross=tr.build_cross_cache(params, cfg,
                                                              enc))
    tok = torch.randint(0, cfg.vocab, (B,), generator=_gen(1))
    step = make_serve_step(cfg)
    nxt, cache2 = step(params, cache, tok, 0)
    assert nxt.shape == (B,) and nxt.dtype == torch.int32
    nxt2, _ = step(params, cache2, nxt, 1)
    assert bool(((nxt2 >= 0) & (nxt2 < cfg.padded_vocab)).all())


@pytest.mark.parametrize("name", sorted(PORTED))
def test_uncovered_families_name_their_item_in_training(name):
    """The families once refused in training (ROADMAP ``PORTED[name]``)
    train: ``make_train_step`` takes its trailing frontend in both client
    layouts, and ``make_lm_model`` runs text only over every block
    (``L = n_blocks_total``) with finite grads."""
    assert PORTED[name] == "1.13.4"
    cfg = ARCHS[name].reduced()
    params = tr.init_params(_gen(), cfg, device="cpu")
    U, b, S = 2, 2, 8
    tok = torch.randint(0, cfg.vocab, (U, b, S), generator=_gen(1))
    mask, p = torch.ones((U, cfg.n_blocks_total)), torch.zeros(
        (cfg.n_blocks_total,))
    for mode in ("temporal", "spatial"):
        new = make_train_step(cfg, U=U, mode=mode)(
            params, tok, tok, mask, p, 0.1, _frontend(cfg, (U, b)))
        assert all(bool(torch.isfinite(t).all()) for t in tree_leaves(new))
    model = make_lm_model(cfg)
    assert model.L == cfg.n_blocks_total
    rows = torch.randint(0, cfg.vocab, (b, S + 1), generator=_gen(2))
    g = torch.func.grad(model.loss)(params, rows, torch.zeros(b),
                                    torch.full((b,), 1.0 / b))
    assert all(bool(torch.isfinite(t).all()) for t in tree_leaves(g))


# ---------------------------------------------------------------------------
# paper-model details (tests/test_models_extra.py)
# ---------------------------------------------------------------------------

def test_group_norm_normalizes_groups():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 4, 4, 16)).astype(np.float32)) * 5 + 3
    y = group_norm(x, torch.ones(16), torch.zeros(16), groups=4)
    yg = y.numpy().reshape(2, 4, 4, 4, 4)
    np.testing.assert_allclose(yg.mean(axis=(1, 2, 4)), 0.0, atol=1e-4)
    np.testing.assert_allclose(yg.std(axis=(1, 2, 4)), 1.0, atol=1e-3)


def test_group_norm_affine():
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, 2, 2, 8)).astype(np.float32))
    y = group_norm(x, 2.0 * torch.ones(8), 3.0 * torch.ones(8), groups=2)
    y1 = group_norm(x, torch.ones(8), torch.zeros(8), groups=2)
    np.testing.assert_allclose(y.numpy(), (2.0 * y1 + 3.0).numpy(),
                               rtol=1e-5)


@pytest.mark.parametrize("make", [make_mlp, make_cnn,
                                  lambda: make_vgg(11, width_scale=0.125)],
                         ids=["mlp", "cnn", "vgg11"])
def test_zero_init_head_gives_log10_loss(make):
    model = make()
    params = model.init(_gen(), "cpu")
    shape = (8, 28, 28, 1) if model.name in ("mlp", "cnn") else (8, 32, 32, 3)
    x = torch.randn(shape, generator=_gen(1))
    y = torch.arange(8) % 10
    w = torch.full((8,), 1.0 / 8)
    loss = float(model.loss(params, x, y, w))
    assert abs(loss - np.log(10.0)) < 1e-3, loss


def test_vgg_width_masks_cover_norm_params():
    model = make_vgg(11, width_scale=0.125)
    params = model.init(_gen(), "cpu")
    masks = model.width_masks(params, np.asarray([0.5, 1.0]))
    # congruent trees: every param leaf has a mask leaf with a leading U dim
    for p_, m in zip(tree_leaves(params), tree_leaves(masks)):
        assert tuple(m.shape) == (2,) + tuple(p_.shape)
    assert len(tree_leaves(masks)) == len(tree_leaves(params))
