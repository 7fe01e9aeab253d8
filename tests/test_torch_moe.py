"""The port's MoE FFN (``repro_torch.models.moe``) and the MoE blocks of the
LM (``models/transformer.py``) against the reference's, on the same numpy
inputs, at reduced size in f32.

Tolerances: ``router_topk``'s indices, each assignment's position in its
expert and the keep mask exactly equal; routing weights, ``moe_ffn``'s
output, logits and aux rtol 1e-4 (atol 1e-5 where values cancel to near
0: f32 sums in another order);
grads against ``jax.grad`` of ``loss_fn`` with the aux rtol 1e-4 / atol
1e-5; ``vmap(grad)`` over 3 clients against a per-client loop rtol 1e-5 /
atol 1e-6 (batched products sum in another order); one FL round's params
rtol 1e-4 / atol 1e-6 of the reference's same backend under its draws
(``tests/test_torch_train_lm.py``'s tolerance); width masks, layer ids and
the int8 round's byte counters exactly.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as robs
from repro.configs import get_config as ref_get_config
from repro.core.baselines import make_policy as ref_make_policy
from repro.core.scheduler import solve as ref_solve
from repro.core.types import AnalysisConfig as RefConfig
from repro.fl.runtime import RoundRuntime as RefRuntime
from repro.fl.runtime import probe_s_max as ref_probe_s_max
from repro.fl.tasks import lm_task as ref_lm_task
from repro.fl.tasks import make_lm_model as ref_make_lm_model
from repro.models import moe as rmoe
from repro.models import transformer as rtr
from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.core.baselines import make_policy
from repro_torch.core.types import AnalysisConfig, Schedule
from repro_torch.fl.runtime import RoundRuntime
from repro_torch.fl.tasks import lm_task, make_lm_model
from repro_torch.launch.steps import make_train_step
from repro_torch.models import moe
from repro_torch.models import transformer as tr
from repro_torch.tree import tree_leaves
from test_torch_train_lm import ReferenceDraws, _close_tree

ARCHS = ["arctic-480b", "deepseek-v2-lite-16b"]
OUT_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
VMAP_TOL = dict(rtol=1e-5, atol=1e-6)


def _moe_inputs(N=48, D=32, E=8, Fh=16, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, D)).astype(np.float32)
    p = {"router": rng.standard_normal((D, E)).astype(np.float32),
         "wg": (0.3 * rng.standard_normal((E, D, Fh))).astype(np.float32),
         "wu": (0.3 * rng.standard_normal((E, D, Fh))).astype(np.float32),
         "wd": (0.3 * rng.standard_normal((E, Fh, D))).astype(np.float32)}
    return x, p


def _torch(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def _ref_keep(experts, E, C):
    """The reference ``moe_ffn``'s positions and keep mask, its own lines
    run on its router's experts."""
    flat_e = experts.reshape(-1)
    onehot = jax.nn.one_hot(flat_e, E, dtype=jnp.int32)
    pos_in_e = jnp.cumsum(onehot, axis=0) - onehot
    pos = jnp.take_along_axis(pos_in_e, flat_e[:, None], axis=1)[:, 0]
    return np.asarray(pos), np.asarray(pos < C)


# ---------------------------------------------------------------------------
# router and moe_ffn
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("top_k", [1, 2, 6])
def test_router_topk_matches_reference(top_k):
    x, p = _moe_inputs(N=64, E=8)
    w, idx, aux = moe.router_topk(torch.from_numpy(x),
                                  torch.from_numpy(p["router"]), top_k)
    rw, ridx, raux = rmoe.router_topk(jnp.asarray(x), jnp.asarray(
        p["router"]), top_k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
    np.testing.assert_allclose(w.numpy(), np.asarray(rw), **OUT_TOL)
    np.testing.assert_allclose(float(aux), float(raux), rtol=1e-4)
    assert w.dtype == torch.float32


@pytest.mark.parametrize("cf,drops", [(1.0, True), (8.0, False)],
                         ids=["capacity", "dropless"])
def test_moe_ffn_matches_reference(cf, drops):
    """Capacity 1.0 drops assignments (asserted), ``cf = E`` none: the
    positions and keep mask equal the reference's exactly, the output and
    aux within rtol 1e-4."""
    N, E, K = 48, 8, 2
    x, p = _moe_inputs(N=N, E=E)
    out, aux = moe.moe_ffn(torch.from_numpy(x), _torch(p), top_k=K,
                           capacity_factor=cf)
    rout, raux = rmoe.moe_ffn(jnp.asarray(x), p, top_k=K,
                              capacity_factor=cf)
    np.testing.assert_allclose(out.numpy(), np.asarray(rout), **OUT_TOL)
    np.testing.assert_allclose(float(aux), float(raux), rtol=1e-4)
    C = max(int(N * K * cf / E), 1)
    _, ridx, _ = rmoe.router_topk(jnp.asarray(x), p["router"], K)
    rpos, rkeep = _ref_keep(ridx, E, C)
    _, idx, _ = moe.router_topk(torch.from_numpy(x),
                                torch.from_numpy(p["router"]), K)
    pos, keep = moe.expert_positions(idx.reshape(-1), E, C)
    np.testing.assert_array_equal(pos.numpy(), rpos)
    np.testing.assert_array_equal(keep.numpy(), rkeep)
    assert bool((~keep).any()) == drops


def test_moe_ffn_bf16_stays_bf16():
    x, p = _moe_inputs()
    tp = {k: v if k == "router" else v.to(torch.bfloat16)
          for k, v in _torch(p).items()}
    out, aux = moe.moe_ffn(torch.from_numpy(x).to(torch.bfloat16), tp,
                           top_k=2)
    assert out.dtype == torch.bfloat16 and aux.dtype == torch.float32
    assert bool(torch.isfinite(out.float()).all())


def test_moe_ffn_vmap_grad_equals_loop_and_reference():
    """``vmap(grad)`` of a loss through ``moe_ffn`` (capacity 1.0: drops)
    over 3 clients equals a per-client loop, and each client's grads equal
    ``jax.grad`` of the reference's."""
    rng = np.random.default_rng(1)
    xs = rng.standard_normal((3, 40, 32)).astype(np.float32)
    _, p = _moe_inputs()

    def loss(params, x):
        out, aux = moe.moe_ffn(x, params, top_k=2, capacity_factor=1.0)
        return (out ** 2).mean() + 0.1 * aux

    def rloss(params, x):
        out, aux = rmoe.moe_ffn(x, params, top_k=2, capacity_factor=1.0)
        return (out ** 2).mean() + 0.1 * aux

    tp = _torch(p)
    batched = torch.func.vmap(torch.func.grad(loss), in_dims=(None, 0))(
        tp, torch.from_numpy(xs))
    for u in range(3):
        one = torch.func.grad(loss)(tp, torch.from_numpy(xs[u]))
        ref = jax.grad(rloss)(p, jnp.asarray(xs[u]))
        for k in p:
            np.testing.assert_allclose(batched[k][u].numpy(),
                                       one[k].numpy(), **VMAP_TOL)
            np.testing.assert_allclose(one[k].numpy(), np.asarray(ref[k]),
                                       **GRAD_TOL)


# ---------------------------------------------------------------------------
# the MoE LM
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _ref_setup(arch):
    """The reduced configs of both packages and the reference's init (its
    numpy leaves are read-only, so tests share them)."""
    rcfg, cfg = ref_get_config(arch).reduced(), get_config(arch).reduced()
    np_params = jax.tree.map(np.asarray, rtr.init_params(
        jax.random.PRNGKey(0), rcfg))
    return rcfg, cfg, np_params


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape).astype(
        np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_structure_matches_reference(arch):
    """The port's init: the reference's leaves, shapes and dtypes (router
    f32 under bf16 params); ``count_params`` equals the config's count
    plus the final norm, which ``param_count`` leaves out."""
    rcfg, cfg, np_params = _ref_setup(arch)
    params = tr.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    ref = rtr.init_params(jax.random.PRNGKey(0), rcfg)
    assert [tuple(t.shape) for t in tree_leaves(params)] == [
        tuple(a.shape) for a in jax.tree.leaves(ref)]
    assert tr.count_params(params) == cfg.param_count() + cfg.d_model
    bf16 = tr.init_params(torch.Generator().manual_seed(0), cfg,
                          dtype=torch.bfloat16, device="cpu")
    assert bf16["blocks"]["moe"]["router"].dtype == torch.float32
    assert bf16["blocks"]["moe"]["wg"].dtype == torch.bfloat16
    meta = tr.init_params(torch.Generator(), get_config(arch),
                          device="meta")
    full = get_config(arch)
    assert tr.count_params(meta) == full.param_count() + full.d_model


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_and_aux_match_reference(arch):
    rcfg, cfg, np_params = _ref_setup(arch)
    tok = _tokens(cfg, (2, 32))
    logits, aux = tr.forward(params_from_jax(np_params, "cpu"), cfg,
                             torch.from_numpy(tok), with_aux=True)
    rlogits, raux = rtr.forward(np_params, rcfg, tok)
    np.testing.assert_allclose(logits.numpy(), np.asarray(rlogits),
                               **OUT_TOL)
    np.testing.assert_allclose(float(aux), float(raux), rtol=1e-4)
    assert torch.equal(logits, tr.forward(params_from_jax(np_params, "cpu"),
                                          cfg, torch.from_numpy(tok)))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_grads_match_reference(arch):
    """``torch.func.grad`` of ``loss_fn`` (CE + 0.01 aux / L) against
    ``jax.grad`` of the reference's."""
    rcfg, cfg, np_params = _ref_setup(arch)
    tok, lab = _tokens(cfg, (2, 16), 1), _tokens(cfg, (2, 16), 2)
    g = torch.func.grad(lambda p: tr.loss_fn(
        p, cfg, torch.from_numpy(tok), torch.from_numpy(lab),
        moe_aux_coef=0.01))(params_from_jax(np_params, "cpu"))
    rloss = float(rtr.loss_fn(np_params, rcfg, tok, lab, moe_aux_coef=0.01))
    loss = float(tr.loss_fn(params_from_jax(np_params, "cpu"), cfg,
                            torch.from_numpy(tok), torch.from_numpy(lab)))
    assert loss == pytest.approx(rloss, rel=1e-5)
    ref = jax.grad(lambda p: rtr.loss_fn(p, rcfg, tok, lab,
                                         moe_aux_coef=0.01))(np_params)
    _close_tree(g, ref, GRAD_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_vmap_grad_equals_loop(arch):
    """The FL backends' ``vmap(grad)`` of the ModelAPI loss over 3 clients,
    aux included, equals a per-client loop (each client's capacity is its
    own b * S tokens)."""
    _, cfg, np_params = _ref_setup(arch)
    model = make_lm_model(cfg)
    params = params_from_jax(np_params, "cpu")
    x = torch.from_numpy(_tokens(cfg, (3, 2, 17), 3))
    y = torch.zeros((3, 2), dtype=torch.int32)
    w = torch.full((3, 2), 0.5)
    batched = tree_leaves(torch.func.vmap(torch.func.grad(model.loss),
                                          in_dims=(None, 0, 0, 0))(
        params, x, y, w))
    for u in range(3):
        one = tree_leaves(torch.func.grad(model.loss)(params, x[u], y[u],
                                                      w[u]))
        for a, b in zip(batched, one):
            np.testing.assert_allclose(a[u].numpy(), b.numpy(), **VMAP_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_loss_matches_reference(arch):
    """``make_lm_model``'s loss (weighted CE + aux) and its
    ``moe_aux_coef`` against the reference's ModelAPI."""
    rcfg, cfg, np_params = _ref_setup(arch)
    x = _tokens(cfg, (2, 17), 4)
    w = np.full((2,), 0.5, np.float32)
    y = np.zeros((2,), np.int32)
    for coef in (0.01, 0.5):
        ref = float(ref_make_lm_model(rcfg, moe_aux_coef=coef).loss(
            np_params, x, y, w))
        out = float(make_lm_model(cfg, moe_aux_coef=coef).loss(
            params_from_jax(np_params, "cpu"), torch.from_numpy(x),
            torch.from_numpy(y), torch.from_numpy(w)))
        assert out == pytest.approx(ref, rel=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_layer_ids_and_width_masks_match_reference(arch):
    """Layer ids leaf for leaf, and the FFN-width masks on the (L, E, D, F)
    and (L, E, F, D) expert leaves, equal to the reference's."""
    rcfg, cfg, np_params = _ref_setup(arch)
    params = params_from_jax(np_params, "cpu")
    ids, rids = tr.layer_ids(params, cfg), rtr.layer_ids(np_params, rcfg)
    for a, b in zip(tree_leaves(ids), jax.tree.leaves(rids)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    ratios = np.asarray([0.25, 1.0, 0.5], np.float32)
    masks = make_lm_model(cfg).width_masks(params, ratios)
    _close_tree(masks, ref_make_lm_model(rcfg).width_masks(np_params,
                                                           ratios),
                dict(rtol=0, atol=0))
    wg = masks["blocks"]["moe"]["wg"]
    assert tuple(wg.shape) == (3,) + tuple(params["blocks"]["moe"]["wg"]
                                           .shape)
    assert float(wg[0].mean()) < 1.0 and float(wg[1].min()) == 1.0


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_round_trip(arch):
    """``params_from_jax`` / ``params_to_numpy`` carry the MoE and MLA
    leaves across, leaf for leaf and bit for bit."""
    _, _, np_params = _ref_setup(arch)
    back = params_to_numpy(params_from_jax(np_params, "cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(np_params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(np_params)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode", ["temporal", "spatial"])
def test_train_step_matches_reference(mode):
    """``make_train_step`` with ``moe_aux_coef`` on arctic matches the
    reference's one step."""
    from repro.launch.steps import make_train_step as ref_make_train_step
    rcfg, cfg, np_params = _ref_setup("arctic-480b")
    rng = np.random.default_rng(3)
    tok = rng.integers(0, rcfg.vocab, (3, 2, 16)).astype(np.int32)
    lab = rng.integers(0, rcfg.vocab, (3, 2, 16)).astype(np.int32)
    mask = np.ones((3, rcfg.n_blocks_total), np.float32)
    mask[0, 0] = 0.0
    p = np.full((rcfg.n_blocks_total,), 0.05, np.float32)
    ref = jax.jit(ref_make_train_step(rcfg, U=3, mode=mode, remat=False,
                                      moe_aux_coef=0.1))(
        np_params, tok, lab, mask, p, jnp.float32(0.1))
    out = make_train_step(cfg, U=3, mode=mode, remat=mode == "temporal",
                          moe_aux_coef=0.1)(
        params_from_jax(np_params, "cpu"),
        *map(torch.from_numpy, (tok, lab, mask, p)), 0.1)
    _close_tree(out, ref)


# ---------------------------------------------------------------------------
# one FL round against the reference's, under its draws
# ---------------------------------------------------------------------------

ROUND = dict(U=3, seq=16, n_seq=12, seed=0, T_max=30.0)


def _round_setup(arch):
    rcfg, cfg = ref_get_config(arch).reduced(), get_config(arch).reduced()
    kw = dict(U=ROUND["U"], L=rcfg.n_blocks_total, R=1,
              T_max=ROUND["T_max"], eta0=1.0, seed=ROUND["seed"])
    ref_cfg = RefConfig.default(**kw)
    ref_sched = ref_solve(ref_cfg, "adam", steps=100)
    sched = Schedule(T=np.asarray(ref_sched.T), m=ref_sched.m,
                     objective=ref_sched.objective,
                     p1=np.asarray(ref_sched.p1))
    return dict(rcfg=rcfg, cfg=cfg, ref_cfg=ref_cfg, ref_sched=ref_sched,
                sched=sched, port_cfg=AnalysisConfig.default(**kw),
                draws=ReferenceDraws(ROUND["seed"], 1, ref_sched, ref_cfg))


def one_round_pair(s, backend, compression=None):
    """One round of the LM task on ``backend`` in both packages from the
    reference's init, schedule and draws: (port params, port History, port
    counters, reference params, reference History, reference counters)."""
    task_kw = dict(U=ROUND["U"], seq=ROUND["seq"], n_seq=ROUND["n_seq"],
                   seed=ROUND["seed"])
    ref_task = ref_lm_task(s["rcfg"], **task_kw)
    ref_policy = ref_make_policy("adel", s["ref_cfg"],
                                 schedule=s["ref_sched"])
    s_max = max(min(ref_probe_s_max(ref_policy, 1), 4), 2)
    rtracer = robs.Tracer(robs.MemorySink())
    ref_params, ref_hist = RefRuntime(
        ref_task.model, ref_policy, backend=backend,
        compression=compression, tracer=rtracer).run(
        ref_task.source(), rounds=1, T_max=ROUND["T_max"],
        eta=s["ref_cfg"].eta, s_max=s_max,
        key=jax.random.PRNGKey(ROUND["seed"]), eval_fn=ref_task.eval_fn(),
        eval_every=1)
    task = lm_task(s["cfg"], **task_kw)
    policy = make_policy("adel", s["port_cfg"], schedule=s["sched"],
                         device="cpu")
    tracer = obs.Tracer(obs.MemorySink())
    params, hist = RoundRuntime(task.model, policy, backend=backend,
                                compression=compression, tracer=tracer,
                                device="cpu").run(
        task.source("cpu"), rounds=1, T_max=ROUND["T_max"],
        eta=s["port_cfg"].eta, s_max=s_max, eval_fn=task.eval_fn("cpu"),
        draws=s["draws"], init_params=s["draws"].init(s["rcfg"]))
    return (params, hist, tracer.summary()["counters"], ref_params, ref_hist,
            rtracer.summary()["counters"])


def check_round(pair):
    params, hist, _, ref_params, ref_hist, _ = pair
    _close_tree(params, ref_params)
    np.testing.assert_allclose(hist.train_loss, ref_hist.train_loss,
                               rtol=1e-5)
    assert hist.accuracy == pytest.approx(ref_hist.accuracy, abs=1e-6)


def check_int8_bytes(pair):
    _, hist, ctr, _, ref_hist, rctr = pair
    assert hist.rounds == ref_hist.rounds == [1]
    for key in ("aggregate_bytes_logical", "aggregate_bytes_wire"):
        assert ctr[key] == rctr[key], key
    assert ctr["aggregate_bytes_wire"] * 3 < ctr["aggregate_bytes_logical"]
    assert np.isfinite(hist.train_loss).all()


@pytest.fixture(scope="module")
def arctic_round():
    return _round_setup("arctic-480b")


@pytest.mark.parametrize("backend", ["dense", "temporal"])
def test_one_round_matches_reference(arctic_round, backend):
    check_round(one_round_pair(arctic_round, backend))


def test_int8_round_bytes_match_reference(arctic_round):
    check_int8_bytes(one_round_pair(arctic_round, "dense", "int8"))


def test_capacity_is_per_client_under_the_round():
    """Under the backends' vmap a client's capacity comes from its own
    tokens: a round of 3 clients equals the same clients' losses one at a
    time (``moe_ffn`` sees N = b * S, not U * b * S)."""
    cfg = dataclasses.replace(get_config("arctic-480b").reduced(),
                              capacity_factor=0.5)
    model = make_lm_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    x = torch.from_numpy(_tokens(cfg, (3, 2, 17), 5))
    y = torch.zeros((3, 2), dtype=torch.int32)
    w = torch.full((3, 2), 0.5)
    batched = torch.func.vmap(model.loss, in_dims=(None, 0, 0, 0))(
        params, x, y, w)
    for u in range(3):
        assert float(batched[u]) == pytest.approx(
            float(model.loss(params, x[u], y[u], w[u])), rel=1e-6)
