"""The port's buffered semi-async backend (``repro_torch.fl.backends.
BufferedBackend``): the ports of ``tests/test_backends.py``'s buffered
cases and of ``tests/test_unbiasedness.py``'s late-fold Monte-Carlo test,
plus rounds against the reference's ``BufferedBackend`` on the same
inputs.

Tolerances: ``lam=0`` against the port's dense backend, bit for bit.
Rounds against the reference, both fed the same params each round: params
rtol 1e-4 / atol 1e-6 (XLA-CPU and ATen sum in different orders), plus,
under int8, one quantization step of every client of every fold that
round (a delta on a rounding boundary may quantize one code apart, as in
``tests/test_torch_backends.py``); ``last_carry`` exactly equal (the fold
decisions are the same float32 numpy arithmetic). A 5-round run under the
reference's draws: the per-round carry ledger and the clock exactly
equal, accuracy within 2 test samples, loss rtol 1e-4 (as
``tests/test_torch_fl.py``). A slot folded two rounds after banking: its
fold exactly equal to the fold of a copy taken at banking time. The
Monte-Carlo test keeps the reference's bound (4.5 standard errors +
2e-3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as robs
from repro.core.baselines import RoundPlan as RefPlan
from repro.core.baselines import make_policy as ref_make_policy
from repro.core.types import AnalysisConfig as RefConfig
from repro.core.types import Schedule as RefSchedule
from repro.fl import backends as rbk
from repro.fl.runtime import _round_context as ref_round_context
from repro.fl.server import run_federated as ref_run_federated
from repro.fl.spec import ExecSpec as RefExecSpec
from repro.models import paper_models as rpm
from repro_torch import obs
from repro_torch.convert import params_from_jax
from repro_torch.core.aggregation import (aggregate_with_coeffs,
                                          layer_coefficients)
from repro_torch.core.baselines import RoundPlan, make_policy
from repro_torch.core.compression import aggregate_compressed
from repro_torch.core.scheduler import solve
from repro_torch.core.straggler import contribution_mask, sample_depths
from repro_torch.core.types import AnalysisConfig
from repro_torch.data.synthetic import make_image_dataset
from repro_torch.fl.backends import BufferedBackend, apply_update, make_backend
from repro_torch.fl.partition import dirichlet_partition, stack_clients
from repro_torch.fl.runtime import _round_context
from repro_torch.fl.server import run_federated
from repro_torch.fl.spec import ExecSpec
from repro_torch.models import paper_models as ppm
from repro_torch.tree import tree_leaves, tree_map
from test_torch_fl import ReferenceDraws

R = 5
U = 8


@pytest.fixture(scope="module")
def setup():
    x_tr, y_tr, x_te, y_te = make_image_dataset(
        "mnist", n_train=600, n_test=200, seed=0, noise_std=1.0)
    parts = dirichlet_partition(y_tr, U, alpha=0.5, seed=0)
    cx, cy, counts = stack_clients(x_tr, y_tr, parts)
    model = ppm.make_mlp()
    cfg = AnalysisConfig.default(U=U, L=model.L, R=R, T_max=R * model.L * 0.5,
                                 eta0=2.0, seed=0)
    schedule = solve(cfg, "adam", steps=150, device="cpu")
    return model, cfg, (cx, cy, counts, x_te, y_te), schedule


def _run(setup, method="adel", tracer=None, backend=None, exec=None):
    model, cfg, data, schedule = setup
    policy = make_policy(method, cfg, device="cpu",
                         schedule=schedule if method == "adel" else None)
    return run_federated(model, policy, cfg, *data, seed=0, exec=exec,
                         backend=backend, tracer=tracer, device="cpu")


@pytest.mark.parametrize("method", ["adel", "salf"])
def test_buffered_lam0_bit_identical_to_dense(setup, method):
    """lam=0 is round-synchronous: every round is the dense round."""
    (pd, hd), (pb, hb) = (_run(setup, method, backend="dense"),
                          _run(setup, method, backend="buffered"))
    assert hd.as_dict() == hb.as_dict()
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(pd),
                                                 tree_leaves(pb)))


def test_buffered_carries_late_work(setup):
    """lam>0 banks stragglers' unfinished layers and folds them into later
    rounds; the ledger rows carry the carried_in/out/stale columns and the
    drift summary aggregates them."""
    sink = obs.MemorySink()
    _, hist = _run(setup, tracer=obs.Tracer(sink),
                   exec=ExecSpec(backend="buffered", lam=0.6))
    rows = obs.ledger_rows(sink.records)
    assert any(r.get("carried_in", 0) > 0 for r in rows), rows
    assert any(r.get("carried_out", 0) > 0 for r in rows)
    # work banked at round t is never folded before round t+1
    taus = {int(tau) for r in rows for tau in (r.get("stale") or {})}
    assert taus and min(taus) >= 1
    drift = obs.drift_summary(rows)
    assert drift.get("carried_in_total", 0) > 0
    assert drift.get("stale_mean", 0.0) >= 1.0
    assert np.isfinite(hist.accuracy[-1])


def test_buffered_int8_banks_wire_tuples(setup):
    """Under int8 the ring keeps the wire tuples the on-time fold consumed
    (int8 codes in the canonical (U, L_leaf, F) layout, f32 scales), never
    dequantized f32."""
    model = setup[0]
    bk = make_backend("buffered", model, lam=0.6, compression="int8",
                      device="cpu")
    _, hist = _run(setup, backend=bk)
    assert bk._slots, "expected banked late work in the carry ring"
    for slot in bk._slots:
        assert len(slot["banked"]) == len(tree_leaves(model.layer_ids(
            model.init(torch.Generator(), "meta"))))
        for q, scale in slot["banked"]:
            assert q.dtype == torch.int8 and q.dim() == 3
            assert scale.dtype == torch.float32
            assert scale.shape == q.shape[:2] and q.shape[0] == U
    assert np.isfinite(hist.accuracy[-1])


def test_buffered_int8_banks_the_round_wire_payload():
    """The banked int8 slot is the wire payload ``compress_deltas`` makes
    of the round's deltas, code for code and scale for scale."""
    from repro_torch.core.compression import (compress_deltas,
                                              make_compression)
    model = ppm.make_mlp()
    bk = make_backend("buffered", model, lam=0.5, compression="int8",
                      device="cpu")
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    xb, yb, wb, mask, p, S = _round_plans(1)[0]
    _, ctx = _contexts(0, mask, p, S, 0.0)
    arrays = [torch.from_numpy(a) for a in (xb, yb, wb, mask, p)]
    bk.run_round(params, *arrays, ETA, bias_correct=True, ctx=ctx)
    want = compress_deltas(bk._deltas(params, *arrays[:3], ETA),
                           model.layer_ids(params), make_compression("int8"))
    (slot,) = bk._slots
    assert len(slot["banked"]) == len(want)
    for (q, sc), (wq, wsc) in zip(slot["banked"], want):
        assert torch.equal(q, wq) and torch.equal(sc, wsc)


def test_buffered_heterofl_lam_positive_rejected(setup):
    with pytest.raises(ValueError, match="HeteroFL"):
        _run(setup, "heterofl", exec=ExecSpec(backend="buffered", lam=0.6))


def test_buffered_reset_state_between_runs(setup):
    """A backend reused across runs does not leak carry slots: the
    runtime resets it, so two runs give the same History."""
    bk = make_backend("buffered", setup[0], lam=0.6, device="cpu")
    _, h1 = _run(setup, backend=bk)
    assert bk._slots and bk.last_carry
    _, h2 = _run(setup, backend=bk)
    assert h1.as_dict() == h2.as_dict()
    bk.reset_state()
    assert not bk._slots and not bk.last_carry


def test_buffered_needs_ctx_and_describe(setup):
    model = setup[0]
    bk = make_backend("buffered", model, lam=0.5, max_age=3, buffer_cap=2,
                      device="cpu")
    d = bk.describe()
    assert (d["backend"], d["lam"], d["max_age"], d["buffer_cap"]) == (
        "buffered", 0.5, 3, 2)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    x = torch.zeros((2, 3, 28, 28, 1))
    with pytest.raises(ValueError, match="RoundContext"):
        bk.run_round(params, x, torch.zeros((2, 3), dtype=torch.long),
                     torch.full((2, 3), 1 / 3), torch.ones((2, model.L)),
                     torch.zeros(model.L), 0.5, bias_correct=True)
    # the fold decisions read the planner's host mask, never the device's
    xb, yb, wb, mask, p, S = _round_plans(1)[0]
    _, ctx = _contexts(0, mask, p, S, 0.0)
    ctx.mask = None
    with pytest.raises(ValueError, match="host copy"):
        bk.run_round(params, *map(torch.from_numpy, (xb, yb, wb, mask, p)),
                     0.5, bias_correct=True, ctx=ctx)
    with pytest.raises(ValueError):
        BufferedBackend(model, lam=1.5, device="cpu")


# ---------------------------------------------------------------------------
# rounds against the reference's BufferedBackend
# ---------------------------------------------------------------------------

RU, S_MAX, ETA, L3 = 6, 6, 0.5, 3


def _round_plans(n_rounds):
    """Per round: the round's inputs and a plan with stragglers (every
    client's depth drawn so some miss layers), on a fixed simulated clock
    of 1.2 a round."""
    rng = np.random.default_rng(3)
    out = []
    for t in range(n_rounds):
        xb = rng.standard_normal((RU, S_MAX, 28, 28, 1)).astype(np.float32)
        yb = rng.integers(0, 10, (RU, S_MAX)).astype(np.int32)
        S = rng.integers(2, S_MAX + 1, RU)
        wb = ((np.arange(S_MAX)[None, :] < S[:, None]) / S[:, None]).astype(
            np.float32)
        z = rng.integers(0, L3 + 1, RU)
        z[0] = L3
        mask = (z[:, None] >= (L3 - np.arange(L3))[None, :]).astype(
            np.float32)
        p = rng.uniform(0.0, 0.2, L3).astype(np.float32)
        out.append((xb, yb, wb, mask, p, S.astype(np.float32)))
    return out


def _contexts(t, mask, p, S, elapsed):
    kw = dict(U=RU, L=L3, R=5, T_max=6.0, seed=0)
    ref_cfg, cfg = RefConfig.default(**kw), AnalysisConfig.default(**kw)
    ref_plan = RefPlan(mask=jnp.asarray(mask), p=jnp.asarray(p),
                       batch_sizes=jnp.asarray(S), elapsed=1.2,
                       bias_correct=True)
    plan = RoundPlan(mask=torch.from_numpy(mask), p=torch.from_numpy(p),
                     batch_sizes=torch.from_numpy(S), elapsed=1.2,
                     bias_correct=True)
    return (ref_round_context(t, elapsed, ref_plan, ref_cfg, RU),
            _round_context(t, elapsed, plan, cfg, RU))


def _fold_steps(bk, mask, p, deltas_payload):
    """One quantization step of every client of every fold of the round:
    ``sum_u |c[u, l]| * scale[u, row]`` for the on-time fold and for each
    pending slot (``c_late``, its weight at most 1), per leaf."""
    ids = tree_leaves(bk.model.layer_ids(bk.model.init(torch.Generator(),
                                                       "meta")))
    c = layer_coefficients(torch.from_numpy(mask), torch.from_numpy(p))
    folds = [(c, deltas_payload)] + [(s["c_late"], s["banked"])
                                     for s in bk._slots]
    steps = [0.0] * len(ids)
    for coeff, payload in folds:
        for k, (l, (_, scale)) in enumerate(zip(ids, payload)):
            steps[k] += float((coeff[:, l].abs()
                               * scale.amax(dim=1)).sum())
    return steps


@pytest.mark.parametrize("comp", [None, "int8"])
def test_rounds_match_reference_buffered(comp):
    """Four lam>0 rounds of the port's and the reference's buffered
    backends on the same inputs and simulated clock (params reset to the
    reference's each round): params within rtol 1e-4 and the carry ledger
    exactly equal, folds included."""
    ref_model, model = rpm.make_mlp(), ppm.make_mlp()
    rng = np.random.default_rng(1)
    np_params = jax.tree.map(
        lambda a: (rng.standard_normal(a.shape)
                   / np.sqrt(max(np.prod(a.shape[:-1]), 1))).astype(a.dtype),
        jax.eval_shape(ref_model.init, jax.random.PRNGKey(0)))
    knobs = dict(lam=0.5, max_age=2, buffer_cap=2, compression=comp)
    ref = rbk.make_backend("buffered", ref_model, donate=False, **knobs)
    bk = make_backend("buffered", model, device="cpu", **knobs)
    folded = 0
    for t, (xb, yb, wb, mask, p, S) in enumerate(_round_plans(4)):
        rctx, ctx = _contexts(t, mask, p, S, 1.2 * t)
        steps = [0.0] * len(jax.tree.leaves(np_params))
        if comp == "int8":
            from repro_torch.core.compression import (compress_deltas,
                                                      make_compression)
            params = params_from_jax(np_params, "cpu")
            payload = compress_deltas(
                bk._deltas(params, torch.from_numpy(xb),
                           torch.from_numpy(yb), torch.from_numpy(wb), ETA),
                model.layer_ids(params), make_compression("int8"))
            steps = _fold_steps(bk, mask, p, payload)
        ref_out = ref.run_round(
            jax.tree.map(jnp.asarray, np_params),
            *map(jnp.asarray, (xb, yb, wb, mask, p)), jnp.float32(ETA),
            bias_correct=True, ctx=rctx)
        out = bk.run_round(params_from_jax(np_params, "cpu"),
                           *map(torch.from_numpy, (xb, yb, wb, mask, p)),
                           ETA, bias_correct=True, ctx=ctx)
        assert bk.last_carry == ref.last_carry, (t, bk.last_carry,
                                                 ref.last_carry)
        folded += bk.last_carry["carried_in"]
        for a, b, step in zip(tree_leaves(out), jax.tree.leaves(ref_out),
                              steps):
            a, b = a.numpy(), np.asarray(b)
            assert a.shape == b.shape and a.dtype == b.dtype
            assert np.all(np.abs(a - b) <= 1e-6 + 1e-4 * np.abs(b)
                          + 1.0001 * step), (t, np.abs(a - b).max())
        np_params = jax.tree.map(np.asarray, ref_out)
    assert folded > 0, "the rounds folded no banked work"


def test_carry_ledger_matches_reference_over_five_rounds(setup):
    """Five buffered rounds under the reference's draws and init: the
    carry ledger (carried_in / out / dropped, staleness histogram) and the
    clock equal the reference's, the trajectory agrees."""
    model, cfg, data, sched = setup
    ref_cfg = RefConfig.default(U=U, L=model.L, R=R,
                                T_max=R * model.L * 0.5, eta0=2.0, seed=0)
    ref_sched = RefSchedule(T=sched.T, m=sched.m, objective=sched.objective,
                            p1=sched.p1)
    ref_model = rpm.make_mlp()
    rsink = robs.MemorySink()
    _, ref_hist = ref_run_federated(
        ref_model, ref_make_policy("adel", ref_cfg, schedule=ref_sched),
        ref_cfg, *map(jnp.asarray, data), key=jax.random.PRNGKey(0),
        exec=RefExecSpec(backend="buffered", lam=0.6, max_age=3,
                         buffer_cap=3),
        tracer=robs.Tracer(rsink))
    draws = ReferenceDraws(0, R, ref_sched.T, ref_sched.m, ref_cfg)
    init = params_from_jax(jax.tree.map(np.asarray,
                                        ref_model.init(draws.k_init)), "cpu")
    sink = obs.MemorySink()
    _, hist = run_federated(
        model, make_policy("adel", cfg, schedule=sched, device="cpu"), cfg,
        *data, draws=draws, init_params=init, tracer=obs.Tracer(sink),
        exec=ExecSpec(backend="buffered", lam=0.6, max_age=3, buffer_cap=3),
        device="cpu")
    cols = ("t", "carried_in", "carried_out", "carried_dropped", "stale",
            "sim_total", "missed")
    rows = [{k: r.get(k) for k in cols} for r in obs.ledger_rows(
        sink.records)]
    ref_rows = [{k: r.get(k) for k in cols} for r in robs.ledger_rows(
        rsink.records)]
    assert rows == ref_rows and len(rows) == R
    assert sum(r["carried_in"] for r in rows) > 0
    assert hist.times == ref_hist.times
    np.testing.assert_allclose(hist.accuracy, ref_hist.accuracy, rtol=0,
                               atol=2.0 / len(data[4]) + 1e-9)
    np.testing.assert_allclose(hist.train_loss, ref_hist.train_loss,
                               rtol=1e-4)


@pytest.mark.parametrize("comp", [None, "int8"])
def test_slot_folded_two_rounds_later_equals_banking_copy(comp):
    """A slot banked at round 0, not yet arrived at round 1, folded at
    round 2: the fold equals the fold of a copy of its payload taken at
    banking time (the ring owns its payload; nothing later wrote it)."""
    model = ppm.make_mlp()
    bk = make_backend("buffered", model, lam=0.5, compression=comp,
                      device="cpu")
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    plans = _round_plans(3)
    seen = []
    fold_slot = bk._fold_slot

    def spy(p, slot, w):
        out = fold_slot(p, slot, w)
        seen.append((p, slot, w, out))
        return out

    bk._fold_slot = spy
    copy0 = None
    for t, (xb, yb, wb, mask, p, S) in enumerate(plans):
        # round 1 ends before any round-0 straggler lands; round 2 long after
        elapsed = {0: 0.0, 1: 1.2, 2: 50.0}[t]
        _, ctx = _contexts(t, mask, p, S, elapsed)
        if t == 1:
            ctx.sim_end = ctx.sim_start + 1e-6
        params = bk.run_round(params,
                              *map(torch.from_numpy, (xb, yb, wb, mask, p)),
                              ETA, bias_correct=True, ctx=ctx)
        if t == 0:
            copy0 = tree_map(torch.clone, bk._slots[0]["banked"])
        if t == 1:
            assert not seen and bk.last_carry["carried_in"] == 0
    assert bk.last_carry["stale"].get(2, 0) > 0
    p_in, slot, w, out = next(s for s in seen if s[1]["round"] == 0)
    ids = model.layer_ids(p_in)
    coeffs = slot["c_late"] * torch.from_numpy(w)[:, None]
    if comp is None:
        agg = aggregate_with_coeffs(copy0, ids, coeffs)
    else:
        agg = aggregate_compressed(copy0, p_in, ids, None, None,
                                   cfg=bk.compression, coeffs=coeffs)
    expect = apply_update(p_in, agg)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(out),
                                                 tree_leaves(expect)))


def test_warm_up_leaves_the_ring_as_found(setup):
    """The prefetch warm-up's dummy buffered round banks into a ring it
    then discards: the ring, the carry stats and the tracer are as
    found."""
    model = setup[0]
    bk = make_backend("buffered", model, lam=0.5, device="cpu")
    sink = obs.MemorySink()
    bk.set_tracer(obs.Tracer(sink))
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    xb, yb, wb, mask, p, S = _round_plans(1)[0]
    _, ctx = _contexts(0, mask, p, S, 0.0)
    arrays = [torch.from_numpy(a) for a in (xb, yb, wb, mask, p)]
    bk.run_round(params, *arrays, ETA, bias_correct=True, ctx=ctx)
    slots, carry = bk._slots, dict(bk.last_carry)
    banked = [[t.clone() for t in tree_leaves(s["banked"])] for s in slots]
    pending = [s["pending"].copy() for s in slots]
    n_records = len(sink.records)
    assert bk.warm_up(params, *arrays, ETA, ctx=ctx) > 0
    assert bk._slots is slots and bk.last_carry == carry
    assert len(sink.records) == n_records
    for s, b, pend in zip(bk._slots, banked, pending):
        assert np.array_equal(s["pending"], pend)
        assert all(torch.equal(x, y) for x, y in zip(tree_leaves(s["banked"]),
                                                     b))


# ---------------------------------------------------------------------------
# Lemma 2 on the late set (port of tests/test_unbiasedness.py)
# ---------------------------------------------------------------------------

def test_lam1_late_fold_unbiased_montecarlo():
    """At ``lam=1`` the backend's carried fold is unbiased: its late-set
    coefficients (Eq. 5 on ``1 - mask`` over the real rows, with the
    late-set zero-contributor probabilities) at staleness weight
    ``lam ** tau = 1`` estimate the FedAvg layer mean, so the fold adds an
    unbiased estimate of exactly the update the synchronous round
    discarded. Two padded rows ride along and must weigh nothing."""
    Uc, L, F, pad = 8, 5, 12, 2
    g = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (Uc + pad, L, F)).astype(np.float32))
    ids = torch.arange(L)
    lam = np.full(Uc, 5.0, np.float32)        # exchangeable rates (B3)
    bk = BufferedBackend(ppm.make_mlp(), lam=1.0, device="cpu")
    w = np.float32(bk.lam) ** 3               # any staleness tau
    n = 6000
    gen = torch.Generator().manual_seed(43)
    z = sample_depths(gen, torch.from_numpy(lam).expand(n, Uc).contiguous())
    agg = []
    for i in range(n):
        mask = np.zeros((Uc + pad, L), np.float32)
        mask[:Uc] = contribution_mask(z[i], L).numpy()
        c = bk.late_coefficients(mask, Uc, lam) * w
        assert float(c[Uc:].abs().sum()) == 0.0
        agg.append(aggregate_with_coeffs({"w": g}, {"w": ids}, c)["w"])
    agg = torch.stack(agg)                                      # (n, L, F)
    mean = agg.mean(0).numpy()
    se = agg.std(0).numpy() / np.sqrt(n)
    err = np.abs(mean - g[:Uc].mean(0).numpy())
    assert np.all(err <= 4.5 * se + 2e-3), (err.max(), se.max())
