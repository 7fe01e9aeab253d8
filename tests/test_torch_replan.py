"""The port's online re-planning (``repro_torch.core.replan`` and the round
loop's skip and replan arms): the ports of ``tests/test_replan.py``'s
cases, with the replan events held against the reference's.

Tolerances: a replan event's round, reachable count, ``U_est`` and the
skip credit exactly equal to the reference's (host arithmetic on the same
numbers); ``T_tail``, ``budget_left``, ``m`` and the objective rtol 5e-3
(the port's torch Adam and the reference's jax Adam round differently in
f32, the solver tolerance of ``tests/test_torch_theory.py``). Within the
port: ``replan="never"`` bit for bit against no replanner, and the
feasibility bounds of the reference's tests (tail sums rtol 1e-4,
nonincreasing to 1e-5, ``p_t^1 < 0.2``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.baselines import make_policy as ref_make_policy
from repro.core.replan import ReplanConfig as RefReplanConfig
from repro.core.replan import Replanner as RefReplanner
from repro.core.types import AnalysisConfig as RefConfig
from repro.core.types import Schedule as RefSchedule
from repro.fl.runtime import RoundRuntime as RefRuntime
from repro.fl.runtime import StaticCohortSource as RefStaticSource
from repro.fl.server import run_federated as ref_run_federated
from repro.fleet import availability as ravail
from repro.fleet.engine import partition_fleet as ref_partition_fleet
from repro.fleet.engine import run_fleet as ref_run_fleet
from repro.fleet.profiles import make_fleet as ref_make_fleet
from repro.models.paper_models import make_mlp as ref_make_mlp
from repro_torch.core.baselines import make_policy
from repro_torch.core.replan import (ReplanConfig, Replanner, make_replan,
                                     remaining_horizon)
from repro_torch.core.scheduler import (_default_m_min, _theta_to_Tm, _x_min,
                                        invert_schedule, solve_adam)
from repro_torch.core.types import AnalysisConfig
from repro_torch.data.synthetic import make_image_dataset
from repro_torch.fl.partition import dirichlet_partition, stack_clients
from repro_torch.fl.runtime import RoundRuntime, StaticCohortSource
from repro_torch.fl.server import run_federated
from repro_torch.fleet.availability import make_availability
from repro_torch.fleet.engine import partition_fleet, run_fleet
from repro_torch.fleet.profiles import make_fleet
from repro_torch.models.paper_models import make_mlp

RTOL = 5e-3
EXACT = ("round", "reachable", "U_est", "steps")
CLOSE = ("budget_left", "m", "objective", "skipped_credit")


def _assert_events_match(events, ref_events):
    """Replan records (dicts): the decision fields exactly, the solved
    numbers to the solver tolerance."""
    assert len(events) == len(ref_events) >= 1
    for ev, rv in zip(events, ref_events):
        assert {k: ev[k] for k in EXACT} == {k: rv[k] for k in EXACT}
        for k in CLOSE:
            assert ev[k] == pytest.approx(rv[k], rel=RTOL, abs=1e-9), k
        np.testing.assert_allclose(ev["T_tail"], rv["T_tail"], rtol=RTOL)


@pytest.fixture(scope="module")
def cfg():
    return AnalysisConfig.default(U=10, L=8, R=12, T_max=120.0, seed=1)


@pytest.fixture(scope="module")
def schedule(cfg):
    return solve_adam(cfg, steps=600, device="cpu")


def _ref_schedule(sch):
    return RefSchedule(T=np.asarray(sch.T), m=sch.m,
                       objective=sch.objective, p1=np.asarray(sch.p1))


# ---------------------------------------------------------------------------
# warm start
# ---------------------------------------------------------------------------

def test_invert_schedule_roundtrip(cfg, schedule):
    """theta = invert(T, m) reproduces (T, m) under the solver's
    parameterization: the warm start begins at the incumbent tail."""
    theta = invert_schedule(cfg, schedule.T, schedule.m)
    T2, m2 = _theta_to_Tm(torch.as_tensor(theta), cfg, _default_m_min(cfg),
                          _x_min(cfg))
    np.testing.assert_allclose(T2.numpy(), schedule.T, rtol=1e-5)
    assert abs(float(m2) - schedule.m) < 1e-5 * max(schedule.m, 1.0)


def test_warm_start_matches_cold_start(cfg, schedule):
    """A few hundred warm-started steps reach the 3000-step cold solve."""
    t = 5
    rem = remaining_horizon(cfg, t, float(schedule.T[t:].sum()), cfg.eta[t:])
    theta0 = invert_schedule(rem, schedule.T[t:], schedule.m)
    warm = solve_adam(rem, steps=300, theta0=theta0, device="cpu")
    cold = solve_adam(rem, steps=3000, device="cpu")
    assert warm.objective <= cold.objective * 1.01, \
        (warm.objective, cold.objective)


# ---------------------------------------------------------------------------
# re-solved tail feasibility, against the reference's re-solve
# ---------------------------------------------------------------------------

def test_replanned_tail_feasible_and_matches_reference(cfg, schedule):
    policy = make_policy("adel", cfg, schedule=schedule, device="cpu")
    rp = Replanner(ReplanConfig(trigger="every-k", steps=250), policy,
                   cfg.R, cfg.eta, device="cpu")
    t = 4
    budget_left = cfg.T_max - float(schedule.T[:t].sum())
    ev = rp.replan(t, budget_left, reachable=cfg.U)
    tail = np.asarray(ev.T_tail)
    assert tail.shape == (cfg.R - t,)
    assert np.all(tail > 0) and np.all(np.diff(tail) <= 1e-5)
    np.testing.assert_allclose(tail.sum(), budget_left, rtol=1e-4)
    sch = policy.schedule
    np.testing.assert_array_equal(sch.T[:t], schedule.T[:t])
    np.testing.assert_allclose(sch.T[t:], tail, rtol=1e-6)
    assert np.all(sch.p1[t:] < 0.2 + 1e-6)
    assert sch.solver.endswith("-replan")
    assert rp.events == [ev]
    # the reference's Replanner on the same incumbent schedule
    ref_cfg = RefConfig.default(U=10, L=8, R=12, T_max=120.0, seed=1)
    ref_policy = ref_make_policy("adel", ref_cfg,
                                 schedule=_ref_schedule(schedule))
    ref_rp = RefReplanner(RefReplanConfig(trigger="every-k", steps=250),
                          ref_policy, cfg.R, cfg.eta)
    ref_ev = ref_rp.replan(t, budget_left, reachable=cfg.U)
    _assert_events_match([ev.as_dict()], [ref_ev.as_dict()])


def test_replan_view_tail_feasible_under_shrunken_fleet():
    """A fleet-style view with a U_round forecast: the re-solved tail keeps
    the Lemma-3 construction (budget exact, nonincreasing, p_t^1 <= 0.2 at
    the smallest forecast cohort), and matches the reference's."""
    kw = dict(U=16, L=6, R=10, T_max=60.0, seed=0)
    cfg = AnalysisConfig.default(**kw)
    schedule = solve_adam(cfg, steps=400, device="cpu")
    t = 3
    budget_left = float(schedule.T[t:].sum())
    u_fore = np.asarray([16, 9, 4, 2, 2, 5, 12], np.float32)
    events = []
    for pkg in ("port", "ref"):
        if pkg == "port":
            c = cfg
            policy = make_policy("adel", c, schedule=schedule, device="cpu")
            rp = Replanner(ReplanConfig(trigger="drift", steps=250), policy,
                           c.R, c.eta, device="cpu")
        else:
            c = RefConfig.default(**kw)
            policy = ref_make_policy("adel", c,
                                     schedule=_ref_schedule(schedule))
            rp = RefReplanner(RefReplanConfig(trigger="drift", steps=250),
                              policy, c.R, c.eta)
        view = dataclasses.replace(c, R=c.R - t, T_max=budget_left,
                                   eta=c.eta[t:], U_round=u_fore)
        ev = rp.replan(t, budget_left, reachable=5, view=view)
        tail = np.asarray(ev.T_tail)
        assert np.all(np.diff(tail) <= 1e-5)
        np.testing.assert_allclose(tail.sum(), budget_left, rtol=1e-4)
        assert np.all(np.asarray(policy.schedule.p1[t:]) < 0.2 + 1e-6)
        assert ev.U_est == view.U and ev.reachable == 5
        events.append(ev.as_dict())
    _assert_events_match([events[0]], [events[1]])


# ---------------------------------------------------------------------------
# triggers
# ---------------------------------------------------------------------------

def test_make_replan_normalization():
    assert make_replan(None) is None
    assert make_replan("drift").trigger == "drift"
    rc = ReplanConfig(trigger="every-k", every=7)
    assert make_replan(rc) is rc
    with pytest.raises(ValueError):
        ReplanConfig(trigger="sometimes")
    with pytest.raises(TypeError):
        make_replan(3)
    assert not ReplanConfig().active and ReplanConfig("drift").active


def test_should_replan_triggers(cfg, schedule):
    policy = make_policy("adel", cfg, schedule=schedule, device="cpu")
    ek = Replanner(ReplanConfig(trigger="every-k", every=3), policy,
                   cfg.R, cfg.eta)
    assert not ek.should_replan(0, 100)          # round-0 plan reference
    fired = [t for t in range(1, cfg.R) if ek.should_replan(t, 100)]
    assert fired == [3, 6, 9]                    # R-1=11 past min_rounds_left

    dr = Replanner(ReplanConfig(trigger="drift", drift_threshold=0.25),
                   policy, cfg.R, cfg.eta)
    assert not dr.should_replan(0, 200)          # sets the reference
    assert not dr.should_replan(1, 180)          # -10%: below threshold
    assert dr.should_replan(2, 120)              # -40%: drift
    assert not dr.should_replan(cfg.R - 1, 10)   # tail too short to re-plan


def test_replanner_requires_schedule_policy(cfg):
    with pytest.raises(ValueError, match="adel"):
        Replanner(ReplanConfig(trigger="drift"),
                  make_policy("salf", cfg, device="cpu"), cfg.R, cfg.eta)


def test_note_skip_credits_and_forces(cfg, schedule):
    policy = make_policy("adel", cfg, schedule=schedule, device="cpu")
    rp = Replanner(ReplanConfig(trigger="drift", drift_threshold=10.0),
                   policy, cfg.R, cfg.eta)
    assert not rp.should_replan(0, 50)
    assert rp.note_skip(2) == pytest.approx(float(schedule.T[2]))
    assert float(policy.schedule.T[2]) == 0.0
    assert rp.should_replan(3, 50)               # the credit forces it
    assert rp.note_skip(99) == 0.0               # out of the horizon


# ---------------------------------------------------------------------------
# availability estimators (the population side of the re-plan view)
# ---------------------------------------------------------------------------

def test_expected_reachable_estimators():
    always = make_availability("always-on", 50)
    np.testing.assert_allclose(always.expected_reachable(0, 3), [50, 50, 50])
    bern = make_availability("bernoulli", 400, seed=0, rate=0.7)
    np.testing.assert_allclose(bern.expected_reachable(5, 2), [280, 280])
    kw = dict(mean=0.5, amplitude=0.4, period=8.0, phase_spread=0.3)
    diu = make_availability("diurnal", 300, seed=0, **kw)
    ref_diu = ravail.make_availability("diurnal", 300, seed=0, **kw)
    exp = diu.expected_reachable(0, 8)
    np.testing.assert_array_equal(exp, ref_diu.expected_reachable(0, 8))
    assert exp.max() > 1.5 * exp.min()           # synchronized wave swings
    real = np.asarray([diu.step(t).sum() for t in range(8)])
    assert np.corrcoef(exp, real)[0, 1] > 0.9
    mk = make_availability("markov", 500, seed=0, p_off_to_on=0.3,
                           p_on_to_off=0.1)
    ref_mk = ravail.make_availability("markov", 500, seed=0,
                                      p_off_to_on=0.3, p_on_to_off=0.1)
    mk.step(0)
    ref_mk.step(0)
    now = mk.expected_reachable(0, 1)[0]
    assert now == mk.state.sum()                 # k=0: the drawn state
    far = mk.expected_reachable(0, 40)
    np.testing.assert_array_equal(far, ref_mk.expected_reachable(0, 40))
    assert abs(far[-1] - 0.75 * 500) < 1.0       # k->inf: stationary rate


def test_diurnal_phase_spread_controls_population_swing():
    washed = make_availability("diurnal", 400, seed=0, mean=0.5,
                               amplitude=0.4, period=8.0)
    synced = make_availability("diurnal", 400, seed=0, mean=0.5,
                               amplitude=0.4, period=8.0, phase_spread=0.3)

    def swing(m):
        e = m.expected_reachable(0, 8)
        return float(e.max() - e.min())

    assert swing(synced) > 4 * swing(washed)


# ---------------------------------------------------------------------------
# the round loop
# ---------------------------------------------------------------------------

R = 5
U = 8


@pytest.fixture(scope="module")
def fl_setup():
    x_tr, y_tr, x_te, y_te = make_image_dataset(
        "mnist", n_train=600, n_test=200, seed=0, noise_std=1.0)
    parts = dirichlet_partition(y_tr, U, alpha=0.5, seed=0)
    cx, cy, counts = stack_clients(x_tr, y_tr, parts)
    model = make_mlp()
    cfg = AnalysisConfig.default(U=U, L=model.L, R=R, T_max=R * model.L * 0.5,
                                 eta0=2.0, seed=0)
    schedule = solve_adam(cfg, steps=150, device="cpu")
    return model, cfg, (cx, cy, counts, x_te, y_te), schedule


def _run_static(fl_setup, backend, replan):
    model, cfg, data, schedule = fl_setup
    policy = make_policy("adel", cfg, schedule=schedule, device="cpu")
    _, hist = run_federated(model, policy, cfg, *data, seed=0,
                            backend=backend, device="cpu",
                            chunk_size=3 if backend == "chunked" else None,
                            replan=replan)
    return hist


def _ref_run_static(fl_setup, replan):
    model, cfg, data, schedule = fl_setup
    ref_cfg = RefConfig.default(U=U, L=model.L, R=R,
                                T_max=R * model.L * 0.5, eta0=2.0, seed=0)
    policy = ref_make_policy("adel", ref_cfg,
                             schedule=_ref_schedule(schedule))
    _, hist = ref_run_federated(ref_make_mlp(), policy, ref_cfg,
                                *map(jnp.asarray, data),
                                key=jax.random.PRNGKey(0), replan=replan)
    return hist


@pytest.mark.parametrize("backend", ["dense", "chunked", "shard_map"])
def test_replan_never_bit_for_bit(fl_setup, backend):
    """trigger="never" does not perturb the run at all: the same History,
    every field, exact floats, as a run without the replan machinery."""
    base = _run_static(fl_setup, backend, None)
    never = _run_static(fl_setup, backend, ReplanConfig())
    assert base.as_dict() == never.as_dict()
    assert never.replans == []


def test_every_k_static_run_respects_budget(fl_setup):
    """every-k re-solves on a static population: the events equal the
    reference's (the trigger and budget read only the planned clock), and
    the re-solved schedule lands on the R2 budget."""
    model, cfg, data, schedule = fl_setup
    hist = _run_static(fl_setup, "dense",
                       ReplanConfig(trigger="every-k", every=2, steps=150))
    assert len(hist.replans) >= 1
    for ev in hist.replans:
        assert set(ev) >= {"round", "reachable", "U_est", "T_tail", "m",
                           "objective", "budget_left"}
        assert ev["reachable"] == U            # static population
    np.testing.assert_allclose(hist.times[-1], cfg.T_max, rtol=1e-4)
    ref = _ref_run_static(fl_setup, RefReplanConfig(trigger="every-k",
                                                    every=2, steps=150))
    _assert_events_match(hist.replans, ref.replans)
    np.testing.assert_allclose(hist.times, ref.times, rtol=RTOL)


def _skippy_run(fl_setup, pkg):
    """A run whose round 1 has an empty cohort, on ``pkg``'s runtime."""
    model, cfg, data, schedule = fl_setup
    cx, cy, counts, x_te, y_te = data
    if pkg == "port":
        class Skippy(StaticCohortSource):
            def round_cohort(self, t):
                return None if t == 1 else super().round_cohort(t)

        policy = make_policy("adel", cfg, schedule=schedule, device="cpu")
        _, hist = RoundRuntime(model, policy, device="cpu").run(
            Skippy(cx, cy, counts, device="cpu"), rounds=cfg.R,
            T_max=cfg.T_max, eta=cfg.eta, s_max=16, seed=0,
            test_x=x_te, test_y=y_te,
            replan=ReplanConfig(trigger="drift", drift_threshold=10.0,
                                steps=120))
        return policy, hist

    class RefSkippy(RefStaticSource):
        def round_cohort(self, t):
            return None if t == 1 else super().round_cohort(t)

    ref_cfg = RefConfig.default(U=U, L=model.L, R=R,
                                T_max=R * model.L * 0.5, eta0=2.0, seed=0)
    policy = ref_make_policy("adel", ref_cfg,
                             schedule=_ref_schedule(schedule))
    _, hist = RefRuntime(ref_make_mlp(), policy).run(
        RefSkippy(*map(jnp.asarray, (cx, cy, counts))), rounds=cfg.R,
        T_max=cfg.T_max, eta=cfg.eta, s_max=16, key=jax.random.PRNGKey(0),
        test_x=jnp.asarray(x_te), test_y=jnp.asarray(y_te),
        replan=RefReplanConfig(trigger="drift", drift_threshold=10.0,
                               steps=120))
    return policy, hist


def test_skipped_round_budget_credited(fl_setup):
    """An empty-cohort round spends nothing: its planned deadline is
    credited back (zeroed in the schedule's head) and a re-solve is FORCED
    at the next executed round, whose budget_left includes the credit;
    the event equals the reference's."""
    model, cfg, data, schedule = fl_setup
    planned = np.asarray(schedule.T).copy()
    policy, hist = _skippy_run(fl_setup, "port")
    assert len(hist.replans) == 1
    ev = hist.replans[0]
    assert ev["round"] == 2
    np.testing.assert_allclose(ev["skipped_credit"], planned[1], rtol=1e-6)
    assert float(policy.schedule.T[1]) == 0.0
    np.testing.assert_allclose(ev["budget_left"], cfg.T_max - planned[0],
                               rtol=1e-5)
    np.testing.assert_allclose(np.sum(ev["T_tail"]), ev["budget_left"],
                               rtol=1e-4)
    assert hist.rounds == [1, 3, 4, 5]
    _, ref_hist = _skippy_run(fl_setup, "ref")
    _assert_events_match(hist.replans, ref_hist.replans)
    assert hist.rounds == ref_hist.rounds


def _fleet_inputs(n, alpha, pkg):
    mk = make_fleet if pkg == "port" else ref_make_fleet
    part = partition_fleet if pkg == "port" else ref_partition_fleet
    x_tr, y_tr, x_te, y_te = make_image_dataset(
        "mnist", n_train=800, n_test=200, seed=0, noise_std=1.0)
    return mk, part(x_tr, y_tr, x_te, y_te, n, alpha=alpha, seed=0)


def test_fleet_drift_replan_records_and_respects_budget():
    """Drift-triggered re-solves against a synchronized diurnal fleet: the
    events equal the reference's (the availability draws are the same
    numpy), every tail is feasible, and the budget is never overdrawn."""
    n, rounds = 120, 8
    akw = dict(mean=0.45, amplitude=0.4, period=8.0, phase_spread=0.5)
    kw = dict(method="adel", rounds=rounds, cohort_size=24, chunk_size=12,
              solver_steps=100, seed=0)
    mk, data = _fleet_inputs(n, 0.5, "port")
    _, hist = run_fleet(make_mlp(), mk("longtail-mobile", n, seed=0),
                        make_availability("diurnal", n, seed=0, **akw), data,
                        replan=ReplanConfig(trigger="drift",
                                            drift_threshold=0.3, steps=100),
                        device="cpu", **kw)
    assert len(hist.replans) >= 1
    for ev in hist.replans:
        assert 2 <= ev["U_est"] <= 24
        tail = np.asarray(ev["T_tail"])
        assert np.all(np.diff(tail) <= 1e-5)
        np.testing.assert_allclose(tail.sum(), ev["budget_left"], rtol=1e-4)
    assert hist.times[-1] <= rounds * make_mlp().L * 0.5 * 1.001
    mk, data = _fleet_inputs(n, 0.5, "ref")
    with pytest.warns(DeprecationWarning):
        _, ref_hist = ref_run_fleet(
            ref_make_mlp(), mk("longtail-mobile", n, seed=0),
            ravail.make_availability("diurnal", n, seed=0, **akw), data,
            replan=RefReplanConfig(trigger="drift", drift_threshold=0.3,
                                   steps=100), **kw)
    _assert_events_match(hist.replans, ref_hist.replans)
    assert hist.available == ref_hist.available
    assert hist.rounds == ref_hist.rounds


def test_fleet_replan_requires_adel():
    n = 60
    mk, data = _fleet_inputs(n, None, "port")
    with pytest.raises(ValueError, match="adel"):
        run_fleet(make_mlp(), mk("uniform", n, seed=0),
                  make_availability("always-on", n), data, method="salf",
                  rounds=2, cohort_size=8, replan="drift", seed=0,
                  device="cpu")
