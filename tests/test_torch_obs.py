"""The port's telemetry (``repro_torch.obs``): the ports of
``tests/test_obs.py``'s cases (span invariants, the summary, phase order,
the inert null tracer, tracing-on == tracing-off trajectories on every port
backend, the ledger math, sinks and the timeline renderer), and one run's
ledger rows against the reference's under the reference's own draws.

Ledger rows against the reference: every planned and simulated field
exactly equal (the plans are equal given the same draws, and the ledger's
numpy math is the same code); ``p1_pred`` rtol 1e-5 (the exact
zero-contributor probabilities agree to rtol 1e-5,
``tests/test_torch_core.py``); wall times are each run's own.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as robs
from repro.core.baselines import make_policy as ref_make_policy
from repro.core.types import AnalysisConfig as RefConfig
from repro.core.types import Schedule as RefSchedule
from repro.fl.server import run_federated as ref_run_federated
from repro.models.paper_models import make_mlp as ref_make_mlp
from repro_torch import obs
from repro_torch.convert import params_from_jax
from repro_torch.core.baselines import make_policy
from repro_torch.core.scheduler import solve
from repro_torch.core.types import AnalysisConfig
from repro_torch.data.synthetic import make_image_dataset
from repro_torch.fl.partition import dirichlet_partition, stack_clients
from repro_torch.fl.server import run_federated
from repro_torch.models.paper_models import make_mlp
from repro_torch.obs.ledger import drift_summary, expected_depth, phase_table
from repro_torch.obs.timeline import load_events, render
from test_torch_fl import ReferenceDraws

ROOT = Path(__file__).resolve().parents[1]
R = 4
U = 6


@pytest.fixture(scope="module")
def setup():
    x_tr, y_tr, x_te, y_te = make_image_dataset(
        "mnist", n_train=400, n_test=120, seed=0, noise_std=1.0)
    parts = dirichlet_partition(y_tr, U, alpha=0.5, seed=0)
    cx, cy, counts = stack_clients(x_tr, y_tr, parts)
    model = make_mlp()
    cfg = AnalysisConfig.default(U=U, L=model.L, R=R, T_max=R * model.L * 0.5,
                                 eta0=2.0, seed=0)
    schedule = solve(cfg, "adam", steps=60, device="cpu")
    return model, cfg, (cx, cy, counts, x_te, y_te), schedule


def _run(setup, backend, tracer=None, chunk_size=None, **kw):
    model, cfg, data, schedule = setup
    policy = make_policy("adel", cfg, schedule=schedule, device="cpu")
    if chunk_size is None and backend == "chunked":
        chunk_size = 3
    _, hist = run_federated(model, policy, cfg, *data, seed=0,
                            backend=backend, chunk_size=chunk_size,
                            tracer=tracer, device="cpu", **kw)
    return hist


# ---------------------------------------------------------------------------
# span mechanics
# ---------------------------------------------------------------------------

def test_span_nesting_and_ordering():
    """Spans record depth, enclosing parent, and a monotone sequence."""
    clock = iter(np.arange(0.0, 100.0, 0.5))
    sink = obs.MemorySink()
    tr = obs.Tracer(sink, clock=lambda: float(next(clock)))
    tr.set_round(1)
    with tr.span("plan"):
        with tr.span("stack"):
            pass
        with tr.span("local_train", backend="dense"):
            pass
    with tr.span("eval"):
        pass
    spans = [r for r in sink.records if r["kind"] == "span"]
    by_name = {r["name"]: r for r in spans}
    assert [r["name"] for r in spans] == ["stack", "local_train", "plan",
                                          "eval"]
    assert by_name["stack"]["parent"] == "plan"
    assert by_name["local_train"]["parent"] == "plan"
    assert by_name["local_train"]["backend"] == "dense"
    assert by_name["plan"]["parent"] is None
    assert by_name["stack"]["depth"] == 1
    assert by_name["plan"]["depth"] == 0
    seqs = [r["seq"] for r in spans]
    assert seqs == sorted(seqs) and len(set(seqs)) == len(seqs)
    assert by_name["stack"]["dur_s"] == pytest.approx(0.5)
    assert by_name["local_train"]["dur_s"] == pytest.approx(0.5)
    assert by_name["plan"]["dur_s"] == pytest.approx(2.5)
    assert all(r["round"] == 1 for r in spans)


def test_tracer_summary_aggregates():
    tr = obs.Tracer()
    with tr.span("plan"):
        pass
    with tr.span("plan"):
        pass
    tr.count("batch_elements_real", 10)
    tr.count("batch_elements_real", 5)
    tr.gauge("cohort_size", 8)
    s = tr.summary()
    assert s["phases"]["plan"]["count"] == 2
    assert s["counters"]["batch_elements_real"] == 15
    assert s["gauges"]["cohort_size"] == 8.0
    json.dumps(s)  # summary must be JSON-clean


def test_tree_bytes_counts_tensor_leaves():
    tree = [{"w": torch.zeros(3, 4), "b": torch.zeros(4, dtype=torch.int8)},
            (torch.zeros(2, dtype=torch.bfloat16), 7)]
    assert obs.tree_bytes(tree) == 48 + 4 + 4


def test_phase_order_within_round(setup):
    """Every round's top-level spans appear in the canonical phase order
    (cohort -> plan -> stack -> local_train -> aggregate -> eval)."""
    sink = obs.MemorySink()
    _run(setup, "dense", tracer=obs.Tracer(sink))
    order = {p: i for i, p in enumerate(obs.PHASES)}
    for rnd in range(1, R + 1):
        names = [r["name"] for r in sink.records
                 if r["kind"] == "span" and r["round"] == rnd
                 and r["depth"] == 0]
        assert names, f"round {rnd} recorded no spans"
        assert [n for n in names if n in order] == names
        idx = [order[n] for n in names]
        assert idx == sorted(idx), f"round {rnd} phases out of order: {names}"
        assert {"cohort", "plan", "stack", "local_train", "aggregate",
                "eval"} <= set(names)


# ---------------------------------------------------------------------------
# NullTracer: zero-overhead default
# ---------------------------------------------------------------------------

def test_null_tracer_api_is_inert():
    null = obs.NULL_TRACER
    assert null.active is False
    with null.span("anything", junk=1) as sp:
        assert sp is not None
    null.set_round(3)
    null.count("x")
    null.gauge("y", 1.0)
    null.event("round", t=0)
    null.span_record("plan", 0.0, 1.0)
    assert null.summary() == {}
    null.close()


# ---------------------------------------------------------------------------
# tracing on == tracing off, every backend
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["dense", "chunked", "temporal",
                                     "hierarchical"])
def test_tracing_preserves_trajectories(setup, backend):
    """Identical History with tracing on vs off — telemetry must never
    touch the draws or numerics, on any execution backend."""
    base = _run(setup, backend, tracer=None)
    traced = _run(setup, backend, tracer=obs.Tracer(obs.MemorySink()))
    a, b = base.as_dict(), traced.as_dict()
    tel = b.pop("telemetry")
    assert a.pop("telemetry") == {}
    assert a == b
    assert tel["phases"]["local_train"]["count"] >= len(traced.rounds)
    assert tel["phases"]["aggregate"]["count"] >= len(traced.rounds)
    assert len(tel["ledger"]) == len(traced.rounds)
    assert tel["counters"]["batch_elements_real"] > 0
    assert tel["counters"]["h2d_bytes"] > 0
    assert tel["gauges"]["cohort_size"] == U
    if backend == "hierarchical":
        assert all(r["regions"] == 4 for r in tel["ledger"])


def test_chunked_splits_train_and_aggregate(setup):
    """Each chunk's local update and partial fold, and the final update,
    are separate spans."""
    sink = obs.MemorySink()
    _run(setup, "chunked", tracer=obs.Tracer(sink), chunk_size=2)
    spans = [r for r in sink.records if r["kind"] == "span"
             and r["round"] == 1]
    train = [r for r in spans if r["name"] == "local_train"]
    agg = [r for r in spans if r["name"] == "aggregate"]
    assert [r["chunk"] for r in train] == [0, 1, 2]
    assert [r.get("chunk") for r in agg] == [0, 1, 2, None]
    assert agg[-1]["chunks"] == 3


# ---------------------------------------------------------------------------
# ledger math
# ---------------------------------------------------------------------------

def test_expected_depth_exact():
    assert expected_depth(np.asarray([0.0]), 5)[0] == pytest.approx(0.0)
    assert expected_depth(np.asarray([1e-4]), 5)[0] == pytest.approx(
        1e-4, rel=1e-3)
    assert expected_depth(np.asarray([200.0]), 5)[0] == pytest.approx(
        5.0, abs=1e-6)
    rng = np.random.default_rng(0)
    for lam, L in ((0.7, 3), (2.5, 4), (6.0, 8)):
        mc = np.minimum(rng.poisson(lam, size=200_000), L).mean()
        assert expected_depth(np.asarray([lam]), L)[0] == pytest.approx(
            mc, abs=0.02)


def test_drift_summary_fields():
    rows = [{"T_deadline": 1.0, "sim_round": 1.0, "wall_round_s": 0.5,
             "cohort": 4, "missed": 2, "zero_contrib": 1,
             "depth_real": 1.5, "depth_pred": 1.0, "p1_pred": 0.1,
             "layer1_zero": False, "pred_full_s": 2.0}] * 3
    d = drift_summary(rows)
    assert d["rounds"] == 3
    assert d["depth_drift_mean"] == pytest.approx(0.5)
    assert d["miss_rate"] == pytest.approx(0.5)
    assert d["zero_rate"] == pytest.approx(0.25)
    assert d["wall_per_sim_mean"] == pytest.approx(0.5)
    assert d["deadline_vs_full_wait"] == pytest.approx(0.5)
    assert drift_summary([]) == {}


def test_ledger_rows_in_real_run(setup):
    sink = obs.MemorySink()
    hist = _run(setup, "dense", tracer=obs.Tracer(sink))
    model = setup[0]
    rows = [r for r in sink.records if r.get("kind") == "round"]
    assert len(rows) == len(hist.rounds)
    for r in rows:
        assert r["cohort"] == U
        assert 0.0 <= r["depth_real"] <= model.L
        assert r["full"] + r["missed"] == r["cohort"]
        assert "depth_pred" in r and "pred_full_s" in r
        assert r["T_deadline"] < r["pred_full_s"]
    assert [r["sim_total"] for r in rows] == pytest.approx(hist.times)


_WALL = ("wall_round_s", "wall_total_s")


def test_ledger_rows_match_reference_under_same_draws(setup):
    """One run's ledger rows — planned deadline, simulated clock, straggler
    census and the model's predicted depths — equal the reference's."""
    model, cfg, data, sched = setup
    ref_cfg = RefConfig.default(U=U, L=model.L, R=R,
                                T_max=R * model.L * 0.5, eta0=2.0, seed=0)
    ref_sched = RefSchedule(T=sched.T, m=sched.m, objective=sched.objective,
                            p1=sched.p1)
    ref_model = ref_make_mlp()
    rsink = robs.MemorySink()
    ref_run_federated(ref_model, ref_make_policy("adel", ref_cfg,
                                                 schedule=ref_sched),
                      ref_cfg, *map(jnp.asarray, data),
                      key=jax.random.PRNGKey(0), tracer=robs.Tracer(rsink))
    draws = ReferenceDraws(0, R, ref_sched.T, ref_sched.m, ref_cfg)
    init = params_from_jax(jax.tree.map(np.asarray,
                                        ref_model.init(draws.k_init)), "cpu")
    sink = obs.MemorySink()
    run_federated(model, make_policy("adel", cfg, schedule=sched,
                                     device="cpu"), cfg, *data, draws=draws,
                  init_params=init, tracer=obs.Tracer(sink), device="cpu")
    ref_rows = robs.ledger_rows(rsink.records)
    rows = obs.ledger_rows(sink.records)
    assert len(rows) == len(ref_rows) == R
    for r, q in zip(rows, ref_rows):
        assert set(r) == set(q)
        p1, q1 = r.pop("p1_pred"), q.pop("p1_pred")
        assert p1 == pytest.approx(q1, rel=1e-5)
        assert ({k: v for k, v in r.items() if k not in _WALL}
                == {k: v for k, v in q.items() if k not in _WALL})


# ---------------------------------------------------------------------------
# sinks + timeline renderer
# ---------------------------------------------------------------------------

def test_jsonl_sink_and_timeline(tmp_path, setup):
    path = os.path.join(tmp_path, "events", "run.jsonl")
    tr = obs.make_tracer(path)
    assert tr.active
    _run(setup, "chunked", tracer=tr, compression="int8")
    tr.close()
    records = load_events(path)
    assert records and any(r["kind"] == "round" for r in records)
    assert phase_table(records)
    text = render(records, title="run")
    for section in ("phase timeline", "clock-model ledger",
                    "stragglers / deadline misses", "drift summary",
                    "aggregation payload", "pipeline"):
        assert section in text, section
    # the module's command line renders the same stream
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.obs.timeline",
                           path], capture_output=True, text=True, env=env,
                          timeout=120, check=True)
    assert proc.stdout.startswith(f"== {path} ==")
    assert "clock-model ledger" in proc.stdout


def test_load_events_skips_torn_lines(tmp_path):
    p = os.path.join(tmp_path, "torn.jsonl")
    with open(p, "w") as f:
        f.write(json.dumps({"kind": "span", "name": "plan", "round": 1,
                            "dur_s": 0.1}) + "\n")
        f.write('{"kind": "round", "t": 0, "T_dead')   # crashed mid-write
    recs = load_events(p)
    assert len(recs) == 1 and recs[0]["name"] == "plan"


def test_make_tracer_defaults_to_null():
    assert obs.make_tracer() is obs.NULL_TRACER
    assert obs.make_tracer(None) is obs.NULL_TRACER
    sink = obs.MemorySink()
    tr = obs.make_tracer(sinks=sink)
    assert isinstance(tr, obs.Tracer) and tr.sinks == [sink]
