"""The port's pipelined round driver (``ExecSpec.pipeline="prefetch"``), the
port of ``tests/test_pipeline.py``.

The one-round lookahead speculates only on host-deterministic phases, so
its trajectories must be BIT-identical to serial on every port backend:
``History.as_dict()`` equal and params equal under ``torch.equal``, with
the chunked (3), shard_map (one shard), temporal, buffered (``lam=0.5``:
the carry ring banking and folding) and hierarchical (3 regions) backends
on their stateful paths, and across a skipped round and the re-solve it
forces (both plan the next round inline). The pipeline counters
(``prefetch_rounds`` / ``prefetch_overlap_s`` / ``dispatch_wait_s`` /
``warm_up_s``) and the ``warm_up`` span land in the event stream under
prefetch and not under serial; ``History`` holds plain floats once ``run``
returns.
"""
import argparse

import pytest
import torch

from repro_torch import obs
from repro_torch.core.baselines import RoundPlan, make_policy
from repro_torch.core.replan import ReplanConfig
from repro_torch.core.scheduler import solve
from repro_torch.core.types import AnalysisConfig
from repro_torch.data.synthetic import make_image_dataset
from repro_torch.fl.backends import make_backend
from repro_torch.fl.partition import dirichlet_partition, stack_clients
from repro_torch.fl.runtime import (DeviceRatio, RoundRuntime,
                                    StaticCohortSource, _round_context,
                                    eval_metrics, evaluate)
from repro_torch.fl.server import run_federated
from repro_torch.fl.spec import ExecSpec
from repro_torch.models.paper_models import make_mlp
from repro_torch.tree import tree_leaves

R = 4
U = 8

# every port backend, with the knobs that exercise its stateful paths: the
# chunked backend padding (8 -> 9), the buffered carry ring banking
# (lam > 0), the hierarchical split actually splitting (regions > 1, no
# population ids)
BACKEND_SPECS = [
    dict(backend="dense"),
    dict(backend="chunked", chunk_size=3),
    dict(backend="shard_map"),
    dict(backend="temporal"),
    dict(backend="buffered", lam=0.5, max_age=3, buffer_cap=3),
    dict(backend="hierarchical", regions=3),
]


@pytest.fixture(scope="module")
def setup():
    x_tr, y_tr, x_te, y_te = make_image_dataset(
        "mnist", n_train=400, n_test=100, seed=0, noise_std=1.0)
    parts = dirichlet_partition(y_tr, U, alpha=0.5, seed=0)
    cx, cy, counts = stack_clients(x_tr, y_tr, parts)
    model = make_mlp()
    cfg = AnalysisConfig.default(U=U, L=model.L, R=R, T_max=R * model.L * 0.5,
                                 eta0=2.0, seed=0)
    schedule = solve(cfg, "adam", steps=100, device="cpu")
    return model, cfg, (cx, cy, counts, x_te, y_te), schedule


def _run(setup, pipeline, backend_kw, tracer=None, method="adel", **kw):
    model, cfg, data, schedule = setup
    policy = make_policy(method, cfg, device="cpu",
                         schedule=schedule if method == "adel" else None)
    return run_federated(model, policy, cfg, *data, seed=0,
                         exec=ExecSpec(pipeline=pipeline, **backend_kw),
                         tracer=tracer, device="cpu", **kw)


def _assert_bit_identical(a, b):
    (pa, ha), (pb, hb) = a, b
    # the whole History, exact: clock, plans, accuracy, losses
    assert ha.as_dict() == hb.as_dict()
    for x, y in zip(tree_leaves(pa), tree_leaves(pb)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("backend_kw", BACKEND_SPECS,
                         ids=[s["backend"] for s in BACKEND_SPECS])
def test_prefetch_bit_identical_to_serial(setup, backend_kw):
    _assert_bit_identical(_run(setup, "serial", backend_kw),
                          _run(setup, "prefetch", backend_kw))


@pytest.mark.parametrize("method,comp", [("heterofl", None), ("adel", "int8"),
                                         ("salf", None)],
                         ids=["heterofl", "int8", "salf"])
def test_prefetch_bit_identical_other_rules(setup, method, comp):
    """HeteroFL (width masks from the live params on the main thread), the
    int8 wire, and a fixed-deadline baseline."""
    kw = dict(backend="chunked", chunk_size=3, compression=comp)
    _assert_bit_identical(_run(setup, "serial", kw, method=method),
                          _run(setup, "prefetch", kw, method=method))


def test_prefetch_stops_at_the_budget_like_serial(setup):
    """A budget that runs out before R: the prefetched plan of the round
    that would overrun stops the run where serial stops."""
    model, cfg, data, schedule = setup
    T_half = float(sum(schedule.T[:2])) + 1e-3
    cut = AnalysisConfig.default(U=U, L=model.L, R=R, T_max=T_half,
                                 eta0=2.0, seed=0)
    policy = make_policy("adel", cut, schedule=schedule, device="cpu")
    out = [run_federated(model, policy, cut, *data, seed=0, device="cpu",
                         exec=ExecSpec(pipeline=pipe))
           for pipe in ("serial", "prefetch")]
    assert out[0][1].rounds == [1, 2]
    _assert_bit_identical(*out)


def test_history_holds_plain_floats(setup):
    """The pending evals are converted by the time run() returns —
    consumers json-serialize History as-is."""
    for pipeline in ("serial", "prefetch"):
        _, hist = _run(setup, pipeline, dict(backend="dense"))
        assert all(type(v) is float for v in hist.accuracy)
        assert all(type(v) is float for v in hist.train_loss)


def test_eval_stays_on_the_device_until_converted(setup):
    """evaluate keeps the int64 correct-count (no sync); float() divides
    in Python's double, as a blocking eval would."""
    model, _, data, _ = setup
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    x, y = torch.as_tensor(data[3]), torch.as_tensor(data[4])
    acc, loss = eval_metrics(model, params, x, y)
    assert isinstance(acc, DeviceRatio) and acc.count.dtype == torch.int64
    assert isinstance(loss, torch.Tensor) and loss.dim() == 0
    correct = int((model.predict(params, x).argmax(-1) == y).sum())
    assert float(acc) == correct / len(y)
    assert float(evaluate(model, params, x, y, batch=7)) == float(acc)


def test_on_round_sees_converted_history(setup):
    seen = []

    def on_round(t, params, hist):
        seen.append([type(v) for v in hist.accuracy + hist.train_loss])

    _run(setup, "prefetch", dict(backend="dense"), on_round=on_round)
    assert len(seen) == R and all(t is float for row in seen for t in row)


def test_prefetch_counters_and_warmup(setup):
    """A traced prefetch run records the pipeline counters, the warm_up
    span, and one prefetched round per lookahead; the worker's planner
    spans are emitted on the main thread with the right round stamp."""
    sink = obs.MemorySink()
    _, hist = _run(setup, "prefetch", dict(backend="dense"),
                   tracer=obs.Tracer(sink))
    c = hist.telemetry["counters"]
    assert c["h2d_bytes"] > 0
    assert c["warm_up_s"] > 0
    assert c["prefetch_rounds"] == R - 1        # round 0 planned inline
    assert c["prefetch_overlap_s"] > 0
    assert "dispatch_wait_s" in c
    assert "warm_up" in hist.telemetry["phases"]
    spans = [r for r in sink.records if r.get("kind") == "span"]
    assert {r["name"] for r in spans} >= {"warm_up", "cohort", "plan",
                                          "stack", "eval"}
    plan_rounds = sorted({r["round"] for r in spans if r["name"] == "plan"})
    assert plan_rounds == list(range(1, R + 1))
    # the warm-up's dummy round recorded nothing of its own
    assert hist.telemetry["phases"]["local_train"]["count"] == R
    assert len(hist.telemetry["ledger"]) == R


def test_serial_counters_absent(setup):
    """Serial mode never engages the prefetcher or the warm-up."""
    _, hist = _run(setup, "serial", dict(backend="dense"),
                   tracer=obs.Tracer(obs.MemorySink()))
    c = hist.telemetry["counters"]
    assert "prefetch_rounds" not in c
    assert "warm_up_s" not in c
    assert c["h2d_bytes"] > 0            # the stacked-bytes counter is
    assert "warm_up" not in hist.telemetry["phases"]   # mode-independent


@pytest.mark.parametrize("backend_kw", BACKEND_SPECS,
                         ids=[s["backend"] for s in BACKEND_SPECS])
def test_warm_up_leaves_state_and_counters_as_found(setup, backend_kw):
    """The warm-up runs the real round on zero params, draws nothing,
    records nothing, and leaves the backend's state as it found it."""
    model, cfg, data, schedule = setup
    spec = ExecSpec(**backend_kw)
    bk = make_backend(exec=spec, model=model, device="cpu")
    sink = obs.MemorySink()
    bk.set_tracer(obs.Tracer(sink))
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    gen = torch.Generator().manual_seed(1)
    Up = bk.cohort_pad(U)
    xb = torch.randn((Up, 4, 28, 28, 1), generator=gen)
    yb = torch.randint(0, 10, (Up, 4), generator=gen)
    wb = torch.full((Up, 4), 0.25)
    mask = torch.ones((Up, model.L))
    mask[1:3, 0] = 0.0                   # stragglers: the ring banks
    p = torch.zeros(model.L)
    plan = RoundPlan(mask=mask, p=p, batch_sizes=torch.full((Up,), 4.0),
                     elapsed=1.0, bias_correct=True)
    ctx = (_round_context(0, 0.0, plan, cfg, Up)
           if getattr(bk, "needs_ctx", False) else None)
    bk.last_regions = {"regions": 9}    # what a previous round left
    found = dict(vars(bk))
    state = torch.random.get_rng_state()
    assert bk.warm_up(params, xb, yb, wb, mask, p, 0.5, ctx=ctx) > 0
    assert torch.equal(torch.random.get_rng_state(), state)
    assert sink.records == []
    assert vars(bk) == found
    assert bk._bytes_cache == {}
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(params),
        tree_leaves(model.init(torch.Generator().manual_seed(0), "cpu"))))


def test_prefetch_skip_and_forced_replan(setup):
    """An empty-cohort round and the skip-forced re-solve at the next
    executed round (both change the planning state) leave the prefetched
    trajectory bit-identical: the loop plans the round after a skip or a
    replan inline."""
    model, cfg, data, schedule = setup
    cx, cy, counts, x_te, y_te = data

    class SkippySource(StaticCohortSource):
        def round_cohort(self, t):
            return None if t == 1 else super().round_cohort(t)

    def run(pipeline):
        policy = make_policy("adel", cfg, schedule=schedule, device="cpu")
        runtime = RoundRuntime(model, policy, device="cpu",
                               exec=ExecSpec(pipeline=pipeline))
        return runtime.run(
            SkippySource(cx, cy, counts, device="cpu"), rounds=cfg.R,
            T_max=cfg.T_max, eta=cfg.eta, s_max=16, seed=0,
            test_x=x_te, test_y=y_te,
            replan=ReplanConfig(trigger="drift", drift_threshold=10.0,
                                steps=80))

    a, b = run("serial"), run("prefetch")
    _assert_bit_identical(a, b)
    # the scenario exercised both fallback paths
    hist = a[1]
    assert len(hist.replans) == 1 and hist.replans[0]["round"] == 2
    assert hist.rounds == [1, 3, 4]


def test_exec_spec_pipeline_validation_and_cli():
    with pytest.raises(ValueError):
        ExecSpec(pipeline="bogus")
    ap = argparse.ArgumentParser()
    ExecSpec.add_cli_args(ap)
    args = ap.parse_args(["--pipeline", "prefetch"])
    assert ExecSpec.from_cli(args).pipeline == "prefetch"
    assert ExecSpec.from_cli(ap.parse_args([])).pipeline == "serial"
    help_text = ap.format_help()
    assert "prefetch" in help_text and "not ported" not in help_text.split(
        "--pipeline")[1].split("--")[0]


# ---------------------------------------------------------------------------
# the LM at torch's default intra-op thread count (ROADMAP 3.3)
# ---------------------------------------------------------------------------

LM_REPEATS = 3


def _lm_run(pipeline):
    from repro_torch.launch.train import run_training
    return run_training("qwen1.5-4b", rounds=3, tmax=15.0, U=4, seq=16,
                        n_seq=24, eta0=1.0, seed=0, solver_steps=200,
                        exec=ExecSpec(backend="dense", pipeline=pipeline),
                        eval_every=1, verbose=False, device="cpu")


def test_lm_prefetch_bit_identical_to_serial_repeatedly():
    """The reduced-qwen LM run, serial then alternately prefetch and serial
    ``LM_REPEATS`` times in one process, each bit-identical to the first.
    The embedding's backward once summed a repeated token's rows in thread
    order, so both loops drifted in the last bits from run to run."""
    serial = _lm_run("serial")
    for i in range(LM_REPEATS):
        _assert_bit_identical(serial,
                              _lm_run("prefetch" if i % 2 == 0 else "serial"))


def test_lm_client_grads_repeat_bit_for_bit():
    """``vmap(grad)`` of the reduced-qwen loss over 3 clients whose rows
    repeat tokens, 4 times: every gradient bit-identical to the first."""
    from repro_torch.configs import get_config
    from repro_torch.fl.tasks import make_lm_model

    model = make_lm_model(get_config("qwen1.5-4b").reduced())
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    x = torch.randint(0, 16, (3, 4, 17), generator=torch.Generator()
                      .manual_seed(1), dtype=torch.int32)
    y = torch.zeros((3, 4), dtype=torch.int32)
    w = torch.full((3, 4), 0.25)
    grad = torch.func.vmap(torch.func.grad(model.loss),
                           in_dims=(None, 0, 0, 0))
    first = tree_leaves(grad(params, x, y, w))
    for _ in range(3):
        for a, b in zip(first, tree_leaves(grad(params, x, y, w))):
            assert torch.equal(a, b)
