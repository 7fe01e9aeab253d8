"""The port's execution backends (``repro_torch.fl.backends``) and
``ExecSpec``: the ports of ``tests/test_backends.py``'s cases
(``shard_map`` runs here as one shard; its multi-rank cases are in
``tests/test_torch_shard_map.py``; the buffered backend's own cases are in
``tests/test_torch_buffered.py``), run on the port's own draws, plus one
round of each backend against the REFERENCE's same backend on the same
inputs, and the byte counters' totals against the reference's.

Tolerances: run against run, those of ``tests/test_backends.py``
(accuracy atol 0.015, loss rtol/atol 0.02; int8 drift 0.02); one round
against the reference's same backend, rtol 1e-4 / atol 1e-6 (XLA-CPU and
ATen sum in different orders), plus, under int8, one quantization step of
every client (a delta on a rounding boundary may quantize one code apart),
as ``tests/test_torch_round.py``; byte counters exactly equal (both
packages count ``payload_bytes`` analytically).
"""
import argparse
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as robs
from repro.core.baselines import make_policy as ref_make_policy
from repro.core.types import AnalysisConfig as RefConfig
from repro.core.types import Schedule as RefSchedule
from repro.fl import backends as rbk
from repro.fl.server import run_federated as ref_run_federated
from repro.models import paper_models as rpm
from repro_torch import obs
from repro_torch.convert import params_from_jax
from repro_torch.core.aggregation import layer_coefficients
from repro_torch.core.baselines import make_policy
from repro_torch.core.compression import compress_deltas, make_compression
from repro_torch.core.scheduler import solve
from repro_torch.core.types import AnalysisConfig
from repro_torch.data.synthetic import make_image_dataset
from repro_torch.fl.backends import (BACKENDS, BufferedBackend,
                                     ChunkedBackend, DenseBackend,
                                     ExecSpec, HierarchicalBackend,
                                     ShardMapBackend, TemporalBackend,
                                     make_backend)
from repro_torch.fl.partition import dirichlet_partition, stack_clients
from repro_torch.fl.server import run_federated
from repro_torch.models import paper_models as ppm
from repro_torch.tree import tree_leaves

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


def _run(setup, method, backend, chunk_size=None, **kw):
    model, cfg, data, schedule = setup
    policy = make_policy(method, cfg,
                         schedule=schedule if method == "adel" else None,
                         device="cpu")
    if chunk_size is None and backend == "chunked":
        chunk_size = 3
    _, hist = run_federated(model, policy, cfg, *data, seed=0,
                            backend=backend, chunk_size=chunk_size,
                            device="cpu", **kw)
    return hist


def _assert_equivalent(a, b):
    # the simulated clock and plans are backend-independent — exact
    assert a.rounds == b.rounds
    np.testing.assert_allclose(a.deadlines, b.deadlines, rtol=1e-6)
    np.testing.assert_allclose(a.times, b.times, rtol=1e-6)
    # learning trajectories agree up to float summation order
    np.testing.assert_allclose(a.accuracy, b.accuracy, atol=0.015)
    np.testing.assert_allclose(a.train_loss, b.train_loss, rtol=0.02,
                               atol=0.02)


def _assert_bit_identical(a, b):
    assert a.rounds == b.rounds
    for f in ("deadlines", "times", "accuracy", "train_loss"):
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)))


@pytest.mark.parametrize("method", ["adel", "salf"])
def test_dense_vs_chunked(setup, method):
    """chunk_size=3 pads the 8-client cohort to 9 and runs 3 chunks."""
    _assert_equivalent(_run(setup, method, "dense"),
                       _run(setup, method, "chunked"))


@pytest.mark.parametrize("method", ["adel", "salf"])
def test_dense_vs_temporal(setup, method):
    """One client at a time into an f32 accumulator reproduces the vmapped
    dense aggregation."""
    _assert_equivalent(_run(setup, method, "dense"),
                       _run(setup, method, "temporal"))


@pytest.mark.parametrize("method", ["adel", "salf"])
def test_dense_vs_hierarchical(setup, method):
    """Four contiguous regions of two clients, summed against the global
    counts, reproduce the dense aggregation."""
    _assert_equivalent(_run(setup, method, "dense"),
                       _run(setup, method, "hierarchical"))


@pytest.mark.parametrize("method", ["adel", "salf"])
def test_hierarchical_one_region_bit_identical_to_dense(setup, method):
    _assert_bit_identical(
        _run(setup, method, "dense"),
        _run(setup, method, None, exec=ExecSpec(backend="hierarchical",
                                                regions=1)))


def test_heterofl_same_on_all_backends(setup):
    hists = [_run(setup, "heterofl", bk) for bk in BACKENDS]
    for h in hists[1:]:
        _assert_equivalent(hists[0], h)


def test_single_chunk_falls_through_to_dense(setup):
    """chunk_size >= cohort: the chunked backend reuses the dense step."""
    _assert_bit_identical(_run(setup, "salf", "dense"),
                          _run(setup, "salf", "chunked", chunk_size=U))


def test_backend_registry_and_padding():
    model = ppm.make_mlp()
    assert make_backend("dense", model, device="cpu").cohort_pad(10) == 10
    chunked = make_backend("chunked", model, chunk_size=8, device="cpu")
    assert chunked.cohort_pad(10) == 16
    assert chunked.cohort_pad(8) == 8      # single chunk, no dead padding
    assert chunked.cohort_pad(4) == 4      # chunk clipped to the cohort
    assert make_backend("chunked", model, chunk_size=3,
                        device="cpu").cohort_pad(8) == 9
    assert make_backend("temporal", model, device="cpu").cohort_pad(10) == 10
    assert make_backend("hierarchical", model,
                        device="cpu").cohort_pad(10) == 10
    # no process group: one shard, the reference's one-device mesh
    assert make_backend("shard_map", model, device="cpu").cohort_pad(10) == 10
    assert make_backend("buffered", model, device="cpu").cohort_pad(10) == 10
    for name, cls in [("dense", DenseBackend), ("chunked", ChunkedBackend),
                      ("shard_map", ShardMapBackend),
                      ("temporal", TemporalBackend),
                      ("buffered", BufferedBackend),
                      ("hierarchical", HierarchicalBackend)]:
        assert isinstance(make_backend(name, model, device="cpu"), cls)
    bk = DenseBackend(model, device="cpu")
    assert make_backend(bk, model) is bk
    with pytest.raises(ValueError):
        make_backend("nope", model, device="cpu")
    # the buffered backend builds with its staleness knobs; it reads the
    # round context only when it banks (lam > 0)
    buf = make_backend("buffered", model, lam=0.25, max_age=2,
                       device="cpu")
    assert (buf.lam, buf.max_age, buf.buffer_cap) == (0.25, 2, 4)
    assert buf.needs_ctx
    assert not make_backend("buffered", model, device="cpu").needs_ctx
    assert ExecSpec(pipeline="prefetch").pipeline == "prefetch"
    assert make_backend(exec=ExecSpec(backend="shard_map",
                                      pipeline="prefetch"),
                        model=model, device="cpu").describe()["shards"] == 1


def test_padded_rows_contribute_nothing(setup):
    """The runtime pads 8 clients to 9 for chunk_size 3 with zero rows; the
    same round with chunk_size 4 (no padding) agrees."""
    _assert_equivalent(_run(setup, "adel", "chunked", chunk_size=3),
                       _run(setup, "adel", "chunked", chunk_size=4))


# ---------------------------------------------------------------------------
# compressed wire payloads
# ---------------------------------------------------------------------------

# the reference's stated drift tolerance for compressed-vs-dense runs
COMPRESSED_ACC_TOL = 0.02


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_int8_compressed_drift_all_backends(setup, backend):
    base = _run(setup, "adel", "dense")
    comp = _run(setup, "adel", backend, compression="int8")
    assert comp.rounds == base.rounds
    np.testing.assert_allclose(comp.deadlines, base.deadlines, rtol=1e-6)
    np.testing.assert_allclose(comp.times, base.times, rtol=1e-6)
    np.testing.assert_allclose(comp.accuracy, base.accuracy,
                               atol=COMPRESSED_ACC_TOL)
    assert abs(comp.accuracy[-1] - base.accuracy[-1]) <= COMPRESSED_ACC_TOL


def test_compressed_backends_agree(setup):
    ref = _run(setup, "adel", "dense", compression="int8")
    for backend in ("chunked", "temporal", "hierarchical"):
        _assert_equivalent(ref, _run(setup, "adel", backend,
                                     compression="int8"))


def test_heterofl_rejects_compression(setup):
    for backend in BACKENDS:
        with pytest.raises(ValueError, match="HeteroFL"):
            _run(setup, "heterofl", backend, compression="int8")


def test_describe_reports_compression_and_agg_impl():
    model = ppm.make_mlp()
    d = make_backend("dense", model, compression="int8", agg_impl="pallas",
                     device="cpu").describe()
    assert d["compression"] == "int8" and d["agg_impl"] == "pallas"
    d = make_backend("chunked", model, device="cpu").describe()
    assert d["compression"] == "none" and d["agg_impl"] == "jnp"
    assert d["chunk_size"] == 16
    d = make_backend("hierarchical", model, regions=2, device="cpu").describe()
    assert d["backend"] == "hierarchical" and d["regions"] == 2


def _byte_totals(records):
    ctr = {}
    for r in records:
        if r.get("kind") == "count" and "bytes" in r.get("name", ""):
            ctr[r["name"]] = ctr.get(r["name"], 0) + r["value"]
    return ctr


@pytest.fixture(scope="module")
def ref_setup(setup):
    """The reference's side of ``setup``: the same data, config and the
    port's schedule."""
    model, cfg, data, schedule = setup
    ref_cfg = RefConfig.default(U=U, L=model.L, R=R, T_max=R * model.L * 0.5,
                                eta0=2.0, seed=0)
    ref_sched = RefSchedule(T=schedule.T, m=schedule.m,
                            objective=schedule.objective, p1=schedule.p1)
    return (rpm.make_mlp(), ref_cfg, tuple(map(jnp.asarray, data)),
            ref_sched)


# the reference's shard_map backend does not run under jax 0.9 (ROADMAP.md
# §3); the port's shard_map counters are held to dense's summed over ranks
# in tests/test_torch_shard_map.py
@pytest.mark.parametrize("backend", [b for b in BACKENDS if b != "shard_map"])
def test_compressed_byte_counters_match_reference(setup, ref_setup, backend):
    """Every port backend records the split logical/wire counters, with
    totals equal to the reference's same backend in the same run (chunked
    counts per padded chunk, hierarchical per region)."""
    model, cfg, data, schedule = setup
    kw = {"chunk_size": 3} if backend == "chunked" else {}
    sink = obs.MemorySink()
    run_federated(model, make_policy("adel", cfg, schedule=schedule,
                                     device="cpu"), cfg, *data, seed=0,
                  backend=backend, compression="int8",
                  tracer=obs.Tracer(sink), device="cpu", **kw)
    ctr = _byte_totals(sink.records)
    assert ctr["aggregate_bytes_logical"] / ctr["aggregate_bytes_wire"] > 3.5
    ref_model, ref_cfg, ref_data, ref_sched = ref_setup
    rsink = robs.MemorySink()
    ref_run_federated(ref_model, ref_make_policy("adel", ref_cfg,
                                                 schedule=ref_sched),
                      ref_cfg, *ref_data, key=jax.random.PRNGKey(0),
                      backend=backend, compression="int8",
                      tracer=robs.Tracer(rsink), **kw)
    assert ctr == _byte_totals(rsink.records)


def test_compressed_byte_counters_dense_equals_temporal(setup):
    totals = {}
    for backend in ("dense", "temporal"):
        sink = obs.MemorySink()
        model, cfg, data, schedule = setup
        run_federated(model, make_policy("adel", cfg, schedule=schedule,
                                         device="cpu"), cfg, *data, seed=0,
                      backend=backend, compression="int8",
                      tracer=obs.Tracer(sink), device="cpu")
        totals[backend] = _byte_totals(sink.records)
    assert totals["dense"] == totals["temporal"]


# ---------------------------------------------------------------------------
# one round against the reference's same backend
# ---------------------------------------------------------------------------

RU, S_MAX, ETA = 6, 6, 0.5
RATIOS = np.asarray([1.0, 0.5, 0.25, 0.125, 1.0, 0.5], np.float32)


def _round_inputs(rule):
    ref_model, model = rpm.make_mlp(), ppm.make_mlp()
    rng = np.random.default_rng(1)
    np_params = jax.tree.map(
        lambda a: (rng.standard_normal(a.shape)
                   / np.sqrt(max(np.prod(a.shape[:-1]), 1))).astype(a.dtype),
        jax.eval_shape(ref_model.init, jax.random.PRNGKey(0)))
    xb = rng.standard_normal((RU, S_MAX, 28, 28, 1)).astype(np.float32)
    yb = rng.integers(0, 10, (RU, S_MAX)).astype(np.int32)
    S = rng.integers(2, S_MAX + 1, RU)
    wb = ((np.arange(S_MAX)[None, :] < S[:, None]) / S[:, None]).astype(
        np.float32)
    if rule == "hetero":
        mask = np.repeat(np.asarray([[1], [1], [0], [1], [1], [0]],
                                    np.float32), model.L, axis=1)
        p = np.zeros(model.L, np.float32)
    else:
        mask = (rng.uniform(size=(RU, model.L)) > 0.3).astype(np.float32)
        mask[0] = 1.0
        p = rng.uniform(0.0, 0.2, model.L).astype(np.float32)
    return ref_model, model, np_params, (xb, yb, wb, mask, p)


@pytest.mark.parametrize("rule", ["none", "int8", "hetero"])
@pytest.mark.parametrize("backend", ["chunked", "temporal", "hierarchical"])
def test_one_round_matches_reference_backend(backend, rule):
    ref_model, model, np_params, arrays = _round_inputs(rule)
    comp = "int8" if rule == "int8" else None
    kw = dict(chunk_size=4) if backend == "chunked" else (
        dict(regions=2) if backend == "hierarchical" else {})
    hetero = rule == "hetero"
    bias_correct = not hetero
    rparams = jax.tree.map(jnp.asarray, np_params)
    ref = rbk.make_backend(backend, ref_model, donate=False,
                           compression=comp, **kw)
    ref_out = ref.run_round(
        rparams, *map(jnp.asarray, arrays), jnp.float32(ETA),
        bias_correct=bias_correct,
        wmasks=ref_model.width_masks(rparams, RATIOS) if hetero else None)
    params = params_from_jax(np_params, "cpu")
    bk = make_backend(backend, model, compression=comp, device="cpu", **kw)
    tarrays = [torch.from_numpy(a) for a in arrays]
    out = bk.run_round(
        params, *tarrays, ETA, bias_correct=bias_correct,
        wmasks=model.width_masks(params, RATIOS) if hetero else None)
    steps = [0.0] * len(tree_leaves(params))
    if comp == "int8":
        c = layer_coefficients(tarrays[3], tarrays[4])
        payload = compress_deltas(bk._deltas(params, *tarrays[:3], ETA),
                                  model.layer_ids(params),
                                  make_compression("int8"))
        ids = tree_leaves(model.layer_ids(params))
        steps = [float((c[:, l] * scale[:, 0]).sum())
                 for l, (_, scale) in zip(ids, payload)]
    for a, b, step in zip(tree_leaves(out), jax.tree.leaves(ref_out), steps):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype
        assert np.all(np.abs(a - b) <= 1e-6 + 1e-4 * np.abs(b)
                      + 1.0001 * step), (backend, rule, np.abs(a - b).max())


# ---------------------------------------------------------------------------
# ExecSpec: one execution surface for every entry point
# ---------------------------------------------------------------------------

def test_execspec_roundtrip_and_resolve():
    spec = ExecSpec(backend="chunked", chunk_size=4, compression="int8",
                    agg_impl="pallas")
    assert spec.compression.mode == "int8"
    d = spec.as_dict()
    assert d["backend"] == "chunked" and d["compression"]["mode"] == "int8"
    assert d["agg_impl"] == "pallas"
    r = ExecSpec.resolve(spec, agg_impl="jnp")
    assert r.agg_impl == "jnp" and r.chunk_size == 4
    assert ExecSpec.resolve(spec) == spec
    with pytest.raises(TypeError, match="unknown execution kwargs"):
        ExecSpec.resolve(spec, not_a_knob=1)
    with pytest.raises(ValueError, match="unknown backend"):
        ExecSpec(backend="nope")
    with pytest.raises(ValueError):
        ExecSpec(lam=1.5)
    with pytest.raises(ValueError):
        ExecSpec(regions=0)


def test_execspec_warns_on_ignored_knobs():
    with pytest.warns(UserWarning, match="chunk_size"):
        ExecSpec.resolve(backend="dense", chunk_size=4)
    with pytest.warns(UserWarning, match="staleness"):
        ExecSpec.resolve(backend="dense", lam=0.5)
    with pytest.warns(UserWarning, match="regions"):
        ExecSpec.resolve(backend="chunked", regions=2)
    with pytest.raises(ValueError, match="mesh"):
        ExecSpec.resolve(backend="dense", mesh=object(), strict=True)


def test_execspec_strict_env(monkeypatch):
    monkeypatch.setenv("REPRO_EXEC_STRICT", "1")
    with pytest.raises(ValueError, match="chunk_size"):
        ExecSpec.resolve(backend="temporal", chunk_size=4)


def test_execspec_cli_roundtrip():
    ap = argparse.ArgumentParser()
    ExecSpec.add_cli_args(ap)
    args = ap.parse_args(["--backend", "chunked", "--chunk-size", "4",
                          "--compression", "topk8", "--topk-frac", "0.25",
                          "--agg-impl", "pallas"])
    spec = ExecSpec.from_cli(args)
    assert spec.backend == "chunked" and spec.chunk_size == 4
    assert spec.compression.mode == "topk8" and spec.compression.top_k == 0.25
    assert spec.agg_impl == "pallas"
    assert ExecSpec.from_cli(ap.parse_args([]),
                             base=ExecSpec(backend="chunked",
                                           chunk_size=4)) == \
        ExecSpec(backend="chunked", chunk_size=4)
    args = ap.parse_args(["--backend", "buffered", "--lam", "0.3",
                          "--max-age", "2", "--buffer-cap", "3"])
    spec = ExecSpec.from_cli(args)
    assert spec.backend == "buffered" and spec.lam == 0.3
    assert (spec.max_age, spec.buffer_cap) == (2, 3)
    # the staleness knobs belong to the buffered backend: no warning there
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ExecSpec.resolve(backend="buffered", lam=0.5, strict=True)
    with pytest.raises(SystemExit):
        ap.parse_args(["--backend", "nope"])
    assert ExecSpec.from_cli(ap.parse_args(
        ["--backend", "shard_map", "--pipeline", "prefetch"])) == \
        ExecSpec(backend="shard_map", pipeline="prefetch")


def test_make_backend_accepts_spec_and_legacy():
    model = ppm.make_mlp()
    spec = ExecSpec(backend="chunked", chunk_size=8)
    a = make_backend(exec=spec, model=model, device="cpu")
    b = make_backend("chunked", model, chunk_size=8, device="cpu")
    assert type(a) is type(b) is ChunkedBackend
    assert a.chunk_size == b.chunk_size == 8
    c = make_backend(spec, model, device="cpu")
    assert isinstance(c, ChunkedBackend) and c.chunk_size == 8
    h = make_backend("hierarchical", model, regions=3, device="cpu")
    assert isinstance(h, HierarchicalBackend) and h.regions == 3
    assert h.needs_ctx and not b.needs_ctx
    t = make_backend(exec=ExecSpec(backend="temporal", local_iters=2, l2=0.1),
                     model=model, device="cpu")
    assert isinstance(t, TemporalBackend)
    assert (t.local_iters, t.l2) == (2, 0.1)


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_execspec_equals_legacy_kwargs(setup, backend):
    """run_federated(backend=...) and run_federated(exec=ExecSpec(...))
    must produce bit-identical Histories on every backend."""
    model, cfg, data, schedule = setup
    kw = {"chunk_size": 3} if backend == "chunked" else {}
    legacy = _run(setup, "adel", backend, **kw)
    policy = make_policy("adel", cfg, schedule=schedule, device="cpu")
    _, spec_hist = run_federated(model, policy, cfg, *data, seed=0,
                                 exec=ExecSpec(backend=backend, **kw),
                                 device="cpu")
    _assert_bit_identical(legacy, spec_hist)
