"""The port's fleet subsystem (``repro_torch.fleet``): the ports of
``tests/test_fleet.py``'s and ``tests/test_population.py``'s cases, with
every numpy product held against the reference's.

Tolerances: presets, traces, availability steps and forecasts, cohorts,
cohort views, the MobiPerf import, parametric profiles and cohort draws,
the planning config and the scenario registry EQUAL to the reference's
(the port keeps numpy copies of the same code). ``run_fleet``'s first
round under the reference's draws, init and schedule: params rtol 1e-4 /
atol 1e-6 (XLA-CPU and ATen sum in different orders). Run against run
inside the port: hierarchical with one region bit for bit against dense;
several regions within ``tests/test_backends.py``'s tolerances (accuracy
atol 0.015, loss rtol/atol 0.02).
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FleetConfig as RefFleetConfig
from repro.core import straggler as rst
from repro.core.scheduler import solve as ref_solve
from repro.fl.spec import ExecSpec as RefExecSpec
from repro.fleet import availability as ravail
from repro.fleet import cohort as rcohort
from repro.fleet import engine as rengine
from repro.fleet import population as rpop
from repro.fleet import profiles as rprof
from repro.fleet.scenarios import SCENARIOS as REF_SCENARIOS
from repro.models.paper_models import make_mlp as ref_make_mlp
from repro_torch import obs
from repro_torch.configs.base import FleetConfig
from repro_torch.convert import params_from_jax
from repro_torch.core.aggregation import aggregate_grads, aggregate_grads_chunk
from repro_torch.core.types import AnalysisConfig, Schedule
from repro_torch.data.synthetic import make_image_dataset
from repro_torch.fl.spec import ExecSpec
from repro_torch.fleet import engine as pengine
from repro_torch.fleet import scenarios as pscn
from repro_torch.fleet.availability import AVAILABILITY, make_availability
from repro_torch.fleet.cohort import cohort_view, sample_cohort
from repro_torch.fleet.engine import (partition_fleet, reference_config,
                                      run_fleet)
from repro_torch.fleet.population import (MaterializedPopulation,
                                          ParametricPopulation, Population,
                                          PopulationSpec, make_population)
from repro_torch.fleet.profiles import (PRESETS, fleet_from_config,
                                        load_mobiperf, load_trace, make_fleet,
                                        save_trace)
from repro_torch.models.paper_models import make_mlp
from repro_torch.tree import tree_leaves

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
AKW = {"always-on": {}, "bernoulli": {"rate": 0.6},
       "diurnal": {"mean": 0.5, "amplitude": 0.4, "period": 8.0,
                   "phase_spread": 0.5},
       "markov": {"p_off_to_on": 0.3, "p_on_to_off": 0.1}}


def _eq_fleet(a, b):
    assert a.name == b.name
    for f in ("P", "B", "tier"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# profiles, availability, cohorts: the reference's arrays
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_preset_sampling_equals_reference(preset):
    assert sorted(PRESETS) == sorted(rprof.PRESETS)
    fl = make_fleet(preset, 300, seed=4)
    _eq_fleet(fl, rprof.make_fleet(preset, 300, seed=4))
    _eq_fleet(fl, make_fleet(preset, 300, seed=4))        # pure in the seed
    assert not np.array_equal(fl.P, make_fleet(preset, 300, seed=5).P)
    assert fl.describe() == rprof.make_fleet(preset, 300, seed=4).describe()


def test_trace_roundtrip_crosses_packages(tmp_path):
    fl = make_fleet("bimodal-edge", 50, seed=1)
    path = save_trace(fl, str(tmp_path / "fleet.json"))
    _eq_fleet(load_trace(path), fl)
    _eq_fleet(rprof.load_trace(path), load_trace(path))
    fc = FleetConfig(trace_path=path)
    _eq_fleet(fleet_from_config(fc), fl)
    with pytest.raises(ValueError, match="registered presets"):
        fleet_from_config(FleetConfig(preset="no-such-preset"))


@pytest.mark.parametrize("name", sorted(AVAILABILITY))
def test_availability_traces_equal_reference(name):
    """Each churn model's reachability draws, forecasts and marginal rate
    equal the reference's, and reset() rewinds the stream."""
    kw = AKW[name]
    port = make_availability(name, 300, seed=2, **kw)
    ref = ravail.make_availability(name, 300, seed=2, **kw)
    steps = []
    for t in range(6):
        a = port.step(t)
        np.testing.assert_array_equal(a, ref.step(t))
        np.testing.assert_array_equal(port.reachable_probs(t + 1),
                                      ref.reachable_probs(t + 1))
        steps.append(a)
    np.testing.assert_array_equal(port.expected_reachable(6, 4),
                                  ref.expected_reachable(6, 4))
    for t in (0, 3, 7):
        assert type(port).marginal_rate(t, **kw) == \
            type(ref).marginal_rate(t, **kw)
    assert port.describe() == ref.describe()
    port.reset()
    for t in range(6):
        np.testing.assert_array_equal(port.step(t), steps[t])
    if name == "bernoulli":
        rate = np.mean([port.step(t).mean() for t in range(20)])
        assert abs(rate - 0.6) < 0.03


@pytest.mark.parametrize("strategy", ["uniform", "power-of-choice",
                                      "stratified"])
def test_cohorts_equal_reference(strategy):
    fl = make_fleet("longtail-mobile", 400, seed=0)
    rfl = rprof.make_fleet("longtail-mobile", 400, seed=0)
    avail = make_availability("bernoulli", 400, seed=1, rate=0.5)
    for t in range(4):
        a = avail.step(t)
        idx = sample_cohort(np.random.default_rng([7, t]), a, fl, 32,
                            strategy)
        ref = rcohort.sample_cohort(np.random.default_rng([7, t]), a, rfl, 32,
                                    strategy)
        np.testing.assert_array_equal(idx, ref)
        assert len(idx) == 32 == len(np.unique(idx)) and a[idx].all()
    if strategy == "stratified":
        assert set(np.unique(fl.tier[idx])) == set(np.unique(fl.tier))
    if strategy == "power-of-choice":
        assert fl.P[idx].mean() > fl.P[np.flatnonzero(a)].mean()


def test_cohort_degrades_when_few_available():
    fl = make_fleet("uniform", 100, seed=0)
    avail = np.zeros(100, bool)
    avail[[3, 17, 42]] = True
    idx = sample_cohort(np.random.default_rng(0), avail, fl, 10)
    np.testing.assert_array_equal(idx, [3, 17, 42])
    assert len(sample_cohort(np.random.default_rng(0), np.zeros(100, bool),
                             fl, 10)) == 0


def test_cohort_view_equals_reference():
    fl = make_fleet("bimodal-edge", 200, seed=0)
    base = AnalysisConfig.default(U=16, L=4, R=8, T_max=16.0)
    rbase = rengine.AnalysisConfig.default(U=16, L=4, R=8, T_max=16.0)
    idx = np.arange(10, 26)
    view = cohort_view(base, fl, idx)
    rview = rcohort.cohort_view(rbase, rprof.make_fleet("bimodal-edge", 200,
                                                        seed=0), idx)
    assert view.U == rview.U == 16
    for f in ("P", "B", "sigma2", "eta"):
        np.testing.assert_array_equal(getattr(view, f), getattr(rview, f))
    assert view.R == base.R and view.T_max == base.T_max


def test_load_mobiperf_fixture_equals_reference():
    """MobiPerf-style logs import as a Fleet: one device per device_id,
    medians over repeated measurements, CPU->P / network->B / RAM->tier;
    the arrays equal the reference's import."""
    path = os.path.join(FIXTURES, "mobiperf_sample.json")
    fl = load_mobiperf(path)
    _eq_fleet(fl, rprof.load_mobiperf(path))
    assert fl.size == 6 and fl.name == "mobiperf"
    devs = sorted(["pixel-3", "galaxy-s4", "moto-g", "nexus-7",
                   "oneplus-one", "iphone-6"])
    pix = devs.index("pixel-3")
    assert fl.P[pix] == fl.P.max() and fl.tier[pix] == fl.tier.max()
    assert fl.B[devs.index("galaxy-s4")] > fl.B[pix]
    assert fl.B[devs.index("nexus-7")] >= np.median(fl.B)
    ref = reference_config(fl, U=4, L=3, R=4, T_max=12.0)
    assert ref.U == 4 and (np.diff(ref.P) >= 0).all()
    _eq_fleet(make_population(f"mobiperf:{path}").fleet, fl)


def test_reference_config_equals_reference():
    fl = make_fleet("longtail-mobile", 500, seed=0)
    ref = reference_config(fl, U=32, L=4, R=10, T_max=20.0)
    rref = rengine.reference_config(rprof.make_fleet("longtail-mobile", 500,
                                                     seed=0),
                                    U=32, L=4, R=10, T_max=20.0)
    for f in ("P", "B", "sigma2", "eta"):
        np.testing.assert_array_equal(getattr(ref, f), getattr(rref, f))
    assert ref.P.min() <= np.quantile(fl.P, 0.1)
    assert ref.P.max() >= np.quantile(fl.P, 0.9)
    assert (np.diff(ref.P) >= 0).all()


# ---------------------------------------------------------------------------
# parametric populations: the reference's lazy profiles and draws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_parametric_profiles_equal_reference(preset):
    """Device profiles are pure in the device id through the same
    splitmix64 / Box-Muller hashing: the arrays equal the reference's, and
    the per-tier quantiles follow the preset's reference draw."""
    pop = ParametricPopulation(preset, 1_000_000, seed=0)
    rpp = rpop.ParametricPopulation(preset, 1_000_000, seed=0)
    ids = np.arange(6000, dtype=np.int64) * 167
    P, B, tier = pop.profiles(ids)
    for a, b in zip((P, B, tier), rpp.profiles(ids)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert pop.describe() == rpp.describe()
    for a, b in zip(pop.plan_profile(16), rpp.plan_profile(16)):
        np.testing.assert_array_equal(a, b)
    assert pop.best_profile() == rpp.best_profile()
    ref = make_fleet(preset, 4096, seed=0)
    for k in np.unique(ref.tier):
        sel, rsel = tier == k, ref.tier == k
        if sel.sum() < 200:
            continue
        for drawn, refv in ((P[sel], ref.P[rsel]), (B[sel], ref.B[rsel])):
            np.testing.assert_allclose(np.quantile(drawn, [0.05, 0.5, 0.95]),
                                       np.quantile(refv, [0.05, 0.5, 0.95]),
                                       rtol=0.30)


@pytest.mark.parametrize("strategy", ["uniform", "power-of-choice",
                                      "stratified"])
def test_parametric_cohorts_equal_reference(strategy):
    kw = dict(seed=0, availability="diurnal", regions=4,
              availability_kwargs=(("mean", 0.6), ("amplitude", 0.3)))
    pop = ParametricPopulation("longtail-mobile", 500_000, **kw)
    rpp = rpop.ParametricPopulation("longtail-mobile", 500_000, **kw)
    rng, rrng = (np.random.default_rng([2077, 5]),
                 np.random.default_rng([2077, 5]))
    for t in range(3):
        a = pop.sample_cohort(t, rng, U=16, strategy=strategy)
        b = rpp.sample_cohort(t, rrng, U=16, strategy=strategy)
        for f in ("ids", "P", "B", "tier", "region"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert a.available == b.available
    np.testing.assert_array_equal(pop.expected_reachable(0, 5),
                                  rpp.expected_reachable(0, 5))


def test_parametric_profiles_pure_in_device_id():
    pop = ParametricPopulation("bimodal-edge", 10**6, seed=3)
    ids = np.asarray([7, 123_456, 999_999])
    P1, B1, t1 = pop.profiles(ids)
    P2, B2, t2 = ParametricPopulation("bimodal-edge", 10**6,
                                      seed=3).profiles(ids)
    for a, b in ((P1, P2), (B1, B2), (t1, t2)):
        np.testing.assert_array_equal(a, b)
    Pb, _, _ = pop.profiles(np.arange(10**6 - 10, 10**6))
    np.testing.assert_array_equal(Pb[-1], P1[-1])
    P3, _, _ = ParametricPopulation("bimodal-edge", 10**6,
                                    seed=4).profiles(ids)
    assert not np.array_equal(P1, P3)


def test_million_device_cohort_is_cohort_sized():
    import time
    pop = ParametricPopulation("longtail-mobile", 1_000_000, seed=0,
                               availability="bernoulli",
                               availability_kwargs=(("rate", 0.8),),
                               regions=4)
    t0 = time.perf_counter()
    draw = pop.sample_cohort(0, np.random.default_rng(0), U=64)
    assert time.perf_counter() - t0 < 1.0
    assert draw.size == 64 == len(np.unique(draw.ids))
    assert draw.ids.min() >= 0 and draw.ids.max() < 1_000_000
    assert abs(draw.available - 800_000) < 5_000
    np.testing.assert_array_equal(draw.region, draw.ids % 4)
    ref = reference_config(pop, U=16, L=4, R=5, T_max=20.0)
    assert ref.P.shape == (16,) and (np.diff(ref.P) >= 0).all()


# ---------------------------------------------------------------------------
# specs and constructors
# ---------------------------------------------------------------------------

def test_make_population_forms_and_specs():
    fl = make_fleet("longtail-mobile", 200, seed=0)
    pop = MaterializedPopulation(fl)
    assert make_population(pop) is pop
    wrapped = make_population(fl)
    assert isinstance(wrapped, MaterializedPopulation)
    np.testing.assert_array_equal(wrapped.fleet.P, fl.P)
    para = make_population("parametric:datacenter", size=10_000, regions=2)
    assert isinstance(para, ParametricPopulation)
    assert para.size == 10_000 and para.regions == 2
    mat = make_population("uniform", size=64, availability="bernoulli",
                          availability_kwargs=(("rate", 0.5),))
    assert isinstance(mat, MaterializedPopulation) and mat.size == 64
    fc = FleetConfig(population="parametric:uniform", size=1000, regions=3)
    spec = fc.population_spec()
    assert spec.source == "parametric:uniform" and spec.regions == 3
    assert spec.build().size == 1000
    assert spec.as_dict() == RefFleetConfig(
        population="parametric:uniform", size=1000,
        regions=3).population_spec().as_dict()
    with pytest.raises(ValueError, match="registered presets"):
        make_population("parametric:no-such-preset", size=100)
    with pytest.raises(ValueError, match="regions"):
        PopulationSpec(source="uniform", regions=0)
    with pytest.raises(TypeError, match="unknown"):
        PopulationSpec.resolve(sise=100)
    base = PopulationSpec(source="datacenter", size=300, regions=2)
    spec = PopulationSpec.resolve(base=base, size=900)
    assert (spec.source, spec.size, spec.regions) == ("datacenter", 900, 2)
    assert PopulationSpec.resolve(base) is base
    for p in (make_population("uniform", size=128),
              make_population("parametric:uniform", size=100_000)):
        assert isinstance(p, Population)
        P, B = p.replan_profile(8)
        assert P.shape == B.shape == (8,) and p.rate_max > 0
        assert {"fleet", "availability", "regions"} <= set(p.describe())


def test_fleet_config_equals_reference():
    """FleetConfig's fields and defaults are the reference's, and its
    derived specs resolve the same."""
    names = [f.name for f in dataclasses.fields(FleetConfig)]
    assert names == [f.name for f in dataclasses.fields(RefFleetConfig)]
    port, ref = FleetConfig(), RefFleetConfig()
    assert port.exec_spec().as_dict() == ref.exec_spec().as_dict()
    assert port.population_spec().as_dict() == \
        ref.population_spec().as_dict()
    assert dataclasses.asdict(port.replan) == dataclasses.asdict(ref.replan)
    fc = FleetConfig(availability_kwargs=(("rate", 0.3),))
    assert fc.availability_dict() == {"rate": 0.3}


def test_population_cli_block():
    import argparse
    ap = argparse.ArgumentParser()
    PopulationSpec.add_cli_args(ap)
    args = ap.parse_args(["--population", "parametric:uniform",
                          "--fleet-size", "5000", "--regions", "4"])
    spec = PopulationSpec.from_cli(args, base=PopulationSpec(
        availability="bernoulli"))
    assert (spec.source, spec.size, spec.regions, spec.availability) == (
        "parametric:uniform", 5000, 4, "bernoulli")


# ---------------------------------------------------------------------------
# run_fleet on the port
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fleet_setup():
    x_tr, y_tr, x_te, y_te = make_image_dataset(
        "mnist", n_train=1000, n_test=250, seed=0, noise_std=1.0)
    fl = make_fleet("longtail-mobile", 200, seed=0)
    data = partition_fleet(x_tr, y_tr, x_te, y_te, 200, alpha=0.5, seed=0)
    return fl, data


def _fleet(fl, data, pop=None, **kw):
    kw.setdefault("solver_steps", 150)
    kw.setdefault("seed", 0)
    return run_fleet(make_mlp(), pop, data=data, device="cpu", **kw)


def test_run_fleet_smoke_200_devices(fleet_setup):
    fl, data = fleet_setup
    pop = MaterializedPopulation(fl, make_availability(
        "diurnal", 200, seed=0, mean=0.7, amplitude=0.25, period=8.0))
    _, hist = _fleet(fl, data, pop, method="adel", rounds=6, cohort_size=16,
                     chunk_size=8, solver_steps=300)
    assert len(hist.accuracy) >= 4
    assert len(hist.available) == len(hist.accuracy)
    assert all(0 < a <= 200 for a in hist.available)
    assert hist.train_loss[-1] < hist.train_loss[0], hist.train_loss
    assert hist.times[-1] <= 6 * make_mlp().L * 0.5 * 1.001
    assert hist.method == "fleet-adel"


def test_run_fleet_baseline_and_reduced_cohort(fleet_setup):
    """salf, the single-chunk path (cohort == chunk), and rounds with fewer
    reachable devices than the cohort still execute."""
    fl, data = fleet_setup
    pop = MaterializedPopulation(fl, make_availability("bernoulli", 200,
                                                       seed=1, rate=0.06))
    _, hist = _fleet(fl, data, pop, method="salf", rounds=3, cohort_size=16,
                     chunk_size=16)
    assert len(hist.accuracy) >= 1 and hist.method == "fleet-salf"
    assert min(hist.available) < 16


def _legacy_run(fl, data, **kw):
    avail = make_availability("bernoulli", fl.size, seed=7, rate=0.6)
    with pytest.warns(DeprecationWarning):
        return run_fleet(make_mlp(), fl, avail, data, device="cpu", **kw)


def test_legacy_positional_matches_population(fleet_setup):
    fl, data = fleet_setup
    kw = dict(method="adel", rounds=3, cohort_size=12, chunk_size=6,
              solver_steps=100, seed=0)
    _, legacy = _legacy_run(fl, data, **kw)
    pop = MaterializedPopulation(
        fl, make_availability("bernoulli", fl.size, seed=7, rate=0.6))
    _, new = run_fleet(make_mlp(), pop, data=data, device="cpu", **kw)
    assert legacy.as_dict() == new.as_dict()


def test_legacy_shim_strict_mode(fleet_setup, monkeypatch):
    fl, data = fleet_setup
    monkeypatch.setenv("REPRO_EXEC_STRICT", "1")
    avail = make_availability("bernoulli", fl.size, seed=7, rate=0.6)
    with pytest.raises(ValueError, match="Population"):
        run_fleet(make_mlp(), fl, avail, data, rounds=1, cohort_size=4,
                  device="cpu")


def test_region_partition_aggregation_identity():
    """Per-region partials against the GLOBAL counts sum to the flat
    Eq. 5 fold, whatever the region count."""
    rng = np.random.default_rng(0)
    U, L = 12, 4
    grads = {"w": torch.from_numpy(rng.normal(size=(U, L, 5)).astype(
        np.float32)),
        "b": torch.from_numpy(rng.normal(size=(U, 3)).astype(np.float32))}
    ids = {"w": torch.arange(L), "b": 2}
    mask = torch.from_numpy((rng.random((U, L)) < 0.7).astype(np.float32))
    p = torch.tensor([0.1, 0.3, 0.2, 0.05])
    dense = aggregate_grads(grads, ids, mask, p)
    counts = mask.sum(0)
    for regions in (1, 3, 4):
        rid = np.arange(U) % regions
        acc = None
        for g in range(regions):
            sel = torch.from_numpy(np.flatnonzero(rid == g))
            part = aggregate_grads_chunk({k: v[sel] for k, v in grads.items()},
                                         ids, mask[sel], p, counts)
            acc = part if acc is None else {k: acc[k] + part[k] for k in acc}
        for k in dense:
            np.testing.assert_allclose(acc[k].numpy(), dense[k].numpy(),
                                       rtol=2e-5, atol=2e-6)


def test_hierarchical_single_region_bitexact_dense(fleet_setup):
    fl, data = fleet_setup
    hists = {}
    for backend, regions in (("dense", 4), ("hierarchical", 1)):
        pop = MaterializedPopulation(
            fl, make_availability("bernoulli", 200, seed=3, rate=0.6),
            regions=1)
        _, hists[backend] = _fleet(fl, data, pop, method="adel", rounds=3,
                                   cohort_size=10,
                                   exec=ExecSpec(backend=backend,
                                                 regions=regions))
    assert hists["dense"].as_dict() == hists["hierarchical"].as_dict()


@pytest.mark.parametrize("method", ["adel", "heterofl"])
def test_hierarchical_multi_region_equivalence(fleet_setup, method):
    """Four edge regions (the population's ids mod 4) against flat dense:
    the same clock and cohorts, the same trajectory up to summation
    order; the ledger's region census counts the cohort's region ids."""
    fl, data = fleet_setup
    hists, sinks = {}, {}
    for backend in ("dense", "hierarchical"):
        pop = MaterializedPopulation(
            fl, make_availability("markov", 200, seed=1, p_off_to_on=0.4,
                                  p_on_to_off=0.1), regions=4)
        sinks[backend] = obs.MemorySink()
        _, hists[backend] = _fleet(fl, data, pop, method=method, rounds=4,
                                   cohort_size=16, eta0=1.0,
                                   tracer=obs.Tracer(sinks[backend]),
                                   exec=ExecSpec(backend=backend, regions=4))
    a, b = hists["dense"], hists["hierarchical"]
    assert a.rounds == b.rounds and a.available == b.available
    np.testing.assert_allclose(a.times, b.times, rtol=1e-6)
    np.testing.assert_allclose(a.accuracy, b.accuracy, atol=0.015)
    np.testing.assert_allclose(a.train_loss, b.train_loss, rtol=0.02,
                               atol=0.02)
    rows = obs.ledger_rows(sinks["hierarchical"].records)
    assert rows and all(1 <= r["regions"] <= 4 for r in rows)
    assert all(r["region_pad"] >= r["region_max"] for r in rows)
    assert any(r["regions"] > 1 for r in rows)


def test_parametric_end_to_end_o_cohort(fleet_setup):
    import time
    _, data = fleet_setup
    pop = make_population("parametric:longtail-mobile", size=1_000_000,
                          availability="bernoulli",
                          availability_kwargs=(("rate", 0.7),), regions=4)
    t0 = time.perf_counter()
    _, hist = run_fleet(make_mlp(), pop, data=data, method="adel", rounds=3,
                        cohort_size=16, solver_steps=150, seed=0,
                        exec=ExecSpec(backend="hierarchical", regions=4),
                        device="cpu")
    assert len(hist.accuracy) == 3
    assert all(600_000 < a < 800_000 for a in hist.available)
    assert time.perf_counter() - t0 < 120.0


class _FleetReplay:
    """The reference ``run_fleet``'s draws, replayed: its ``k_init`` and,
    each planned round, ``(k_round, k_batch)`` from splitting the plan key
    (``fl/runtime.py``); depths from the reference's own ``sample_round``
    on the reference's cohort view of that round."""

    def __init__(self, seed, views, T, m):
        key, self.k_init = jax.random.split(jax.random.PRNGKey(seed))
        self.keys = []
        for _ in views:
            key, k_round, k_batch = jax.random.split(key, 3)
            self.keys.append((k_round, k_batch))
        self.views, self.T, self.m = views, T, m

    def poisson(self, t, lam):
        z = rst.sample_round(self.keys[t][0], jnp.float32(self.T[t]),
                             self.m, self.views[t])[3]
        return torch.as_tensor(np.array(z))

    def batch_indices(self, t, U, s_max):
        idx = jax.random.randint(self.keys[t][1], (U, s_max), 0, 2 ** 30)
        return torch.as_tensor(np.array(idx))


@pytest.mark.parametrize("backend", ["chunked", "hierarchical"])
def test_run_fleet_first_round_matches_reference(fleet_setup, monkeypatch,
                                                 backend):
    """One run_fleet round on the port and on the reference with the same
    population draw, schedule, init and draws: the params after the round
    within rtol 1e-4 (hierarchical: four regions from the device ids)."""
    fl, data = fleet_setup
    kw = dict(method="adel", rounds=1, cohort_size=12, solver_steps=80,
              seed=0)
    spec = dict(backend=backend, regions=4) if backend == "hierarchical" \
        else dict(backend=backend)

    def ref_pop():
        return rpop.MaterializedPopulation(
            rprof.make_fleet("longtail-mobile", 200, seed=0),
            ravail.make_availability("bernoulli", 200, seed=3, rate=0.6),
            regions=4)

    ref_data = rengine.FleetData(x=data.x, y=data.y, parts=data.parts,
                                 x_test=data.x_test, y_test=data.y_test)
    ref_model = ref_make_mlp()
    ref_params, ref_hist = rengine.run_fleet(ref_model, ref_pop(),
                                             data=ref_data,
                                             exec=RefExecSpec(**spec), **kw)
    # the reference's schedule and round-0 cohort view, rebuilt
    ref_cfg = rengine.reference_config(ref_pop(), U=12, L=ref_model.L, R=1,
                                       T_max=ref_model.L * 0.5, seed=0)
    sched = ref_solve(ref_cfg, "adam", steps=80)
    draw = ref_pop().sample_cohort(0, np.random.default_rng([2077, 0]),
                                   U=12)
    view = rcohort.profile_view(ref_cfg, draw.P, draw.B)
    monkeypatch.setattr(pengine, "solve", lambda *a, **k: Schedule(
        T=np.asarray(sched.T), m=sched.m, objective=sched.objective,
        p1=np.asarray(sched.p1)))
    replay = _FleetReplay(0, [view], sched.T, sched.m)
    init = params_from_jax(jax.tree.map(np.asarray,
                                        ref_model.init(replay.k_init)), "cpu")
    pop = MaterializedPopulation(
        fl, make_availability("bernoulli", 200, seed=3, rate=0.6), regions=4)
    params, hist = run_fleet(make_mlp(), pop, data=data, device="cpu",
                             exec=ExecSpec(**spec), draws=replay,
                             init_params=init, **kw)
    assert hist.available == ref_hist.available
    assert hist.times == ref_hist.times
    for a, b in zip(tree_leaves(params), jax.tree.leaves(ref_params)):
        a, b = a.numpy(), np.asarray(b)
        assert np.all(np.abs(a - b) <= 1e-6 + 1e-4 * np.abs(b)), \
            np.abs(a - b).max()


# ---------------------------------------------------------------------------
# scenarios
# ---------------------------------------------------------------------------

def _scenario_dict(s):
    d = {f.name: getattr(s, f.name) for f in dataclasses.fields(s)
         if f.name != "fleet"}
    fc = s.fleet
    d["fleet"] = {f.name: getattr(fc, f.name)
                  for f in dataclasses.fields(fc)
                  if f.name not in ("exec", "replan", "compression")}
    d["exec"] = None if fc.exec is None else fc.exec.as_dict()
    d["resolved"] = fc.exec_spec().as_dict()
    d["replan"] = dataclasses.asdict(fc.replan)
    d["compression"] = dataclasses.asdict(fc.compression)
    return d


def test_scenario_registry_equals_reference():
    assert list(pscn.SCENARIOS) == list(REF_SCENARIOS)
    for name, s in pscn.SCENARIOS.items():
        assert _scenario_dict(s) == _scenario_dict(REF_SCENARIOS[name]), name
    assert pscn.get_scenario("bimodal-edge-heterofl").method == "heterofl"
    with pytest.raises(KeyError):
        pscn.get_scenario("nope")


def test_lm_scenario_waits_for_lm_training():
    """The wait is over: ``lm-uniform-bernoulli`` (a reduced qwen1.5-4b on
    token-stream shards, ``run_fleet(..., eval_metrics=lm_eval_metrics)``)
    runs on the CPU. Its fleet arrays equal the reference's run of the same
    scenario: reachable counts and rounds exactly, deadlines and the clock
    within the solver tolerance (rtol 5e-3); the token losses are finite
    and start near ln(vocab) as the reference's do (other init draws)."""
    from repro.fleet.scenarios import run_scenario as ref_run_scenario
    kw = dict(rounds=3, solver_steps=100, verbose=False)
    ref = ref_run_scenario(REF_SCENARIOS["lm-uniform-bernoulli"], **kw)
    res = pscn.run_scenario(pscn.get_scenario("lm-uniform-bernoulli"),
                            device="cpu", **kw)
    assert res["available"] == ref["available"]
    assert res["rounds"] == ref["rounds"] == [1, 2, 3]
    np.testing.assert_allclose(res["deadlines"], ref["deadlines"], rtol=5e-3)
    np.testing.assert_allclose(res["times"], ref["times"], rtol=5e-3)
    assert np.isfinite(res["train_loss"]).all()
    np.testing.assert_allclose(res["train_loss"][0], ref["train_loss"][0],
                               rtol=0.02)
    assert all(0.0 <= a <= 1.0 for a in res["accuracy"])


def test_scenarios_cli_list_run_save(tmp_path, capsys):
    pscn.main(["--list"])
    out = capsys.readouterr().out
    assert all(name in out for name in pscn.SCENARIOS)
    path = str(tmp_path / "res" / "scenarios.json")
    pscn.main(["--run", "longtail-mobile-buffered", "--rounds", "3",
               "--quiet", "--device", "cpu", "--solver-steps", "100",
               "--save", path])
    out = capsys.readouterr().out
    assert "[longtail-mobile-buffered] method=adel fleet=600 rounds=3" in out
    import json
    with open(path) as f:
        res = json.load(f)["longtail-mobile-buffered"]["adel"]
    assert res["backend"] == "buffered" and res["exec"]["lam"] == 0.5
    assert len(res["available"]) == 3


@pytest.mark.parametrize("trigger", ["never", "every-k", "drift"])
def test_replan_sweep_targets(trigger):
    """The reference's ``replan_sweep.json`` (its quick settings: 200
    devices, 14 rounds, 1,200 training samples, 400 solver steps, eval
    every 2): the port's run of the same scenario reaches the same
    reachable counts, rounds and replan decisions (round, reachable,
    ``U_est``) exactly, with the deadlines, budgets and re-solved tails
    within the solver tolerance (rtol 5e-3)."""
    import json
    path = os.path.join(os.path.dirname(FIXTURES), "..", "experiments",
                        "results", "replan_sweep.json")
    with open(path) as f:
        ref = json.load(f)["longtail-mobile-diurnal-replan"][trigger]
    scn = dataclasses.replace(pscn.get_scenario(
        "longtail-mobile-diurnal-replan"), n_train=1200, n_test=400)
    res = pscn.run_scenario(scn, rounds=14, fleet_size=200, replan=trigger,
                            solver_steps=400, eval_every=2, verbose=False,
                            device="cpu")
    assert res["available"] == ref["available"]
    assert res["rounds"] == ref["rounds"]
    np.testing.assert_allclose(res["deadlines"], ref["deadlines"], rtol=5e-3)
    np.testing.assert_allclose(res["times"], ref["times"], rtol=5e-3)
    key = ("round", "reachable", "U_est")
    assert [tuple(e[k] for k in key) for e in res["replans"]] == \
        [tuple(e[k] for k in key) for e in ref["replans"]]
    for a, b in zip(res["replans"], ref["replans"]):
        np.testing.assert_allclose(a["T_tail"], b["T_tail"], rtol=5e-3)
        for k in ("budget_left", "skipped_credit"):
            assert a[k] == pytest.approx(b[k], rel=5e-3, abs=1e-9)
