"""Fleet simulation: trace-driven heterogeneous device populations at up
to million-device scale (port of ``repro.fleet``).

* :mod:`repro_torch.fleet.profiles` — device-profile registry: named
  presets (``uniform``, ``bimodal-edge``, ``longtail-mobile``,
  ``datacenter``) sample per-device compute rates ``P_u``, network times
  ``B_u`` and memory tiers; ``load_trace``/``save_trace`` round-trip
  fleets through JSON device traces, ``load_mobiperf`` imports a
  MobiPerf-style measurement log.
* :mod:`repro_torch.fleet.availability` — churn models deciding who is
  reachable each round: ``always-on``, ``bernoulli``, ``diurnal``,
  ``markov``, with the expected-reachable forecasts re-planning reads.
* :mod:`repro_torch.fleet.cohort` — per-round cohort sampling
  (``uniform``, ``power-of-choice``, ``stratified``) and
  ``cohort_view``/``profile_view``, which re-derive the AnalysisConfig the
  policies plan against.
* :mod:`repro_torch.fleet.population` — the :class:`Population` protocol:
  :class:`MaterializedPopulation` (a :class:`Fleet` plus an availability
  model) and :class:`ParametricPopulation` (lazy profiles, O(cohort) a
  round), behind :class:`PopulationSpec` / :func:`make_population`.
* :mod:`repro_torch.fleet.engine` — ``run_fleet``, the fleet front end
  over :class:`repro_torch.fl.runtime.RoundRuntime` on any execution
  backend.
* :mod:`repro_torch.fleet.scenarios` — the named scenario registry with a
  CLI (``python -m repro_torch.fleet.scenarios --list``).

These modules are numpy-only copies of the reference's (the port never
imports the JAX package), so fleets, availability traces, cohorts and
parametric profiles are the reference's arrays exactly.
"""
from repro_torch.fleet.availability import (AVAILABILITY, AvailabilityModel,
                                            make_availability)
from repro_torch.fleet.cohort import (COHORT_STRATEGIES, cohort_view,
                                      profile_view, sample_cohort)
from repro_torch.fleet.engine import (FleetData, partition_fleet,
                                      reference_config, run_fleet)
from repro_torch.fleet.population import (CohortDraw, MaterializedPopulation,
                                          ParametricPopulation, Population,
                                          PopulationSpec, make_population)
from repro_torch.fleet.profiles import (PRESETS, Fleet, fleet_from_config,
                                        load_trace, make_fleet, save_trace)

__all__ = [
    "AVAILABILITY", "AvailabilityModel", "COHORT_STRATEGIES", "CohortDraw",
    "Fleet", "FleetData", "MaterializedPopulation", "PRESETS",
    "ParametricPopulation", "Population", "PopulationSpec", "cohort_view",
    "fleet_from_config", "load_trace", "make_availability", "make_fleet",
    "make_population", "partition_fleet", "profile_view", "reference_config",
    "run_fleet", "sample_cohort", "save_trace",
]
