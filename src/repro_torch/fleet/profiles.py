"""Device-profile registry: named fleet presets and JSON trace files (port
of ``repro.fleet.profiles``; numpy only, a copy the port keeps so it never
imports the JAX package).

A :class:`Fleet` is the static description of a device population — one
compute rate ``P_u`` (samples/sec per layer, Model Formulation B1), one
communication time ``B_u`` (seconds, B2), and one memory tier per device.
Presets sample these from parameterized distributions modelled on the
populations in the heterogeneity-aware FL literature (TimelyFL / FedEL
style device mixes):

* ``uniform``        — the paper's population: log-uniform P over a
                       ~4x spread, moderate network times.
* ``bimodal-edge``   — 70% slow edge boxes + 30% fast gateways; the slow
                       mode also has worse links.
* ``longtail-mobile``— lognormal P with a heavy right tail: a mass of
                       mid/slow phones and a few flagship devices; Pareto
                       network tail (congested uplinks).
* ``datacenter``     — tightly clustered fast workers with near-zero
                       network time.

``load_trace``/``save_trace`` round-trip a fleet through a JSON file with
one record per device, so measured traces can replace synthetic presets.
"""
from __future__ import annotations

import dataclasses
import json
import zlib
from typing import Callable

import numpy as np

__all__ = ["Fleet", "PRESETS", "preset", "make_fleet", "make_population",
           "fleet_from_config", "load_trace", "save_trace", "load_mobiperf"]


@dataclasses.dataclass(frozen=True)
class Fleet:
    """Static per-device capabilities of a simulated population."""

    name: str
    P: np.ndarray        # (n,) compute rate P_u, samples/sec per layer (B1)
    B: np.ndarray        # (n,) communication time B_u, seconds (B2)
    tier: np.ndarray     # (n,) memory tier 0 (small) .. 2 (large)

    def __post_init__(self):
        object.__setattr__(self, "P", np.asarray(self.P, np.float32))
        object.__setattr__(self, "B", np.asarray(self.B, np.float32))
        object.__setattr__(self, "tier", np.asarray(self.tier, np.int32))
        assert self.P.shape == self.B.shape == self.tier.shape
        assert self.P.ndim == 1 and self.size > 0
        assert float(self.P.min()) > 0.0

    @property
    def size(self) -> int:
        return int(self.P.shape[0])

    def describe(self) -> dict:
        q = lambda a: [round(float(np.quantile(a, x)), 4)
                       for x in (0.05, 0.5, 0.95)]
        return {"name": self.name, "size": self.size,
                "P_q05_50_95": q(self.P), "B_q05_50_95": q(self.B),
                "tiers": np.bincount(self.tier, minlength=3).tolist()}


PRESETS: dict[str, Callable] = {}


def preset(name: str):
    """Register ``fn(n, rng) -> (P, B, tier)`` as a named fleet preset."""
    def deco(fn):
        PRESETS[name] = fn
        return fn
    return deco


def _tiers_by_speed(P: np.ndarray) -> np.ndarray:
    """Memory tier from compute terciles (fast devices carry more RAM)."""
    t1, t2 = np.quantile(P, [1 / 3, 2 / 3])
    return (P >= t1).astype(np.int32) + (P >= t2).astype(np.int32)


@preset("uniform")
def _uniform(n: int, rng: np.random.Generator):
    P = 8.0 * np.exp(rng.uniform(0.0, np.log(4.0), n)).astype(np.float32)
    B = rng.uniform(0.02, 0.08, n).astype(np.float32)
    return P, B, _tiers_by_speed(P)


@preset("bimodal-edge")
def _bimodal_edge(n: int, rng: np.random.Generator):
    fast = rng.random(n) < 0.3
    P = np.where(fast,
                 rng.lognormal(np.log(16.0), 0.15, n),
                 rng.lognormal(np.log(3.0), 0.25, n)).astype(np.float32)
    B = np.where(fast,
                 rng.uniform(0.01, 0.03, n),
                 rng.uniform(0.05, 0.15, n)).astype(np.float32)
    tier = np.where(fast, 2, rng.integers(0, 2, n)).astype(np.int32)
    return P, B, tier


@preset("longtail-mobile")
def _longtail_mobile(n: int, rng: np.random.Generator):
    P = rng.lognormal(np.log(5.0), 0.7, n).astype(np.float32)
    P = np.clip(P, 0.5, 80.0)
    # Pareto-tailed uplink times: most links fine, a congested tail
    B = (0.02 * (1.0 + rng.pareto(3.0, n))).astype(np.float32)
    B = np.clip(B, 0.02, 0.5)
    return P, B, _tiers_by_speed(P)


@preset("datacenter")
def _datacenter(n: int, rng: np.random.Generator):
    P = np.clip(rng.normal(32.0, 2.0, n), 24.0, 40.0).astype(np.float32)
    B = rng.uniform(0.001, 0.004, n).astype(np.float32)
    return P, B, np.full(n, 2, np.int32)


def make_fleet(preset_name: str, n: int, seed: int = 0) -> Fleet:
    """Sample a fleet of ``n`` devices from a named preset, deterministically
    in ``seed`` (the same (preset, n, seed) always yields the same fleet)."""
    if preset_name not in PRESETS:
        raise KeyError(
            f"unknown fleet preset {preset_name!r}; known: {sorted(PRESETS)}")
    # crc32, not hash(): str hash is salted per process and would break
    # cross-run determinism of the sampled fleet
    rng = np.random.default_rng([zlib.crc32(preset_name.encode()), seed])
    P, B, tier = PRESETS[preset_name](n, rng)
    return Fleet(name=preset_name, P=P, B=B, tier=tier)


def fleet_from_config(fc) -> Fleet:
    """Build a fleet from a :class:`repro_torch.configs.FleetConfig` block."""
    if fc.trace_path:
        return load_trace(fc.trace_path)
    if fc.preset not in PRESETS:
        # an explicit error here (not just make_fleet's KeyError) so config
        # typos name the config field AND the registry
        raise ValueError(
            f"FleetConfig.preset {fc.preset!r} is not a registered fleet "
            f"preset; registered presets: {sorted(PRESETS)}")
    return make_fleet(fc.preset, fc.size, seed=fc.seed)


def make_population(spec, **kwargs):
    """Unified population factory (presets, traces, MobiPerf logs, and
    lazy parametric populations behind one spec).

    A convenience re-export of
    :func:`repro_torch.fleet.population.make_population` so the three fleet
    constructors (:func:`make_fleet`, :func:`load_trace`,
    :func:`load_mobiperf`) share one front door keyed by a spec
    string/dict — see :class:`repro_torch.fleet.population.PopulationSpec` for
    the source forms. Imported lazily: ``population`` depends on this
    module.
    """
    from repro_torch.fleet.population import make_population as _make_population
    return _make_population(spec, **kwargs)


def save_trace(fleet: Fleet, path: str) -> str:
    payload = {"name": fleet.name,
               "devices": [{"P": float(p), "B": float(b), "tier": int(t)}
                           for p, b, t in zip(fleet.P, fleet.B, fleet.tier)]}
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)
    return path


def load_trace(path: str) -> Fleet:
    with open(path) as f:
        payload = json.load(f)
    dev = payload["devices"]
    if not dev:
        raise ValueError(f"trace {path!r} has no devices")
    return Fleet(name=payload.get("name", "trace"),
                 P=np.asarray([d["P"] for d in dev], np.float32),
                 B=np.asarray([d["B"] for d in dev], np.float32),
                 tier=np.asarray([d.get("tier", 1) for d in dev], np.int32))


def load_mobiperf(path: str, *, model_mbits: float = 16.0,
                  rate_per_ghz_core: float = 2.0) -> Fleet:
    """Import a MobiPerf-style measurement log as a :class:`Fleet`.

    MobiPerf-family logs are a flat JSON list of per-measurement records;
    each record names a device and carries network measurements plus
    static device properties::

        [{"device_id": "a1", "timestamp": "...",
          "properties": {"cpu_ghz": 2.4, "cpu_cores": 8, "ram_gb": 8},
          "values": {"tcp_speed_results_kbps": 41800, "rtt_ms": 42.0}},
         ...]

    Records are grouped by ``device_id`` (one fleet device per id) and the
    medians of repeated measurements are mapped onto the paper's model
    formulations:

    * **P_u (B1)**: compute rate ``rate_per_ghz_core * cpu_ghz *
      cpu_cores`` samples/sec per layer — a linear proxy; calibrate
      ``rate_per_ghz_core`` against a measured device if available.
    * **B_u (B2)**: per-round communication time = median RTT plus the
      time to move ``model_mbits`` of update traffic at the median
      measured throughput.
    * **tier**: memory tier from RAM (<3 GB -> 0, <6 GB -> 1, else 2).

    Devices missing throughput or RTT fall back to the slowest observed
    value (a congested-link assumption, matching how MobiPerf treats
    failed probes).
    """
    with open(path) as f:
        records = json.load(f)
    if isinstance(records, dict):
        records = records.get("measurements", [])
    by_dev: dict[str, list] = {}
    for rec in records:
        dev = rec.get("device_id")
        if dev is not None:
            by_dev.setdefault(str(dev), []).append(rec)
    if not by_dev:
        raise ValueError(f"mobiperf log {path!r} has no device_id records")

    def _median(vals, fallback):
        vals = [v for v in vals if v is not None and v > 0]
        return float(np.median(vals)) if vals else fallback

    P, B, tier = [], [], []
    all_kbps = [v for recs in by_dev.values() for r in recs
                if (v := r.get("values", {}).get("tcp_speed_results_kbps"))]
    all_rtt = [v for recs in by_dev.values() for r in recs
               if (v := r.get("values", {}).get("rtt_ms"))]
    worst_kbps = min(all_kbps) if all_kbps else 1000.0
    worst_rtt = max(all_rtt) if all_rtt else 500.0
    for dev in sorted(by_dev):
        recs = by_dev[dev]
        props = {}
        for r in recs:                      # later records override earlier
            props.update(r.get("properties", {}))
        ghz = float(props.get("cpu_ghz", 1.5))
        cores = float(props.get("cpu_cores", 4))
        ram = float(props.get("ram_gb", 4))
        kbps = _median([r.get("values", {}).get("tcp_speed_results_kbps")
                        for r in recs], worst_kbps)
        rtt = _median([r.get("values", {}).get("rtt_ms")
                       for r in recs], worst_rtt)
        P.append(max(rate_per_ghz_core * ghz * cores, 1e-3))
        B.append(rtt / 1e3 + model_mbits * 1e3 / max(kbps, 1.0))
        tier.append(0 if ram < 3 else (1 if ram < 6 else 2))
    return Fleet(name="mobiperf", P=np.asarray(P, np.float32),
                 B=np.asarray(B, np.float32),
                 tier=np.asarray(tier, np.int32))
