"""Per-round cohort sampling from the available population (port of
``repro.fleet.cohort``; numpy only).

Given the availability draw for round ``t`` and the fleet profile, a cohort
sampler picks the (at most) ``U`` distinct devices the round actually
plans for, and ``cohort_view`` re-derives the :class:`AnalysisConfig` the
policies consume — so ``AdelPolicy``/baselines see the *sampled cohort's*
``P``/``B`` each round instead of one static population.

Strategies:

* ``uniform``          — uniform without replacement over available devices.
* ``power-of-choice``  — draw ``oversample * U`` candidates, keep the ``U``
                         fastest by ``P_u`` (compute-capability variant of
                         power-of-choice client selection).
* ``stratified``       — proportional allocation across memory tiers
                         (largest-remainder rounding), uniform within tier;
                         guarantees tier coverage for width/memory studies.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.types import AnalysisConfig
from repro_torch.fleet.profiles import Fleet

__all__ = ["COHORT_STRATEGIES", "sample_cohort", "cohort_view",
           "profile_view"]

COHORT_STRATEGIES = ("uniform", "power-of-choice", "stratified")


def _stratified(rng: np.random.Generator, avail_idx: np.ndarray,
                tier: np.ndarray, U: int) -> np.ndarray:
    tiers, counts = np.unique(tier[avail_idx], return_counts=True)
    quota = U * counts / counts.sum()
    take = np.floor(quota).astype(int)
    # largest-remainder rounding up to exactly U
    for i in np.argsort(-(quota - take)):
        if take.sum() >= U:
            break
        take[i] += 1
    take = np.minimum(take, counts)
    picked = []
    for tr, k in zip(tiers, take):
        pool = avail_idx[tier[avail_idx] == tr]
        picked.append(rng.choice(pool, size=int(k), replace=False))
    out = np.concatenate(picked) if picked else np.empty(0, np.int64)
    # tiers exhausted below quota: top up uniformly from the rest
    if len(out) < U:
        rest = np.setdiff1d(avail_idx, out, assume_unique=False)
        out = np.concatenate(
            [out, rng.choice(rest, size=U - len(out), replace=False)])
    return out


def sample_cohort(rng: np.random.Generator, available: np.ndarray,
                  fleet: Fleet, U: int, strategy: str = "uniform",
                  oversample: int = 2) -> np.ndarray:
    """Pick at most ``U`` distinct available device indices.

    Returns every available device when fewer than ``U`` are reachable
    (the round proceeds with a reduced cohort), and an empty array when
    nobody is.
    """
    avail_idx = np.flatnonzero(np.asarray(available))
    if len(avail_idx) <= U:
        return avail_idx
    if strategy == "uniform":
        return np.sort(rng.choice(avail_idx, size=U, replace=False))
    if strategy == "power-of-choice":
        k = min(len(avail_idx), oversample * U)
        cand = rng.choice(avail_idx, size=k, replace=False)
        return np.sort(cand[np.argsort(-fleet.P[cand])[:U]])
    if strategy == "stratified":
        return np.sort(_stratified(rng, avail_idx, fleet.tier, U))
    raise ValueError(
        f"unknown cohort strategy {strategy!r}; known: {COHORT_STRATEGIES}")


def profile_view(base: AnalysisConfig, P: np.ndarray,
                 B: np.ndarray) -> AnalysisConfig:
    """The round's AnalysisConfig from the cohort's sampled profiles.

    The population-protocol form of :func:`cohort_view`: any
    :class:`repro_torch.fleet.population.Population` hands over the cohort's
    ``(P, B)`` arrays directly (materialized gathers, parametric lazy
    draws) and the view never touches fleet-sized state.
    """
    U = len(P)
    sigma2 = np.full((U,), float(np.mean(base.sigma2)), np.float32)
    return dataclasses.replace(base, U=U, P=np.asarray(P, np.float32),
                               B=np.asarray(B, np.float32), sigma2=sigma2)


def cohort_view(base: AnalysisConfig, fleet: Fleet,
                idx: np.ndarray) -> AnalysisConfig:
    """The round's AnalysisConfig: base constants with the cohort's U/P/B."""
    return profile_view(base, fleet.P[idx], fleet.B[idx])
