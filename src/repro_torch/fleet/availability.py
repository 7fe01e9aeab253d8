"""Pluggable availability / churn models for simulated device fleets (port
of ``repro.fleet.availability``; numpy only).

Each model answers, per round ``t``, which devices are reachable:
``step(t) -> bool (n,)``. Models are stateful where the dynamics demand it
(Markov on/off chains carry per-device state between rounds) and fully
deterministic given their seed and the sequence of ``step`` calls;
``reset()`` rewinds to the initial state.

* ``always-on``  — every device reachable every round (the paper's setting).
* ``bernoulli``  — iid per-device, per-round reachability with rate ``rate``.
* ``diurnal``    — sine-wave day/night cycle: availability probability
                   ``mean + amplitude * sin(2 pi t / period + phase_u)``
                   with a per-device phase (devices live in time zones).
                   ``phase_spread`` narrows the time-zone spread: at the
                   default ``2 pi`` phases wash out fleet-wide, while small
                   spreads synchronize the population (one dominant time
                   zone) so the REACHABLE COUNT itself oscillates — the
                   churn regime online deadline re-planning targets.
* ``markov``     — per-device on/off Markov chain with transition probs
                   ``p_off_to_on`` / ``p_on_to_off``; stationary availability
                   is ``p_off_to_on / (p_off_to_on + p_on_to_off)``, and
                   outages are temporally correlated (sticky churn).

Every model also exposes the expected-reachable distribution consumed by
the re-planning subsystem (:mod:`repro_torch.core.replan`): ``reachable_probs(t)``
gives each device's marginal reachability probability in a future round
``t`` conditioned on the model's current state, and ``expected_reachable(t0,
horizon)`` the expected reachable counts for the next ``horizon`` rounds.

For populations too large to instantiate a per-device model
(:class:`repro_torch.fleet.population.ParametricPopulation`), every class also
answers the STATELESS fleet-wide marginal rate ``marginal_rate(t,
**kwargs)`` — the probability a generic device is reachable in round ``t``
with per-device state (Markov stickiness, diurnal phases) averaged out:

* ``always-on`` — 1.
* ``bernoulli`` — ``rate``.
* ``diurnal``   — the per-device probability averaged over the phase
  distribution U(0, phase_spread), clipped to [0, 1] after averaging (the
  per-device clip is approximated; exact when ``mean +- amplitude`` stays
  inside [0, 1]).
* ``markov``    — the stationary rate (temporal correlation averaged out).
"""
from __future__ import annotations

import numpy as np

__all__ = ["AvailabilityModel", "AlwaysOn", "Bernoulli", "Diurnal", "Markov",
           "AVAILABILITY", "make_availability"]


class AvailabilityModel:
    """Base class: deterministic in (seed, step-call sequence)."""

    name = "base"

    def __init__(self, n: int, seed: int = 0):
        self.n = int(n)
        self.seed = int(seed)
        self.reset()

    def reset(self) -> None:
        self._rng = np.random.default_rng([1021, self.seed])
        self._init_state()

    def _init_state(self) -> None:
        pass

    def step(self, t: int) -> np.ndarray:  # pragma: no cover
        """Reachability of every device in round ``t`` -> bool (n,)."""
        raise NotImplementedError

    def reachable_probs(self, t: int) -> np.ndarray:  # pragma: no cover
        """Per-device probability of being reachable in round ``t`` given
        the model's current state -> float (n,)."""
        raise NotImplementedError

    def expected_reachable(self, t0: int, horizon: int = 1) -> np.ndarray:
        """Expected reachable-device count for rounds ``t0..t0+horizon-1``.

        The population estimator behind availability-aware deadline
        re-planning: ``sum_u P(device u reachable in round t)`` per round.
        """
        return np.asarray([float(self.reachable_probs(t0 + k).sum())
                           for k in range(horizon)])

    def describe(self) -> dict:
        return {"name": self.name, "n": self.n}

    @classmethod
    def marginal_rate(cls, t: int, **kwargs) -> float:  # pragma: no cover
        """Stateless fleet-wide reachability rate at round ``t`` (see the
        module docstring) — the analytic hook parametric populations use
        instead of instantiating an ``n``-device model."""
        raise NotImplementedError


class AlwaysOn(AvailabilityModel):
    name = "always-on"

    def step(self, t: int) -> np.ndarray:
        return np.ones(self.n, bool)

    def reachable_probs(self, t: int) -> np.ndarray:
        return np.ones(self.n)

    @classmethod
    def marginal_rate(cls, t: int, **kwargs) -> float:
        return 1.0


class Bernoulli(AvailabilityModel):
    name = "bernoulli"

    def __init__(self, n: int, seed: int = 0, rate: float = 0.8):
        self.rate = float(rate)
        super().__init__(n, seed)

    def step(self, t: int) -> np.ndarray:
        return self._rng.random(self.n) < self.rate

    def reachable_probs(self, t: int) -> np.ndarray:
        return np.full(self.n, self.rate)

    @classmethod
    def marginal_rate(cls, t: int, rate: float = 0.8, **kwargs) -> float:
        return float(rate)

    def describe(self) -> dict:
        return {"name": self.name, "n": self.n, "rate": self.rate}


class Diurnal(AvailabilityModel):
    name = "diurnal"

    def __init__(self, n: int, seed: int = 0, mean: float = 0.65,
                 amplitude: float = 0.3, period: float = 24.0,
                 phase_spread: float = 2.0 * np.pi):
        self.mean = float(mean)
        self.amplitude = float(amplitude)
        self.period = float(period)
        self.phase_spread = float(phase_spread)
        super().__init__(n, seed)

    def _init_state(self) -> None:
        self.phase = self._rng.uniform(0.0, self.phase_spread, self.n)

    def prob(self, t: int) -> np.ndarray:
        raw = self.mean + self.amplitude * np.sin(
            2.0 * np.pi * t / self.period + self.phase)
        return np.clip(raw, 0.0, 1.0)

    def step(self, t: int) -> np.ndarray:
        return self._rng.random(self.n) < self.prob(t)

    def reachable_probs(self, t: int) -> np.ndarray:
        return self.prob(t)

    @classmethod
    def marginal_rate(cls, t: int, mean: float = 0.65,
                      amplitude: float = 0.3, period: float = 24.0,
                      phase_spread: float = 2.0 * np.pi,
                      **kwargs) -> float:
        """Phase-averaged rate: E_phi[mean + amplitude sin(a + phi)] with
        phi ~ U(0, phase_spread) integrates to amplitude (cos a -
        cos(a + spread)) / spread; the [0, 1] clip is applied AFTER the
        phase average (see the module docstring for the approximation)."""
        a = 2.0 * np.pi * float(t) / float(period)
        spread = max(float(phase_spread), 1e-9)
        mean_sin = (np.cos(a) - np.cos(a + spread)) / spread
        return float(np.clip(float(mean) + float(amplitude) * mean_sin,
                             0.0, 1.0))

    def describe(self) -> dict:
        return {"name": self.name, "n": self.n, "mean": self.mean,
                "amplitude": self.amplitude, "period": self.period,
                "phase_spread": round(self.phase_spread, 4)}


class Markov(AvailabilityModel):
    name = "markov"

    def __init__(self, n: int, seed: int = 0, p_off_to_on: float = 0.3,
                 p_on_to_off: float = 0.1):
        self.p_up = float(p_off_to_on)
        self.p_down = float(p_on_to_off)
        super().__init__(n, seed)

    @property
    def stationary(self) -> float:
        return self.p_up / max(self.p_up + self.p_down, 1e-12)

    def _init_state(self) -> None:
        # start from the stationary distribution so rates hold from round 0
        self.state = self._rng.random(self.n) < self.stationary
        self._t = -1          # round of the last step() (state's timestamp)

    def step(self, t: int) -> np.ndarray:
        u = self._rng.random(self.n)
        self.state = np.where(self.state, u >= self.p_down, u < self.p_up)
        self._t = int(t)
        return self.state.copy()

    def reachable_probs(self, t: int) -> np.ndarray:
        """k-step-ahead marginal: geometric relaxation of the current state
        toward the stationary rate with factor (1 - p_up - p_down)^k."""
        k = max(int(t) - self._t, 0)
        lam = (1.0 - self.p_up - self.p_down) ** k
        return self.stationary + (self.state.astype(float)
                                  - self.stationary) * lam

    @classmethod
    def marginal_rate(cls, t: int, p_off_to_on: float = 0.3,
                      p_on_to_off: float = 0.1, **kwargs) -> float:
        """Stationary rate — the chain's temporal stickiness is averaged
        out (states started from the stationary distribution stay there
        marginally)."""
        return float(p_off_to_on) / max(float(p_off_to_on)
                                        + float(p_on_to_off), 1e-12)

    def describe(self) -> dict:
        return {"name": self.name, "n": self.n, "p_off_to_on": self.p_up,
                "p_on_to_off": self.p_down}


AVAILABILITY = {m.name: m for m in (AlwaysOn, Bernoulli, Diurnal, Markov)}


def make_availability(name: str, n: int, seed: int = 0,
                      **kwargs) -> AvailabilityModel:
    if name not in AVAILABILITY:
        raise KeyError(
            f"unknown availability model {name!r}; known: {sorted(AVAILABILITY)}")
    return AVAILABILITY[name](n, seed=seed, **kwargs)
