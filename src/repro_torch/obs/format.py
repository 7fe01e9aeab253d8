"""One formatting path for round telemetry (the port's own copy of the
reference's jax-free ``repro.obs.format``).

``RoundRuntime`` builds each per-round record ONCE and routes it both to
the tracer's sinks and — when ``verbose=True`` — through these formatters
to the console, so the printed numbers and the recorded numbers can never
drift apart. ``python -m repro_torch.obs.timeline`` reuses the same helpers to
render recorded streams.
"""
from __future__ import annotations

__all__ = ["format_eval", "format_replan"]


def format_eval(method: str, rec: dict) -> str:
    """The per-eval progress line (the former ``RoundRuntime.run`` verbose
    print, now rendered from the recorded event fields)."""
    fleet_bit = ""
    if rec.get("available") is not None:
        fleet_bit = (f"avail {rec['available']:4d} "
                     f"cohort {rec['cohort']:3d} ")
    return (f"[{method}] round {rec['round']:3d} {fleet_bit}"
            f"time {rec['sim_total']:9.2f} "
            f"deadline {rec['T_deadline']:7.3f} acc {rec['acc']:.4f}")


def format_replan(method: str, rec: dict) -> str:
    """The mid-run re-solve line, rendered from a ``ReplanEvent`` dict."""
    return (f"[{method}] replan @ round {rec['round'] + 1}: "
            f"reachable {rec['reachable']} -> U_est {rec['U_est']}, "
            f"m {rec['m']:.2f}, "
            f"T_tail[{len(rec['T_tail'])}] sum {sum(rec['T_tail']):.2f}")
