"""Lightweight, dependency-free tracing core for the round runtime, in
PyTorch (port of ``repro.obs.trace``).

A :class:`Tracer` records three kinds of structured events:

* **phase spans** — nestable, monotonic-clock timed sections
  (``cohort`` / ``plan`` / ``stack`` / ``local_train`` / ``aggregate`` /
  ``eval``), emitted on span exit with duration, nesting depth, parent
  phase, and a global sequence number;
* **typed counters / gauges** — monotonically accumulated counts
  (padded-vs-real batch elements, bytes aggregated per backend, stacked
  H2D bytes) and last-value gauges (cohort size);
* **ledger events** — one ``kind="round"`` record per executed round
  carrying the clock-model ledger fields (:mod:`repro_torch.obs.ledger`).

Every record is a plain dict fanned out to the attached sinks:
:class:`JsonlSink` appends JSON lines to a file (the
``python -m repro_torch.obs.timeline`` input), :class:`MemorySink` keeps
them in a list (tests, in-process consumers).

The default tracer everywhere is the :data:`NULL_TRACER` singleton — every
method is a no-op, ``active`` is False so instrumented call sites skip
record construction entirely, and trajectories are bit-identical with or
without it (tracing never touches the draws or numerics). An active tracer
only adds ``torch.cuda.synchronize`` fences on a CUDA device, so span
durations measure the card's work instead of asynchronous launches.

All span timing flows through :func:`now` (``time.perf_counter``).
"""
from __future__ import annotations

import io
import json
import os
import time
from typing import Any, Callable, Optional

import torch

from repro_torch.tree import tree_leaves

__all__ = ["now", "PHASES", "Sink", "MemorySink", "JsonlSink", "Span",
           "Tracer", "NullTracer", "NULL_TRACER", "make_tracer",
           "tree_bytes"]

# canonical phase order of one federated round (timeline rendering order);
# warm_up is the prefetch loop's; checkpoint is the reference's name for
# the LM training loop's saves (``launch/train.py``), which neither package
# wraps in a span: it keeps its place in the order
PHASES = ("warm_up", "cohort", "replan", "plan", "stack", "local_train",
          "aggregate", "eval", "checkpoint")


def now() -> float:
    """Monotonic timestamp in seconds (``time.perf_counter``)."""
    return time.perf_counter()


def tree_bytes(tree: Any) -> int:
    """Total buffer bytes across a pytree's tensor leaves."""
    return sum(leaf.numel() * leaf.element_size()
               for leaf in tree_leaves(tree) if isinstance(leaf, torch.Tensor))


def _json_default(o):
    """Best-effort JSON coercion for numpy / torch scalars and arrays."""
    if hasattr(o, "tolist"):
        return o.tolist()
    if hasattr(o, "item"):
        return o.item()
    return str(o)


class Sink:
    """Consumer of telemetry records (plain dicts)."""

    def emit(self, rec: dict) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    def close(self) -> None:
        pass


class MemorySink(Sink):
    """Keeps every record in ``self.records`` (tests, in-process readers)."""

    def __init__(self):
        self.records: list[dict] = []

    def emit(self, rec: dict) -> None:
        self.records.append(rec)


class JsonlSink(Sink):
    """Appends one JSON object per record to ``path`` (created eagerly so a
    crashed run still leaves a parseable prefix)."""

    def __init__(self, path: str):
        self.path = path
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        self._f: Optional[io.TextIOBase] = open(path, "w")

    def emit(self, rec: dict) -> None:
        if self._f is not None:
            self._f.write(json.dumps(rec, default=_json_default) + "\n")

    def close(self) -> None:
        if self._f is not None:
            self._f.flush()
            self._f.close()
            self._f = None


class Span:
    """One nestable timed phase; emitted as a record when the span exits."""

    __slots__ = ("_tr", "name", "attrs", "t0")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self._tr = tracer
        self.name = name
        self.attrs = attrs

    def __enter__(self) -> "Span":
        self._tr._stack.append(self.name)
        self.t0 = self._tr.clock()
        return self

    def __exit__(self, *exc) -> bool:
        tr = self._tr
        t1 = tr.clock()
        tr._stack.pop()
        rec = {"kind": "span", "name": self.name,
               "round": tr._round,
               "t0": self.t0, "dur_s": t1 - self.t0,
               "depth": len(tr._stack),
               "parent": tr._stack[-1] if tr._stack else None,
               "seq": tr._next_seq()}
        if self.attrs:
            rec.update(self.attrs)
        tr._note_span(rec)
        tr._emit(rec)
        return False


class Tracer:
    """Collects spans / counters / gauges / events and fans them out to
    sinks, while aggregating an in-memory summary (per-phase totals,
    counter totals, the per-round clock-model ledger).

    ``clock`` is injectable for deterministic tests; it defaults to the
    monotonic :func:`now`.
    """

    active = True

    def __init__(self, sinks: Any = (), *, clock: Callable[[], float] = now):
        if isinstance(sinks, Sink):
            sinks = (sinks,)
        self.sinks: list[Sink] = list(sinks)
        self.clock = clock
        self._stack: list[str] = []
        self._seq = 0
        self._round: Optional[int] = None
        # aggregated summary state
        self.phase_totals: dict[str, dict] = {}
        self.counters: dict[str, float] = {}
        self.gauges: dict[str, float] = {}
        self.rounds: list[dict] = []       # kind="round" ledger records

    # ------------------------------------------------------------------
    def _next_seq(self) -> int:
        self._seq += 1
        return self._seq

    def _emit(self, rec: dict) -> None:
        for s in self.sinks:
            s.emit(rec)

    def _note_span(self, rec: dict) -> None:
        agg = self.phase_totals.setdefault(rec["name"],
                                           {"count": 0, "total_s": 0.0})
        agg["count"] += 1
        agg["total_s"] += rec["dur_s"]

    # ------------------------------------------------------------------
    def set_round(self, t: Optional[int]) -> None:
        """Stamp subsequent records with round number ``t`` (1-based)."""
        self._round = t

    def span(self, name: str, **attrs) -> Span:
        return Span(self, name, attrs)

    def span_record(self, name: str, t0: float, dur_s: float,
                    **attrs) -> None:
        """Emit a span measured elsewhere, with a :class:`Span` exit's
        record shape; nesting fields reflect the emission point."""
        rec = {"kind": "span", "name": name, "round": self._round,
               "t0": t0, "dur_s": dur_s,
               "depth": len(self._stack),
               "parent": self._stack[-1] if self._stack else None,
               "seq": self._next_seq()}
        if attrs:
            rec.update(attrs)
        self._note_span(rec)
        self._emit(rec)

    def count(self, name: str, value: float = 1, **attrs) -> None:
        self.counters[name] = self.counters.get(name, 0) + value
        self._emit({"kind": "count", "name": name, "round": self._round,
                    "value": value, **attrs})

    def gauge(self, name: str, value: float, **attrs) -> None:
        self.gauges[name] = value
        self._emit({"kind": "gauge", "name": name, "round": self._round,
                    "value": value, **attrs})

    def event(self, kind: str, **fields) -> None:
        rec = {"kind": kind, "round": self._round, **fields}
        if kind == "round":
            self.rounds.append(rec)
        self._emit(rec)

    # ------------------------------------------------------------------
    def summary(self) -> dict:
        """JSON-ready aggregate: per-phase wall totals, counter totals, the
        per-round clock-model ledger, and its drift statistics
        (:func:`repro_torch.obs.ledger.drift_summary`)."""
        from repro_torch.obs.ledger import drift_summary
        phases = {name: {"count": int(d["count"]),
                         "total_s": round(float(d["total_s"]), 6)}
                  for name, d in self.phase_totals.items()}
        ledger = [{k: v for k, v in r.items() if k != "kind"}
                  for r in self.rounds]
        return {"phases": phases,
                "counters": {k: (int(v) if float(v).is_integer() else
                                 round(float(v), 6))
                             for k, v in self.counters.items()},
                "gauges": {k: float(v) for k, v in self.gauges.items()},
                "ledger": ledger,
                "drift": drift_summary(self.rounds)}

    def close(self) -> None:
        for s in self.sinks:
            s.close()


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    """Do-nothing tracer: the zero-overhead default everywhere.

    ``active`` is False so instrumented call sites skip building records /
    synchronizing the device entirely; the remaining per-call cost is one
    attribute check plus a no-op context manager.
    """

    active = False

    def set_round(self, t) -> None:
        pass

    def span(self, name: str, **attrs) -> _NullSpan:
        return _NULL_SPAN

    def span_record(self, name: str, t0: float, dur_s: float,
                    **attrs) -> None:
        pass

    def count(self, name: str, value: float = 1, **attrs) -> None:
        pass

    def gauge(self, name: str, value: float, **attrs) -> None:
        pass

    def event(self, kind: str, **fields) -> None:
        pass

    def summary(self) -> dict:
        return {}

    def close(self) -> None:
        pass


NULL_TRACER = NullTracer()


def make_tracer(events: Optional[str] = None, *,
                sinks: Any = None) -> Tracer | NullTracer:
    """A :class:`Tracer` writing JSONL to ``events`` (and/or the given
    sinks), or the :data:`NULL_TRACER` when neither is given."""
    out: list[Sink] = []
    if events:
        out.append(JsonlSink(events))
    if sinks is not None:
        out.extend((sinks,) if isinstance(sinks, Sink) else list(sinks))
    if not out:
        return NULL_TRACER
    return Tracer(out)
