"""``repro_torch.obs`` — structured telemetry for the round runtime (port of
``repro.obs``).

Dependency-free tracing (:mod:`repro_torch.obs.trace`), the clock-model
ledger quantifying how well the Problem-2 cost model tracks execution
(:mod:`repro_torch.obs.ledger`), one shared formatting path
(:mod:`repro_torch.obs.format`), and a terminal timeline renderer
(``python -m repro_torch.obs.timeline events.jsonl``).

Instrumented producers take a single ``tracer=`` hook (default
:data:`NULL_TRACER`, zero overhead): :class:`repro_torch.fl.runtime.
RoundRuntime` (and ``run_federated``) emits phase spans, counters, and one
ledger event per executed round; the :mod:`repro_torch.fl.backends`
execution backends emit ``local_train`` / ``aggregate`` spans and
bytes-aggregated counters.
"""
from repro_torch.obs.format import format_eval, format_replan
from repro_torch.obs.ledger import (drift_summary, expected_depth,
                                    ledger_rows, phase_table, round_record)
from repro_torch.obs.trace import (NULL_TRACER, PHASES, JsonlSink,
                                   MemorySink, NullTracer, Sink, Span, Tracer,
                                   make_tracer, now, tree_bytes)

__all__ = [
    "now", "PHASES", "Sink", "MemorySink", "JsonlSink", "Span", "Tracer",
    "NullTracer", "NULL_TRACER", "make_tracer", "tree_bytes",
    "round_record", "ledger_rows", "phase_table", "drift_summary",
    "expected_depth", "format_eval", "format_replan",
]
