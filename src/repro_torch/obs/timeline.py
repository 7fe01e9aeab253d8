"""Render a recorded telemetry stream in the terminal (the port's own copy
of the reference's jax-free ``repro.obs.timeline``).

    PYTHONPATH=src python -m repro_torch.obs.timeline events.jsonl [events2.jsonl ...]

Three sections per stream:

* **phase timeline** — per-round wall-seconds by phase (``cohort`` /
  ``replan`` / ``plan`` / ``stack`` / ``local_train`` / ``aggregate`` /
  ``eval`` / ``checkpoint``), i.e. where each round's host time actually
  went;
* **clock-model ledger** — per-round planned deadline ``T_t``, simulated
  clock, measured wall time, and the exponential model's predictions
  (full-depth completion time, expected backprop depth) against the round's
  realized straggler draw (:mod:`repro_torch.obs.ledger` documents the columns);
* **stragglers / deadline misses** — per-round full/missed/zero-contributor
  counts with the worst miss depth, plus the run-level drift summary.

When the stream carries the backends' split payload counters
(``aggregate_bytes_logical`` / ``aggregate_bytes_wire``) a fourth section
shows per-round bytes on the wire versus the dense-float32 logical payload
and the resulting compression ratio.

Prefetch-pipelined runs (``ExecSpec.pipeline="prefetch"``) add a fifth
section from the round loop's pipeline counters: per-round H2D bytes of
the stacked batches (``h2d_bytes``), worker planning time hidden behind
the device step (``prefetch_overlap_s``), main-thread stalls on the
prefetch future (``dispatch_wait_s``), and the one-off warm-up cost
(``warm_up_s``).
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.obs.ledger import drift_summary, ledger_rows, phase_table
from repro_torch.obs.trace import PHASES

__all__ = ["BYTE_COUNTERS", "PIPELINE_COUNTERS", "bytes_table",
           "counter_table", "load_events", "render", "main"]


def load_events(path: str) -> list[dict]:
    """Parse a JSONL event file, skipping unparseable lines (a crashed run
    leaves a valid prefix; never let one torn line hide the rest)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return out


def _table(headers: list[str], rows: list[list[str]]) -> str:
    widths = [max(len(h), *(len(r[i]) for r in rows)) if rows else len(h)
              for i, h in enumerate(headers)]
    fmt = "  ".join(f"{{:>{w}}}" for w in widths)
    lines = [fmt.format(*headers), fmt.format(*("-" * w for w in widths))]
    lines += [fmt.format(*r) for r in rows]
    return "\n".join(lines)


def _fmt_ms(s: float) -> str:
    return f"{1e3 * s:.1f}"


def _fmt_bytes(b: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(b) < 1024:
            return f"{b:.1f}{unit}"
        b /= 1024
    return f"{b:.1f}TiB"


BYTE_COUNTERS = ("aggregate_bytes_logical", "aggregate_bytes_wire")

# the round loop's counters: stacked-batch H2D bytes (every run), and under
# the prefetch loop the worker's planning time hidden behind the previous
# round's dispatch, main-thread stalls on the prefetch future and the
# one-off warm-up cost
PIPELINE_COUNTERS = ("h2d_bytes", "prefetch_overlap_s", "dispatch_wait_s",
                     "warm_up_s")


def counter_table(records: list[dict],
                  names: tuple) -> dict[int, dict[str, float]]:
    """Per-round totals of the named ``kind="count"`` records:
    ``{round: {counter_name: total}}`` (rounds are 1-based, as stamped by
    the runtime; counter-less streams give an empty dict)."""
    out: dict[int, dict[str, float]] = {}
    for r in records:
        if r.get("kind") != "count" or r.get("name") not in names:
            continue
        rnd = r.get("round")
        if rnd is None:
            continue
        row = out.setdefault(int(rnd), {})
        row[r["name"]] = row.get(r["name"], 0.0) + float(r.get("value", 0))
    return out


def bytes_table(records: list[dict]) -> dict[int, dict[str, float]]:
    """Per-round totals of the split aggregation payload counters."""
    return counter_table(records, BYTE_COUNTERS)


def render(records: list[dict], *, title: str = "") -> str:
    """Render one event stream's three sections as a string."""
    out = []
    if title:
        out.append(f"== {title} ==")

    phases = phase_table(records)
    seen = [p for p in PHASES
            if any(p in row for row in phases.values())]
    extra = sorted({name for row in phases.values() for name in row}
                   - set(seen))
    cols = seen + extra
    if phases:
        rows = []
        for rnd in sorted(phases):
            row = phases[rnd]
            rows.append([str(rnd)] + [(_fmt_ms(row[c]) if c in row else "—")
                                      for c in cols]
                        + [_fmt_ms(sum(row.values()))])
        out.append("\n-- phase timeline (ms of host wall time per round) --")
        out.append(_table(["round"] + cols + ["total"], rows))

    ledger = ledger_rows(records)
    if ledger:
        rows = []
        for r in ledger:
            rows.append([
                str(r.get("round", r.get("t", 0) + 1)),
                f"{r['T_deadline']:.3f}",
                f"{r['sim_total']:.2f}",
                f"{r['wall_round_s']:.3f}",
                (f"{r['pred_full_s']:.3f}" if "pred_full_s" in r else "—"),
                (f"{r['depth_pred']:.2f}" if "depth_pred" in r else "—"),
                f"{r['depth_real']:.2f}",
                (f"{r['p1_pred']:.4f}" if "p1_pred" in r else "—"),
            ])
        out.append("\n-- clock-model ledger "
                   "(deadline vs simulated vs wall vs predicted) --")
        out.append(_table(["round", "T_t", "sim", "wall_s", "pred_full",
                           "depth_pred", "depth_real", "p1_pred"], rows))

        # buffered (semi-async) runs add the carry-buffer columns: what
        # missed-deadline work was folded in / still pending / dropped;
        # hierarchical runs add the per-round edge-region census
        carried = any("carried_in" in r for r in ledger)
        has_regions = any("regions" in r for r in ledger)
        rows = []
        for r in ledger:
            row = [
                str(r.get("round", r.get("t", 0) + 1)),
                str(r.get("available", "—")),
                str(r["cohort"]),
                str(r["full"]),
                str(r["missed"]),
                str(r["zero_contrib"]),
                str(r["worst_miss"]),
                f"{r['batch_real']}/{r['batch_padded']}",
            ]
            if carried:
                stale = r.get("stale") or {}
                row += [
                    str(r.get("carried_in", "—")),
                    str(r.get("carried_out", "—")),
                    str(r.get("carried_dropped", "—")),
                    ",".join(f"{tau}:{n}" for tau, n in
                             sorted(stale.items(),
                                    key=lambda kv: int(kv[0]))) or "—",
                ]
            if has_regions:
                row += [
                    str(r.get("regions", "—")),
                    str(r.get("region_max", "—")),
                    str(r.get("region_pad", "—")),
                ]
            rows.append(row)
        headers = ["round", "avail", "cohort", "full", "missed", "zero",
                   "worst_miss", "batch real/pad"]
        if carried:
            headers += ["carry_in", "carry_out", "dropped", "stale tau:n"]
        if has_regions:
            headers += ["regions", "reg_max", "reg_pad"]
        out.append("\n-- stragglers / deadline misses --")
        out.append(_table(headers, rows))

        drift = drift_summary(ledger)
        if drift:
            out.append("\n-- drift summary --")
            out += [f"  {k:24s} {v}" for k, v in drift.items()]

    bt = bytes_table(records)
    if bt:
        rows = []
        tot_l = tot_w = 0.0
        for rnd in sorted(bt):
            row = bt[rnd]
            logical = row.get("aggregate_bytes_logical", 0.0)
            wire = row.get("aggregate_bytes_wire", 0.0)
            tot_l += logical
            tot_w += wire
            ratio = f"{logical / wire:.2f}x" if wire else "—"
            rows.append([str(rnd), _fmt_bytes(logical), _fmt_bytes(wire),
                         ratio])
        ratio = f"{tot_l / tot_w:.2f}x" if tot_w else "—"
        rows.append(["total", _fmt_bytes(tot_l), _fmt_bytes(tot_w), ratio])
        out.append("\n-- aggregation payload (logical f32 vs bytes on the "
                   "wire) --")
        out.append(_table(["round", "logical", "wire", "ratio"], rows))

    pt = counter_table(records, PIPELINE_COUNTERS)
    if pt:
        rows = []
        tot = {name: 0.0 for name in PIPELINE_COUNTERS}
        for rnd in sorted(pt):
            row = pt[rnd]
            for name in PIPELINE_COUNTERS:
                tot[name] += row.get(name, 0.0)
            rows.append([
                str(rnd),
                (_fmt_bytes(row["h2d_bytes"]) if "h2d_bytes" in row
                 else "—"),
                (_fmt_ms(row["prefetch_overlap_s"])
                 if "prefetch_overlap_s" in row else "—"),
                (_fmt_ms(row["dispatch_wait_s"])
                 if "dispatch_wait_s" in row else "—"),
                (_fmt_ms(row["warm_up_s"]) if "warm_up_s" in row else "—"),
            ])
        rows.append(["total", _fmt_bytes(tot["h2d_bytes"]),
                     _fmt_ms(tot["prefetch_overlap_s"]),
                     _fmt_ms(tot["dispatch_wait_s"]),
                     _fmt_ms(tot["warm_up_s"])])
        out.append("\n-- pipeline (H2D bytes, hidden planning ms, prefetch "
                   "stall ms, warm-up ms) --")
        out.append(_table(["round", "h2d", "overlap", "stall", "warm_up"],
                          rows))
    if len(out) <= (1 if title else 0):
        out.append("(no span or round records found)")
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("events", nargs="+",
                    help="JSONL event file(s) written by repro_torch.obs.JsonlSink")
    args = ap.parse_args(argv)
    status = 0
    for path in args.events:
        try:
            records = load_events(path)
        except OSError as e:
            print(f"[timeline] cannot read {path}: {e}", file=sys.stderr)
            status = 1
            continue
        print(render(records, title=path))
        print()
    return status


if __name__ == "__main__":
    raise SystemExit(main())
