"""Clock-model ledger: predicted vs simulated vs measured round time (the
port's own copy of the reference's jax-free ``repro.obs.ledger``).

ADEL-FL's Problem-2 solver prices every round with the exponential compute
model (Appendix A / Model Formulations B1-B3): user ``u`` finishes one
layer-gradient in ``Exp(S_u / P_u)`` time, so within the effective deadline
``T_t - B_u`` it completes ``z_u ~ Poisson(lambda_u)`` layers with
``lambda_u = P_u / S_u * (T_t - B_u)``. The ledger records, per executed
round, the three clocks that model implies and the two it cannot see:

* ``T_deadline``    — the planned deadline ``T_t`` (what the solver spent),
* ``sim_total``     — the simulated R1/R2 clock after the round,
* ``wall_round_s``  — measured host wall time of the round (monotonic).
  Under the prefetch pipeline (``ExecSpec.pipeline="prefetch"``) the
  round's host planning phases ran DURING the previous round's device
  step, so ``wall_round_s`` covers only consume + dispatch + device work;
  the hidden planning time lands in the ``prefetch_overlap_s`` counter
  (:mod:`repro_torch.obs.timeline` renders both),
* ``pred_full_s``   — the model's expected FULL-depth completion time
  ``max_u (B_u + L * S_u / P_u)``: how long a synchronized-wait server
  would expect to wait for this cohort (the deadline's counterfactual),
* ``depth_pred`` vs ``depth_real`` — the model's expected completed
  backprop depth ``E[min(z_u, L)]`` against the depth of the round's
  actual straggler draw (``mask.sum(1)``), the drift statistic that
  quantifies how well the solver's cost model matches execution.

It also tabulates the deadline misses the delayed-gradient / async work
(ROADMAP item 2) needs: per round, how many clients finished all ``L``
layers, how many missed (and by how many layers at worst), and how many
contributed nothing at all — with the model's own ``p_t^1`` prediction
alongside the realized layer-1 outcome.

:func:`round_record` builds one ledger row inside the runtime (only when a
tracer is active); :func:`drift_summary` reduces the rows to run-level
drift statistics; :func:`ledger_rows` / :func:`phase_table` re-derive both
from a recorded JSONL event stream (``python -m repro_torch.obs.timeline``).
Everything here is plain numpy — no jax, no runtime imports — so the
report/timeline tooling stays importable anywhere.
"""
from __future__ import annotations

import numpy as np

__all__ = ["expected_depth", "round_record", "ledger_rows", "phase_table",
           "drift_summary"]


def expected_depth(lam: np.ndarray, L: int) -> np.ndarray:
    """``E[min(z, L)]`` for ``z ~ Poisson(lam)``, elementwise.

    Uses ``E[min(z, L)] = sum_{j=0}^{L-1} P(z > j)`` with the Poisson pmf
    accumulated iteratively — exact, vectorized, and cheap for the layer
    counts models ship (L <= a few hundred).
    """
    lam = np.asarray(lam, np.float64)
    pmf = np.exp(-lam)                    # P(z = 0)
    cdf = pmf.copy()
    out = np.zeros_like(lam)
    for j in range(int(L)):
        out += 1.0 - np.minimum(cdf, 1.0)     # P(z > j)
        pmf = pmf * lam / float(j + 1)        # P(z = j+1)
        cdf = cdf + pmf
    return out


def round_record(*, t: int, plan, cfg, L: int, U_act: int, U_pad: int,
                 s_max: int, sim_total: float, wall_round_s: float,
                 wall_total_s: float, available=None, carry=None,
                 regions=None) -> dict:
    """One clock-model ledger row for executed round ``t`` (0-based).

    ``plan`` is the round's :class:`repro_torch.core.baselines.RoundPlan`;
    ``cfg`` the planning view the policy used (the cohort view when the
    fleet re-derived one, else the policy's static config) — its ``P``/``B``
    describe the round's clients, which is what makes the model-side
    predictions computable. When the view's population does not line up
    with the executed cohort (defensive: custom sources), the prediction
    fields are omitted rather than fabricated.

    ``carry`` is the buffered (semi-async) backend's per-round carry stats
    (``ExecutionBackend.last_carry``): ``carried_in`` — buffered client
    contributions folded into THIS round's update, ``carried_out`` — still
    pending in the buffer after the round, ``carried_dropped`` — expired
    (``> max_age``) or ring-evicted, and ``stale`` — the staleness
    histogram ``{tau: count}`` of this round's folds. The columns land
    next to ``depth_real`` so the clock ledger shows where missed-deadline
    work went.

    ``regions`` is the hierarchical backend's per-round region census
    (``ExecutionBackend.last_regions``): ``regions`` — edge regions this
    round actually folded, ``region_max`` — widest region census,
    ``region_pad`` — the padded gather width each region executed at.
    """
    mask = np.asarray(plan.mask, np.float32)[:U_act]          # (U_act, L)
    S = np.asarray(plan.batch_sizes, np.float64)[:U_act]      # (U_act,)
    depth = mask.sum(axis=1)                                  # (U_act,)
    T_t = float(plan.elapsed)
    rec = {
        "t": int(t),
        "T_deadline": T_t,
        "sim_round": T_t,
        "sim_total": float(sim_total),
        "wall_round_s": round(float(wall_round_s), 6),
        "wall_total_s": round(float(wall_total_s), 6),
        "cohort": int(U_act),
        "padded": int(U_pad),
        "batch_real": int(np.minimum(S, float(s_max)).sum()),
        "batch_padded": int(U_pad * s_max),
        "depth_real": round(float(depth.mean()), 4),
        "full": int((depth >= L).sum()),
        "missed": int((depth < L).sum()),
        "zero_contrib": int((depth == 0).sum()),
        "worst_miss": int(L - depth.min()) if U_act else 0,
        "layer1_zero": bool(mask[:, 0].sum() == 0) if U_act else True,
    }
    if available is not None:
        rec["available"] = int(available)
    if carry is not None:
        rec["carried_in"] = int(carry.get("carried_in", 0))
        rec["carried_out"] = int(carry.get("carried_out", 0))
        rec["carried_dropped"] = int(carry.get("carried_dropped", 0))
        # JSON object keys are strings; normalize so round-tripped rows
        # and in-process rows aggregate identically
        rec["stale"] = {str(k): int(v)
                        for k, v in (carry.get("stale") or {}).items()}
    if regions is not None:
        rec["regions"] = int(regions.get("regions", 1))
        rec["region_max"] = int(regions.get("region_max", U_act))
        rec["region_pad"] = int(regions.get("region_pad", U_act))
    p = np.asarray(plan.p, np.float64)
    if p.size:
        rec["p1_pred"] = float(p[0])
    P = np.asarray(getattr(cfg, "P", ()), np.float64)
    B = np.asarray(getattr(cfg, "B", ()), np.float64)
    if P.shape == S.shape and B.shape == S.shape and T_t > 0:
        lam = P / np.maximum(S, 1.0) * np.maximum(T_t - B, 0.0)
        rec["depth_pred"] = round(float(expected_depth(lam, L).mean()), 4)
        full_s = B + L * S / np.maximum(P, 1e-9)
        rec["pred_full_s"] = round(float(full_s.max()), 4)
        rec["pred_full_mean_s"] = round(float(full_s.mean()), 4)
    return rec


def ledger_rows(records) -> list[dict]:
    """The ``kind="round"`` ledger rows of an event-record iterable."""
    return [r for r in records if r.get("kind") == "round"]


def phase_table(records) -> dict:
    """``{round: {phase: total_s}}`` over the span records of an event
    stream (round None — spans outside any round — keys as 0)."""
    out: dict[int, dict] = {}
    for r in records:
        if r.get("kind") != "span":
            continue
        rnd = int(r.get("round") or 0)
        row = out.setdefault(rnd, {})
        row[r["name"]] = row.get(r["name"], 0.0) + float(r["dur_s"])
    return out


def drift_summary(rows) -> dict:
    """Run-level drift statistics over the ledger rows.

    ``depth_drift_*``: realized minus model-predicted mean backprop depth —
    positive means clients got further than the exponential model priced,
    negative means the model was optimistic. ``wall_per_sim``: measured
    host-seconds per simulated clock unit (the exchange rate between the
    two clocks; steady means the simulation is a faithful relative clock).
    ``miss_rate`` / ``zero_rate``: fraction of client-rounds that missed
    full depth / contributed nothing. ``p1_pred_mean`` vs
    ``layer1_zero_rate``: the Lemma-1-style zero-contributor probability
    against its realized frequency.
    """
    rows = [r for r in rows if "T_deadline" in r]
    if not rows:
        return {}
    out: dict = {"rounds": len(rows)}
    drifts = [r["depth_real"] - r["depth_pred"] for r in rows
              if "depth_pred" in r]
    if drifts:
        out["depth_drift_mean"] = round(float(np.mean(drifts)), 4)
        out["depth_drift_max_abs"] = round(float(np.max(np.abs(drifts))), 4)
    walls = np.asarray([r["wall_round_s"] for r in rows], np.float64)
    sims = np.asarray([r["sim_round"] for r in rows], np.float64)
    ok = sims > 0
    if ok.any():
        per = walls[ok] / sims[ok]
        out["wall_per_sim_mean"] = round(float(per.mean()), 6)
        out["wall_per_sim_max"] = round(float(per.max()), 6)
    clients = sum(r["cohort"] for r in rows)
    if clients:
        out["miss_rate"] = round(sum(r["missed"] for r in rows) / clients, 4)
        out["zero_rate"] = round(
            sum(r["zero_contrib"] for r in rows) / clients, 4)
    p1 = [r["p1_pred"] for r in rows if "p1_pred" in r]
    if p1:
        out["p1_pred_mean"] = round(float(np.mean(p1)), 6)
        out["layer1_zero_rate"] = round(
            float(np.mean([r["layer1_zero"] for r in rows])), 4)
    preds = [r["pred_full_s"] for r in rows if "pred_full_s" in r]
    if preds:
        # how much simulated time the deadline saved vs synchronized wait
        out["deadline_vs_full_wait"] = round(
            float(sum(r["T_deadline"] for r in rows) / max(sum(preds),
                                                           1e-9)), 4)
    carried = [r for r in rows if "carried_in" in r]
    if carried:
        out["carried_in_total"] = int(sum(r["carried_in"] for r in carried))
        out["carried_dropped_total"] = int(
            sum(r.get("carried_dropped", 0) for r in carried))
        out["carried_peak"] = int(max(r["carried_out"] for r in carried))
        stale_n = stale_sum = 0
        for r in carried:
            for tau, n in (r.get("stale") or {}).items():
                stale_n += int(n)
                stale_sum += int(n) * float(tau)
        if stale_n:
            out["stale_mean"] = round(stale_sum / stale_n, 4)
    reg = [r for r in rows if "regions" in r]
    if reg:
        out["regions_max"] = int(max(r["regions"] for r in reg))
        # gathered client-slots per real client: how much padded work the
        # two-tier fold executed relative to a flat reduction
        out["region_pad_overhead"] = round(float(np.mean(
            [r["regions"] * r["region_pad"] / max(r["cohort"], 1)
             for r in reg])), 4)
    return out
