"""Spawned ``torch.distributed`` ranks for the port's tests.

:func:`spawn` runs one task of this module in ``world`` processes joined
by a gloo group over a ``FileStore`` under a test's ``tmp_path``; the
payload and each rank's result travel as ``torch.save`` files. The tasks
import only ``torch`` and ``repro_torch``: the parent holds the results
against the reference. Any rank that fails, or does not finish within the
timeout, fails the caller.
"""
from __future__ import annotations

import multiprocessing
import os

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["spawn", "ReplayDraws", "shard_map_cases"]

TIMEOUT_S = 300


def _rank_main(task: str, rank: int, world: int, tmp: str) -> None:
    torch.set_num_threads(1)          # the ranks share the host's cores
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        payload = torch.load(os.path.join(tmp, "payload.pt"),
                             weights_only=False)
        out = globals()[task](rank, world, payload)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(task: str, world: int, tmp_path, payload) -> list:
    """Run ``task(rank, world, payload)`` on ``world`` spawned gloo ranks;
    returns the ranks' results in rank order."""
    tmp = str(tmp_path)
    torch.save(payload, os.path.join(tmp, "payload.pt"))
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(task, r, world, tmp))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(TIMEOUT_S)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(10)
    codes = [p.exitcode for p in procs]
    if codes != [0] * world:
        raise RuntimeError(f"{task}: rank exit codes {codes}")
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


class ReplayDraws:
    """A draw source replaying precomputed draws: each round's Poisson
    depths ``z[t]`` and minibatch indices ``idx[t]`` (the reference's, made
    in the parent); ``gen`` is never read when ``init_params`` is given."""

    def __init__(self, z, idx):
        self.z, self.idx = z, idx
        self.gen = torch.Generator().manual_seed(0)

    def poisson(self, t, lam):
        return torch.as_tensor(self.z[t])

    def batch_indices(self, t, U, s_max):
        idx = torch.as_tensor(self.idx[t])
        assert tuple(idx.shape) == (U, s_max), (idx.shape, U, s_max)
        return idx


def _history(hist) -> dict:
    d = hist.as_dict()
    d.pop("telemetry")
    return d


def _byte_totals(summary: dict) -> dict:
    return {k: v for k, v in summary.get("counters", {}).items()
            if k.startswith("aggregate_bytes")}


def _numpy(tree) -> list:
    from repro_torch.tree import tree_leaves
    return [t.detach().numpy().copy() for t in tree_leaves(tree)]


def shard_map_cases(rank: int, world: int, payload: dict) -> dict:
    """Every multi-rank case of ``tests/test_torch_shard_map.py`` in one
    spawn: runs on the port's draws, runs on replayed reference draws, one
    round per aggregation rule from numpy inputs, ``aggregate_grads_local``
    on this rank's slice, and the backend's shard census."""
    from repro_torch import obs
    from repro_torch.convert import params_from_jax
    from repro_torch.core.aggregation import aggregate_grads_local
    from repro_torch.core.baselines import make_policy
    from repro_torch.fl.backends import make_backend
    from repro_torch.fl.server import run_federated
    from repro_torch.models.paper_models import make_mlp

    model = make_mlp()
    cfg, schedule, data = payload["cfg"], payload["schedule"], payload["data"]
    out: dict = {"runs": {}, "ref_runs": {}, "rounds": {}}
    for name, method, comp in payload["runs"]:
        policy = make_policy(method, cfg, device="cpu",
                             schedule=schedule if method == "adel" else None)
        tracer = obs.Tracer(obs.MemorySink())
        params, hist = run_federated(model, policy, cfg, *data, seed=0,
                                     backend="shard_map", compression=comp,
                                     tracer=tracer, device="cpu")
        out["runs"][name] = {"hist": _history(hist), "params": _numpy(params),
                             "bytes": _byte_totals(hist.telemetry)}
    for name, comp, z, idx, init in payload["ref_runs"]:
        policy = make_policy("adel", cfg, schedule=schedule, device="cpu")
        params, hist = run_federated(
            model, policy, cfg, *data, backend="shard_map", compression=comp,
            draws=ReplayDraws(z, idx), init_params=params_from_jax(init, "cpu"),
            device="cpu")
        out["ref_runs"][name] = {"hist": _history(hist),
                                 "params": _numpy(params)}
    for rule, np_params, arrays, eta, wm_ratios in payload["rounds"]:
        bk = make_backend("shard_map", model, device="cpu",
                          compression="int8" if rule == "int8" else None)
        U = arrays[3].shape[0]
        U_pad = bk.cohort_pad(U)
        padded = [np.concatenate([a, np.zeros((U_pad - U,) + a.shape[1:],
                                              a.dtype)]) if i < 4 else a
                  for i, a in enumerate(arrays)]
        params = params_from_jax(np_params, "cpu")
        wmasks = None
        if wm_ratios is not None:
            r = np.concatenate([wm_ratios, np.ones(U_pad - U, np.float32)])
            wmasks = model.width_masks(params, r)
        res = bk.run_round(params, *map(torch.from_numpy, padded), eta,
                           bias_correct=wm_ratios is None, wmasks=wmasks)
        out["rounds"][rule] = _numpy(res)
    g, mask, p = map(torch.from_numpy, payload["agg_local"])
    per = g.shape[0] // world
    sl = slice(rank * per, (rank + 1) * per)
    agg = aggregate_grads_local({"w": g[sl]}, {"w": torch.arange(g.shape[1])},
                                mask[sl], p, dist.group.WORLD)
    out["agg_local"] = agg["w"].numpy()
    bk = make_backend("shard_map", model, device="cpu")
    out["census"] = {"describe": bk.describe(), "pad10": bk.cohort_pad(10),
                     "pad8": bk.cohort_pad(8)}
    return out
