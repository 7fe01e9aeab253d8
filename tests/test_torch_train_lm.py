"""The port's federated LM path (``repro_torch.launch.train``,
``fl.tasks``, ``launch.steps``, ``optim``, ``checkpoint``) against the
reference's, the port of ``tests/test_train_lm.py``.

Injected draws: the port cannot reproduce JAX's threefry draws, so tight
comparisons replay the reference's key sequence (``fl/runtime.py``:
``k_init`` for the params, then ``(plan_key, k_round, k_batch)`` a round:
the Poisson depths of the reference's schedule and the minibatch indices)
through the port's draw seam, starting from the reference's init.

Tolerances: the 6-round loss trajectory of ``experiments/results/
lm_smoke.json`` within rtol = atol = 2e-3 (``tests/test_train_lm.py``'s
backend tolerance; the port solves its own schedule); one round's params
rtol 1e-4 / atol 1e-6 of the reference's same backend; a train step's
params the same; the port's backends against its dense backend as the
reference's against its own (times rtol 1e-6, losses rtol = atol = 2e-3,
accuracies atol 5e-3); width masks, byte counts and checkpoints exactly.
"""
import contextlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as ref_load
from repro.checkpoint import save_checkpoint as ref_save
from repro.configs import get_config as ref_get_config
from repro.core import straggler as rst
from repro.core.baselines import make_policy as ref_make_policy
from repro.core.scheduler import solve as ref_solve
from repro.core.types import AnalysisConfig as RefConfig
from repro.fl.runtime import RoundRuntime as RefRuntime
from repro.fl.runtime import probe_s_max as ref_probe_s_max
from repro.fl.tasks import lm_eval_metrics as ref_lm_eval_metrics
from repro.fl.tasks import lm_task as ref_lm_task
from repro.fl.tasks import make_lm_model as ref_make_lm_model
from repro.launch.steps import make_client_grad as ref_make_client_grad
from repro.launch.steps import make_train_step as ref_make_train_step
from repro.models import transformer as rtr
import repro.optim as ropt
from repro_torch import obs
from repro_torch import optim as popt
from repro_torch.checkpoint import (latest_checkpoint, load_checkpoint,
                                    save_checkpoint)
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.baselines import make_policy
from repro_torch.core.types import AnalysisConfig
from repro_torch.fl.backends import BACKENDS
from repro_torch.fl.runtime import RoundRuntime, probe_s_max
from repro_torch.fl.tasks import (lm_eval_metrics, lm_fleet_data, lm_task,
                                  make_lm_model)
from repro_torch.launch import train as ptrain
from repro_torch.launch.steps import make_client_grad, make_train_step
from repro_torch.launch.train import run_training
from repro_torch.tree import tree_leaves

ARCH = "qwen1.5-4b"
U, SEQ, ETA0, SEED = 4, 32, 1.0, 0
RESULTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "experiments", "results")
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)


class ReferenceDraws:
    """The reference run's draws, replayed round by round: ``k_init`` (the
    params), and from each round's ``(plan_key, k_round, k_batch)`` split
    the Poisson depths under the reference's schedule and the minibatch
    indices. ``partitionable`` is jax's ``threefry_partitionable`` mode the
    draws are made in: ``experiments/results/lm_smoke.json`` was written
    under jax's earlier default (False); the reference run in this process
    uses the installed default (None: leave it)."""

    def __init__(self, seed, R, schedule, ref_cfg, *, partitionable=None):
        self.mode = partitionable
        with self._mode():
            key, self.k_init = jax.random.split(jax.random.PRNGKey(seed))
            self.z, self.k_batch = [], []
            for t in range(R):
                key, k_round, k_batch = jax.random.split(key, 3)
                self.z.append(torch.as_tensor(np.array(rst.sample_round(
                    k_round, float(schedule.T[t]), schedule.m, ref_cfg)[3])))
                self.k_batch.append(k_batch)
        self.gen = torch.Generator().manual_seed(seed)

    def _mode(self):
        if self.mode is None:
            return contextlib.nullcontext()
        return jax.threefry_partitionable(self.mode)

    def poisson(self, t, lam):
        return self.z[t]

    def batch_indices(self, t, U, s_max):
        with self._mode():
            idx = jax.random.randint(self.k_batch[t], (U, s_max), 0, 2 ** 30)
        return torch.as_tensor(np.array(idx))

    def init(self, rcfg):
        with self._mode():
            params = jax.tree.map(np.asarray,
                                  rtr.init_params(self.k_init, rcfg))
        return params_from_jax(params, "cpu")


def _close_tree(out, ref, tol=PARAM_TOL) -> None:
    ref_leaves = jax.tree.leaves(ref)
    assert len(tree_leaves(out)) == len(ref_leaves)
    for a, b in zip(tree_leaves(out), ref_leaves):
        np.testing.assert_allclose(a.detach().float().numpy(),
                                   np.asarray(b, np.float32), **tol)


@pytest.fixture(scope="module")
def lm_setup():
    """Reduced qwen1.5-4b, the lm_smoke regime: U=4, seq 32, 6 rounds in a
    30 s budget, the reference's 600-step Adam schedule and draws."""
    rounds = 6
    rcfg = ref_get_config(ARCH).reduced()
    kw = dict(U=U, L=rcfg.n_blocks_total, R=rounds, T_max=5.0 * rounds,
              eta0=ETA0, seed=SEED)
    ref_cfg = RefConfig.default(**kw)
    ref_sched = ref_solve(ref_cfg, "adam", steps=600)
    return dict(rounds=rounds, rcfg=rcfg, cfg=get_config(ARCH).reduced(),
                ref_cfg=ref_cfg, ref_sched=ref_sched,
                port_cfg=AnalysisConfig.default(**kw),
                draws=ReferenceDraws(SEED, rounds, ref_sched, ref_cfg),
                json_draws=ReferenceDraws(SEED, rounds, ref_sched, ref_cfg,
                                          partitionable=False))


# ---------------------------------------------------------------------------
# run_training against the reference's targets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["dense", "temporal"])
def test_lm_smoke_trajectory(lm_setup, backend):
    """``run_training`` in the lm_smoke regime (the reference's
    ``benchmarks/lm_smoke.py`` settings) under the reference's draws
    traces the loss of ``experiments/results/lm_smoke.json``
    (6.261395 -> 6.129411) on dense and on temporal. The file's draws are
    jax's with ``threefry_partitionable=False``, its default when the file
    was written (the installed jax's default gives the reference itself
    6.232219 -> 6.105830)."""
    with open(os.path.join(RESULTS, "lm_smoke.json")) as f:
        target = json.load(f)[backend]["loss"]
    s = lm_setup
    _, hist = run_training(ARCH, method="adel", rounds=s["rounds"],
                           tmax=5.0 * s["rounds"], U=U, seq=SEQ, eta0=ETA0,
                           seed=SEED, backend=backend, solver_steps=600,
                           eval_every=1, verbose=False, device="cpu",
                           draws=s["json_draws"],
                           init_params=s["json_draws"].init(s["rcfg"]))
    assert hist.rounds == list(range(1, s["rounds"] + 1))
    np.testing.assert_allclose(hist.train_loss, target, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("backend", ["dense", "temporal"])
def test_one_round_matches_reference_backend(lm_setup, backend):
    """One ``RoundRuntime`` round of the LM task on the same backend of
    both packages, the reference's draws and schedule: params within rtol
    1e-4."""
    s = lm_setup
    ref_task = ref_lm_task(s["rcfg"], U=U, seq=SEQ, n_seq=96, seed=SEED)
    ref_policy = ref_make_policy("adel", s["ref_cfg"],
                                 schedule=s["ref_sched"])
    s_max = max(min(ref_probe_s_max(ref_policy, 1), 32), 2)
    ref_params, ref_hist = RefRuntime(ref_task.model, ref_policy,
                                      backend=backend).run(
        ref_task.source(), rounds=1, T_max=30.0, eta=s["ref_cfg"].eta,
        s_max=s_max, key=jax.random.PRNGKey(SEED),
        eval_fn=ref_task.eval_fn(), eval_every=1)
    task = lm_task(s["cfg"], U=U, seq=SEQ, n_seq=96, seed=SEED)
    from repro_torch.core.types import Schedule
    sched = Schedule(T=np.asarray(s["ref_sched"].T), m=s["ref_sched"].m,
                     objective=s["ref_sched"].objective,
                     p1=np.asarray(s["ref_sched"].p1))
    policy = make_policy("adel", s["port_cfg"], schedule=sched, device="cpu")
    assert probe_s_max(policy, 1) == ref_probe_s_max(ref_policy, 1)
    params, hist = RoundRuntime(task.model, policy, backend=backend,
                                device="cpu").run(
        task.source("cpu"), rounds=1, T_max=30.0, eta=s["port_cfg"].eta,
        s_max=s_max, eval_fn=task.eval_fn("cpu"), draws=s["draws"],
        init_params=s["draws"].init(s["rcfg"]))
    _close_tree(params, ref_params)
    np.testing.assert_allclose(hist.train_loss, ref_hist.train_loss,
                               rtol=1e-5)
    assert hist.accuracy == pytest.approx(ref_hist.accuracy, abs=1e-6)


def _short_run(backend, **kw):
    """3 rounds of the reduced-qwen LM on the port's own draws: U=4, seq
    16, 24 rows a client."""
    return run_training(ARCH, rounds=3, tmax=15.0, U=U, seq=16, n_seq=24,
                        eta0=ETA0, seed=SEED, backend=backend,
                        solver_steps=200, eval_every=1, verbose=False,
                        device="cpu", **kw)


@pytest.fixture(scope="module")
def dense_run():
    return _short_run("dense")


@pytest.mark.parametrize("backend", [b for b in BACKENDS if b != "dense"])
def test_port_backends_agree_with_dense_on_the_lm(dense_run, backend):
    """Every port backend traces the port's dense LM trajectory, as
    ``tests/test_train_lm.py::test_lm_backend_equivalence`` holds the
    reference's: the clock exactly, losses and accuracies to summation
    order."""
    ref = dense_run[1]
    h = _short_run(backend, chunk_size=2 if backend == "chunked" else None)[1]
    assert h.rounds == ref.rounds
    np.testing.assert_allclose(h.times, ref.times, rtol=1e-6)
    np.testing.assert_allclose(h.train_loss, ref.train_loss, rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(h.accuracy, ref.accuracy, atol=5e-3)


@pytest.mark.parametrize("mode", ["none", "int8", "topk8"])
def test_payload_bytes_match_backend_sweep(mode):
    """One reduced-qwen round's byte counters equal the reference's
    ``experiments/results/backend_sweep.json`` exactly (its settings: U=4,
    seq 16, 24 rows a client, dense, 2 rounds)."""
    with open(os.path.join(RESULTS, "backend_sweep.json")) as f:
        target = json.load(f)["compression"][mode]
    tracer = obs.Tracer(obs.MemorySink())
    _, hist = run_training(ARCH, rounds=2, tmax=40.0, U=4, seq=16, n_seq=24,
                           backend="dense", solver_steps=60,
                           compression=None if mode == "none" else mode,
                           eval_every=2, verbose=False, tracer=tracer,
                           device="cpu")
    done = len(hist.rounds)
    ctr = tracer.summary()["counters"]
    assert done == target["rounds"]
    assert ctr["aggregate_bytes_logical"] // done == \
        target["bytes_per_round_logical"] == 25_403_392
    assert ctr["aggregate_bytes_wire"] // done == \
        target["bytes_per_round_wire"]


def test_run_training_api_checkpoint_and_replan(tmp_path):
    """The public entry point (the reference test's settings): History output,
    the replan hook, a checkpoint through ``on_round`` that loads back."""
    ckpt = os.path.join(tmp_path, "ck")
    params, hist = run_training(ARCH, method="adel", rounds=4, tmax=20.0,
                                U=3, seq=16, n_seq=24, eta0=1.0, seed=1,
                                backend="temporal", replan="drift",
                                solver_steps=200, ckpt=ckpt, ckpt_every=2,
                                eval_every=1, verbose=False, device="cpu")
    assert len(hist.train_loss) == 4 and hist.method == "adel"
    assert os.path.exists(ckpt + ".npz") and os.path.exists(ckpt + ".json")
    assert hist.replans == []        # static population: drift never fires
    back, manifest = load_checkpoint(ckpt, params)
    assert manifest["step"] == 4 and manifest["meta"]["backend"] == "temporal"
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(back),
                                                  tree_leaves(params)))
    assert latest_checkpoint(str(tmp_path), prefix="ck") == ckpt


def test_run_training_fleet_arm():
    """``population=`` routes the LM through ``run_fleet`` with token-loss
    eval: a churny Bernoulli fleet, chunked backend."""
    _, hist = run_training(ARCH, rounds=3, tmax=15.0, U=4, seq=16, n_seq=24,
                           eta0=1.0, seed=0, solver_steps=100,
                           population=dict(size=60, availability="bernoulli",
                                           availability_kwargs=(("rate",
                                                                 0.7),)),
                           eval_every=1, verbose=False, device="cpu")
    assert len(hist.train_loss) == 3 and len(hist.available) == 3
    assert hist.method == "fleet-adel"
    assert all(np.isfinite(hist.train_loss))
    with pytest.raises(ValueError, match="ckpt"):
        run_training(ARCH, rounds=1, population="uniform", ckpt="x",
                     verbose=False, device="cpu")


def test_train_cli(tmp_path, capsys):
    out = str(tmp_path / "hist.json")
    ptrain.main(["--arch", ARCH, "--device", "cpu", "--rounds", "2",
                 "--tmax", "10", "--clients", "3", "--seq", "16",
                 "--backend", "temporal", "--solver-steps", "60",
                 "--out", out, "--profile-dir", str(tmp_path / "prof")])
    assert "[train] done" in capsys.readouterr().out
    with open(out) as f:
        res = json.load(f)
    assert res["backend"] == "temporal" and len(res["train_loss"]) == 2
    assert os.path.exists(tmp_path / "prof" / "train_trace.json")


# ---------------------------------------------------------------------------
# the step functions
# ---------------------------------------------------------------------------

def _step_inputs(rcfg, U_=3, b=2, S=16):
    rng = np.random.default_rng(3)
    tok = rng.integers(0, rcfg.vocab, (U_, b, S)).astype(np.int32)
    lab = rng.integers(0, rcfg.vocab, (U_, b, S)).astype(np.int32)
    mask = np.ones((U_, rcfg.n_blocks_total), np.float32)
    mask[0, 0] = 0.0
    mask[2, 1:] = 0.0
    p = np.full((rcfg.n_blocks_total,), 0.05, np.float32)
    return tok, lab, mask, p


@pytest.mark.parametrize("arch", ["qwen1.5-4b"])
@pytest.mark.parametrize("mode", ["temporal", "spatial"])
def test_train_step_matches_reference(arch, mode):
    """``make_train_step`` (temporal: autograd with ``remat``; spatial:
    vmap(grad), no remat) matches the reference's one step."""
    rcfg, cfg = ref_get_config(arch).reduced(), get_config(arch).reduced()
    np_params = jax.tree.map(np.asarray, rtr.init_params(
        jax.random.PRNGKey(0), rcfg))
    tok, lab, mask, p = _step_inputs(rcfg)
    ref = jax.jit(ref_make_train_step(rcfg, U=3, mode=mode, remat=False))(
        np_params, tok, lab, mask, p, jnp.float32(0.1))
    step = make_train_step(cfg, U=3, mode=mode, remat=mode == "temporal")
    out = step(params_from_jax(np_params, "cpu"),
               *map(torch.from_numpy, (tok, lab, mask, p)), 0.1)
    _close_tree(out, ref)


def test_client_grad_matches_reference():
    """``make_client_grad``: one client's f32 gradient weighted by its
    coefficient row, against the reference's."""
    rcfg, cfg = ref_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    np_params = jax.tree.map(np.asarray, rtr.init_params(
        jax.random.PRNGKey(0), rcfg))
    tok, lab, _, _ = _step_inputs(rcfg)
    c_row = np.asarray([0.25, 0.0, 0.5], np.float32)[:rcfg.n_blocks_total]
    ref = ref_make_client_grad(rcfg, remat=False)(np_params, tok[0], lab[0],
                                                  c_row)
    out = make_client_grad(cfg)(params_from_jax(np_params, "cpu"),
                                torch.from_numpy(tok[0]),
                                torch.from_numpy(lab[0]),
                                torch.from_numpy(c_row))
    _close_tree(out, ref, dict(rtol=1e-4, atol=1e-7))


def test_lm_eval_metrics_match_reference():
    rcfg, cfg = ref_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    np_params = jax.tree.map(np.asarray, rtr.init_params(
        jax.random.PRNGKey(0), rcfg))
    rows = ref_lm_task(rcfg, U=2, seq=16, n_seq=8, seed=0).test_x
    racc, rloss = ref_lm_eval_metrics(ref_make_lm_model(rcfg), np_params,
                                      jnp.asarray(rows), batch=16)
    acc, loss = lm_eval_metrics(make_lm_model(cfg),
                                params_from_jax(np_params, "cpu"),
                                torch.from_numpy(rows), batch=16)
    assert float(acc) == pytest.approx(float(racc), abs=1e-7)
    assert float(loss) == pytest.approx(float(rloss), rel=1e-5)


def test_lm_task_and_fleet_data_equal_reference():
    rcfg, cfg = ref_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    ref, task = (ref_lm_task(rcfg, U=3, seq=16, n_seq=8, n_eval=6, seed=2),
                 lm_task(cfg, U=3, seq=16, n_seq=8, n_eval=6, seed=2))
    for f in ("client_x", "client_y", "counts", "test_x"):
        np.testing.assert_array_equal(getattr(task, f), getattr(ref, f))
    assert task.kind == "lm" and task.n_per_client == ref.n_per_client
    from repro.fl.tasks import lm_fleet_data as ref_lm_fleet_data
    rd = ref_lm_fleet_data(rcfg, 5, seq=8, rows_per_device=4, seed=1)
    d = lm_fleet_data(cfg, 5, seq=8, rows_per_device=4, seed=1)
    for f in ("x", "y", "x_test", "y_test"):
        np.testing.assert_array_equal(getattr(d, f), getattr(rd, f))
    assert all(np.array_equal(a, b) for a, b in zip(d.parts, rd.parts))


# ---------------------------------------------------------------------------
# HeteroFL width masks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen1.5-4b", "hymba-1.5b", "mamba2-370m"])
def test_width_masks_match_reference(arch):
    """FFN-hidden-width masks leaf for leaf, equal to the reference's."""
    rcfg, cfg = ref_get_config(arch).reduced(), get_config(arch).reduced()
    np_params = jax.tree.map(np.asarray, rtr.init_params(
        jax.random.PRNGKey(0), rcfg))
    ratios = np.asarray([0.25, 1.0, 0.5, 0.3], np.float32)
    ref = ref_make_lm_model(rcfg).width_masks(np_params, ratios)
    out = make_lm_model(cfg).width_masks(params_from_jax(np_params, "cpu"),
                                         ratios)
    _close_tree(out, ref, dict(rtol=0, atol=0))


def test_heterofl_width_masks_dense_vs_temporal_on_lm(lm_setup):
    """HeteroFL on the LM ModelAPI through the runtime: dense and temporal
    agree (the reference test's tolerance)."""
    s = lm_setup
    task = lm_task(s["cfg"], U=U, seq=SEQ, n_seq=96, seed=SEED)
    hists = {}
    for bk in ("dense", "temporal"):
        policy = make_policy("heterofl", s["port_cfg"], device="cpu")
        _, hists[bk] = RoundRuntime(task.model, policy, backend=bk,
                                    device="cpu").run(
            task.source("cpu"), rounds=2, T_max=30.0, eta=s["port_cfg"].eta,
            s_max=4, eval_fn=task.eval_fn("cpu"), eval_every=1)
    np.testing.assert_allclose(hists["dense"].train_loss,
                               hists["temporal"].train_loss, rtol=2e-3,
                               atol=2e-3)


# ---------------------------------------------------------------------------
# optim and checkpoints
# ---------------------------------------------------------------------------

def _grad_tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": [rng.standard_normal((5,)).astype(np.float32)]}


@pytest.mark.parametrize("name", ["sgd", "momentum", "clip", "inverse",
                                  "constant"])
def test_optim_matches_reference(name):
    """The optimizers (two updates), the global-norm clip and the
    schedules against the reference's, rtol 1e-6."""
    w, g1, g2 = _grad_tree(0), _grad_tree(1), _grad_tree(2)
    t = lambda tree: jax.tree.map(torch.from_numpy, tree)  # noqa: E731
    tol = dict(rtol=1e-6, atol=1e-7)
    if name in ("inverse", "constant"):
        fn = "inverse_decay" if name == "inverse" else "constant_lr"
        np.testing.assert_array_equal(getattr(popt, fn)(0.5, 7),
                                      getattr(ropt, fn)(0.5, 7))
        return
    if name == "clip":
        _close_tree(popt.clip_by_global_norm(t(g1), 1.5),
                    ropt.clip_by_global_norm(g1, 1.5), tol)
        return
    ro, po = getattr(ropt, name)(), getattr(popt, name)()
    rw, rs, pw, ps = w, ro.init(w), t(w), po.init(t(w))
    for g in (g1, g2):
        rw, rs = ro.update(g, rs, rw, jnp.float32(0.3))
        pw, ps = po.update(t(g), ps, pw, 0.3)
    assert po.name == ro.name
    _close_tree(pw, rw, tol)


@pytest.mark.parametrize("direction", ["port_to_reference",
                                       "reference_to_port"])
def test_checkpoint_crosses_packages(tmp_path, direction):
    """A checkpoint written by either package loads in the other, leaf for
    leaf; the manifests agree."""
    rcfg = ref_get_config("hymba-1.5b").reduced()
    np_params = jax.tree.map(np.asarray, rtr.init_params(
        jax.random.PRNGKey(0), rcfg))
    params = params_from_jax(np_params, "cpu")
    path = str(tmp_path / "ckpt_3")
    if direction == "port_to_reference":
        save_checkpoint(path, params, step=3, meta={"arch": "hymba"})
        back, manifest = ref_load(path, np_params)
        _close_tree(params, back, dict(rtol=0, atol=0))
        with open(path + ".json") as f:
            mine = json.load(f)
        ref_save(str(tmp_path / "ref"), np_params, step=3,
                 meta={"arch": "hymba"})
        with open(str(tmp_path / "ref") + ".json") as f:
            theirs = json.load(f)
        assert mine == theirs
    else:
        ref_save(path, np_params, step=3, meta={"arch": "hymba"})
        back, manifest = load_checkpoint(path, params)
        _close_tree(back, np_params, dict(rtol=0, atol=0))
    assert manifest["step"] == 3 and manifest["meta"] == {"arch": "hymba"}
    assert latest_checkpoint(str(tmp_path)) == path


def test_checkpoint_bf16_round_trip(tmp_path):
    """bf16 leaves (which numpy cannot hold) are stored as their f32 values
    and come back bf16, equal."""
    params = {"w": torch.randn(3, 5).to(torch.bfloat16), "b": torch.ones(2)}
    save_checkpoint(str(tmp_path / "c"), params, step=1)
    back, manifest = load_checkpoint(str(tmp_path / "c"), params)
    assert manifest["dtypes"] == ["float32", "bfloat16"]
    assert back["w"].dtype == torch.bfloat16
    assert torch.equal(back["w"], params["w"])
    with pytest.raises(ValueError, match="leaf 0"):
        load_checkpoint(str(tmp_path / "c"), {"w": params["w"],
                                              "b": torch.ones(3)})
