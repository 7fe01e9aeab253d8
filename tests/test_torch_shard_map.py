"""The port's shard_map backend (``repro_torch.fl.backends.ShardMapBackend``)
and ``aggregate_grads_local`` on ``torch.distributed``.

One shard (no process group, and a one-rank gloo group) is the reference's
one-device mesh: bit-identical to the port's dense backend (History and
params exactly equal) for adel, salf, HeteroFL and int8. Four gloo ranks,
spawned once for every multi-rank case (``tests/_torch_dist.py``):

* runs on the port's own draws against the port's dense backend, at the
  tolerances of ``tests/test_backends.py`` (accuracy atol 0.015, loss
  rtol/atol 0.02: float summation order), every rank holding the same
  History and bit-identical params;
* a run against the REFERENCE's chunked backend (``chunk_size=3``) under
  the reference's draws and initial params: loss and params rtol 1e-4
  (atol 1e-6 for params near 0), accuracy within one test sample (a logit
  tie may break the other way at that distance); the reference's own
  shard_map backend does not run under jax 0.9 (ROADMAP.md §3);
* one round per aggregation rule from numpy inputs against the reference's
  chunked backend, at the tolerances of ``tests/test_torch_backends.py``
  (rtol 1e-4 / atol 1e-6, plus one quantization step under int8);
* ``aggregate_grads_local`` over 4 ranks against ``aggregate_grads`` on the
  concatenated cohort, in both packages (rtol 1e-5: summation order);
* the byte counters summed over the ranks equal dense's, exactly.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core.aggregation import aggregate_grads as ref_aggregate_grads
from repro.core.baselines import make_policy as ref_make_policy
from repro.core.types import AnalysisConfig as RefConfig
from repro.core.types import Schedule as RefSchedule
from repro.fl import backends as rbk
from repro.fl.server import run_federated as ref_run_federated
from repro.models import paper_models as rpm
from repro_torch import obs
from repro_torch.core.aggregation import (aggregate_grads,
                                          aggregate_grads_chunk,
                                          aggregate_grads_local)
from repro_torch.core.baselines import make_policy
from repro_torch.core.scheduler import solve
from repro_torch.core.types import AnalysisConfig
from repro_torch.data.synthetic import make_image_dataset
from repro_torch.fl.backends import ShardMapBackend, make_backend
from repro_torch.fl.partition import dirichlet_partition, stack_clients
from repro_torch.fl.runtime import probe_s_max
from repro_torch.fl.server import run_federated
from repro_torch.fl.spec import ExecSpec
from repro_torch.launch.mesh import batch_shards, make_client_group
from repro_torch.models import paper_models as ppm
from repro_torch.tree import tree_leaves
from _torch_dist import spawn
from test_torch_backends import ETA, RATIOS, _round_inputs
from test_torch_fl import ReferenceDraws

R = 5
U = 8
WORLD = 4
# (case, method, compression) of the runs on the port's own draws
RUNS = [("adel", "adel", None), ("salf", "salf", None),
        ("heterofl", "heterofl", None), ("int8", "adel", "int8")]
RULES = ["none", "int8", "hetero"]


@pytest.fixture(scope="module")
def setup():
    x_tr, y_tr, x_te, y_te = make_image_dataset(
        "mnist", n_train=600, n_test=200, seed=0, noise_std=1.0)
    parts = dirichlet_partition(y_tr, U, alpha=0.5, seed=0)
    cx, cy, counts = stack_clients(x_tr, y_tr, parts)
    model = ppm.make_mlp()
    cfg = AnalysisConfig.default(U=U, L=model.L, R=R, T_max=R * model.L * 0.5,
                                 eta0=2.0, seed=0)
    schedule = solve(cfg, "adam", steps=150, device="cpu")
    return model, cfg, (cx, cy, counts, x_te, y_te), schedule


def _run(setup, method, backend="dense", compression=None, tracer=None,
         exec=None):
    model, cfg, data, schedule = setup
    policy = make_policy(method, cfg, device="cpu",
                         schedule=schedule if method == "adel" else None)
    return run_federated(model, policy, cfg, *data, seed=0, backend=backend,
                         compression=compression, tracer=tracer, exec=exec,
                         device="cpu")


def _history(hist) -> dict:
    d = hist.as_dict()
    d.pop("telemetry")
    return d


def _assert_equivalent(a: dict, b: dict):
    # the simulated clock and plans are backend-independent: exact
    assert a["rounds"] == b["rounds"]
    np.testing.assert_allclose(a["deadlines"], b["deadlines"], rtol=1e-6)
    np.testing.assert_allclose(a["times"], b["times"], rtol=1e-6)
    np.testing.assert_allclose(a["accuracy"], b["accuracy"], atol=0.015)
    np.testing.assert_allclose(a["train_loss"], b["train_loss"], rtol=0.02,
                               atol=0.02)


def _assert_params_equal(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(torch.as_tensor(x), torch.as_tensor(y))


# ---------------------------------------------------------------------------
# one shard
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case,method,comp", RUNS, ids=[r[0] for r in RUNS])
def test_one_shard_bit_identical_to_dense(setup, case, method, comp):
    assert make_client_group() is None
    p_dense, h_dense = _run(setup, method, compression=comp)
    p_shard, h_shard = _run(setup, method, "shard_map", compression=comp)
    assert h_shard.as_dict() == h_dense.as_dict()
    _assert_params_equal(p_shard, p_dense)


@pytest.fixture
def one_rank_group(tmp_path):
    """A one-rank gloo group as the default group of this process."""
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("comp", [None, "int8"], ids=["none", "int8"])
def test_one_rank_group_bit_identical_to_dense(setup, one_rank_group, comp):
    """The default group is picked up, and its all_reduce of one rank
    leaves the partial as it was."""
    p_dense, h_dense = _run(setup, "adel", compression=comp)
    model = setup[0]
    bk = make_backend("shard_map", model, device="cpu")
    assert bk.group is one_rank_group and bk.describe()["shards"] == 1
    p_shard, h_shard = _run(setup, "adel", "shard_map", compression=comp)
    assert h_shard.as_dict() == h_dense.as_dict()
    _assert_params_equal(p_shard, p_dense)


def test_local_aggregation_without_group_is_the_chunk_fold():
    rng = np.random.default_rng(3)
    g = torch.from_numpy(rng.standard_normal((5, 4, 6)).astype(np.float32))
    mask = torch.from_numpy((rng.random((5, 4)) > 0.4).astype(np.float32))
    p = torch.full((4,), 0.1)
    ids = {"w": torch.arange(4)}
    local = aggregate_grads_local({"w": g}, ids, mask, p, None)["w"]
    assert torch.equal(local, aggregate_grads_chunk({"w": g}, ids, mask, p,
                                                    mask.sum(0))["w"])
    assert torch.equal(local, aggregate_grads({"w": g}, ids, mask, p)["w"])


def test_spec_mesh_and_describe():
    model = ppm.make_mlp()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        spec = ExecSpec.resolve(backend="shard_map", mesh=object())
    assert spec.as_dict()["mesh"] == ["data"]
    with pytest.warns(UserWarning, match="mesh"):
        ExecSpec.resolve(backend="chunked", mesh=object())
    bk = make_backend("shard_map", model, device="cpu")
    assert isinstance(bk, ShardMapBackend) and bk.group is None
    assert bk.describe()["shards"] == 1 == batch_shards(None)
    assert bk.describe()["mesh_axes"] == ["data"]
    assert [bk.cohort_pad(u) for u in (1, 7, 10)] == [1, 7, 10]


# ---------------------------------------------------------------------------
# four gloo ranks, one spawn
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_side(setup):
    """The reference's side: config, schedule, model, and its draws."""
    model, cfg, data, schedule = setup
    ref_cfg = RefConfig.default(U=U, L=model.L, R=R, T_max=R * model.L * 0.5,
                                eta0=2.0, seed=0)
    ref_sched = RefSchedule(T=schedule.T, m=schedule.m,
                            objective=schedule.objective, p1=schedule.p1)
    ref_model = rpm.make_mlp()
    draws = ReferenceDraws(0, R, ref_sched.T, ref_sched.m, ref_cfg)
    init = jax.tree.map(np.asarray, ref_model.init(draws.k_init))
    return ref_model, ref_cfg, ref_sched, draws, init


@pytest.fixture(scope="module")
def four_ranks(setup, ref_side, tmp_path_factory):
    model, cfg, data, schedule = setup
    _, _, _, draws, init = ref_side
    policy = make_policy("adel", cfg, schedule=schedule, device="cpu")
    s_max = max(min(probe_s_max(policy, cfg.R), int(data[1].shape[1])), 2)
    z = [draws.z[t].numpy() for t in range(R)]
    idx = [draws.batch_indices(t, U, s_max).numpy() for t in range(R)]
    rounds = []
    for rule in RULES:
        _, _, np_params, arrays = _round_inputs(rule)
        rounds.append((rule, np_params, arrays, ETA,
                       RATIOS if rule == "hetero" else None))
    rng = np.random.default_rng(7)
    agg_local = (rng.standard_normal((12, 3, 6)).astype(np.float32),
                 (rng.random((12, 3)) > 0.3).astype(np.float32),
                 np.full(3, 0.1, np.float32))
    payload = {"cfg": cfg, "schedule": schedule, "data": data, "runs": RUNS,
               "ref_runs": [("none", None, z, idx, init)],
               "rounds": rounds, "agg_local": agg_local}
    return spawn("shard_map_cases", WORLD, tmp_path_factory.mktemp("dist"),
                 payload)


def test_four_ranks_agree_with_each_other(four_ranks):
    first = four_ranks[0]
    for other in four_ranks[1:]:
        for name in first["runs"]:
            assert other["runs"][name]["hist"] == first["runs"][name]["hist"]
            for a, b in zip(other["runs"][name]["params"],
                            first["runs"][name]["params"]):
                np.testing.assert_array_equal(a, b)
        for rule in RULES:
            for a, b in zip(other["rounds"][rule], first["rounds"][rule]):
                np.testing.assert_array_equal(a, b)


def test_four_ranks_shard_census(four_ranks):
    for res in four_ranks:
        census = res["census"]
        assert census["describe"]["shards"] == WORLD
        assert census["describe"]["mesh_axes"] == ["data"]
        assert (census["pad10"], census["pad8"]) == (12, 8)


@pytest.mark.parametrize("case,method,comp", RUNS, ids=[r[0] for r in RUNS])
def test_four_ranks_match_dense(setup, four_ranks, case, method, comp):
    _, h_dense = _run(setup, method, compression=comp)
    _assert_equivalent(four_ranks[0]["runs"][case]["hist"],
                       _history(h_dense))


def test_four_ranks_match_reference_chunked_under_its_draws(setup, ref_side,
                                                            four_ranks):
    _, _, data, _ = setup
    ref_model, ref_cfg, ref_sched, _, _ = ref_side
    ref_params, ref_hist = ref_run_federated(
        ref_model, ref_make_policy("adel", ref_cfg, schedule=ref_sched),
        ref_cfg, *map(jnp.asarray, data), key=jax.random.PRNGKey(0),
        backend="chunked", chunk_size=3)
    mine = four_ranks[0]["ref_runs"]["none"]
    h = mine["hist"]
    assert h["rounds"] == ref_hist.rounds
    np.testing.assert_allclose(h["times"], ref_hist.times, rtol=1e-5)
    np.testing.assert_allclose(h["train_loss"], ref_hist.train_loss,
                               rtol=1e-4)
    np.testing.assert_allclose(h["accuracy"], ref_hist.accuracy, rtol=0,
                               atol=1.0 / len(data[4]) + 1e-9)
    for a, b in zip(mine["params"], jax.tree.leaves(ref_params)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("rule", RULES)
def test_four_ranks_one_round_matches_reference_chunked(four_ranks, rule):
    ref_model, model, np_params, arrays = _round_inputs(rule)
    hetero = rule == "hetero"
    comp = "int8" if rule == "int8" else None
    rparams = jax.tree.map(jnp.asarray, np_params)
    ref = rbk.make_backend("chunked", ref_model, donate=False,
                           compression=comp, chunk_size=3)
    ref_out = ref.run_round(
        rparams, *map(jnp.asarray, arrays), jnp.float32(ETA),
        bias_correct=not hetero,
        wmasks=ref_model.width_masks(rparams, RATIOS) if hetero else None)
    steps = [0.0] * len(jax.tree.leaves(ref_out))
    if comp == "int8":
        # a delta on a rounding boundary may quantize one code apart: one
        # quantization step of every client, as test_torch_backends
        from repro_torch.convert import params_from_jax
        from repro_torch.core.aggregation import layer_coefficients
        from repro_torch.core.compression import (compress_deltas,
                                                  make_compression)
        params = params_from_jax(np_params, "cpu")
        t = [torch.from_numpy(a) for a in arrays]
        bk = make_backend("dense", model, device="cpu")
        payload = compress_deltas(bk._deltas(params, *t[:3], ETA),
                                  model.layer_ids(params),
                                  make_compression("int8"))
        c = layer_coefficients(t[3], t[4])
        ids = tree_leaves(model.layer_ids(params))
        steps = [float((c[:, l] * scale[:, 0]).sum())
                 for l, (_, scale) in zip(ids, payload)]
    for a, b, step in zip(four_ranks[0]["rounds"][rule],
                          jax.tree.leaves(ref_out), steps):
        b = np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype
        assert np.all(np.abs(a - b) <= 1e-6 + 1e-4 * np.abs(b)
                      + 1.0001 * step), (rule, np.abs(a - b).max())


def test_aggregate_grads_local_four_ranks(four_ranks):
    """The port of tests/test_aggregation.py's psum-path case, over real
    ranks: every rank's all_reduced fold equals the fold of the whole
    cohort, in the port and in the reference."""
    rng = np.random.default_rng(7)
    g = rng.standard_normal((12, 3, 6)).astype(np.float32)
    mask = (rng.random((12, 3)) > 0.3).astype(np.float32)
    p = np.full(3, 0.1, np.float32)
    whole = aggregate_grads({"w": torch.from_numpy(g)},
                            {"w": torch.arange(3)}, torch.from_numpy(mask),
                            torch.from_numpy(p))["w"].numpy()
    ref = np.asarray(ref_aggregate_grads({"w": jnp.asarray(g)},
                                         {"w": jnp.arange(3)},
                                         jnp.asarray(mask),
                                         jnp.asarray(p))["w"])
    for res in four_ranks:
        np.testing.assert_allclose(res["agg_local"], whole, rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(res["agg_local"], ref, rtol=1e-5,
                                   atol=1e-6)


def test_four_ranks_byte_counters_sum_to_dense(setup, four_ranks):
    """Each rank counts its own clients: 2 of 8 a round."""
    _, hist = _run(setup, "adel", compression="int8",
                   tracer=obs.Tracer(obs.MemorySink()))
    dense = {k: v for k, v in hist.telemetry["counters"].items()
             if k.startswith("aggregate_bytes")}
    summed = {}
    for res in four_ranks:
        for k, v in res["runs"]["int8"]["bytes"].items():
            summed[k] = summed.get(k, 0) + v
    assert dense and summed == dense
    assert dense["aggregate_bytes_logical"] > dense["aggregate_bytes_wire"]
