"""The port's launch and tooling layer against the reference: parameter and
cache partition specs for every arch at full width, the spec-to-placement
rule, the dry run's helpers and combo list; and, in processes of their own
over fake process groups (``tests/_torch_dryrun_worker.py``), the dry
run's per-device counts against hand counts on a 2 x 2 mesh, its 1 x 1
count against ``FlopCounterMode`` over the same step on the CPU, the cost
probe's extrapolation against a full-depth count, and the records of
``dryrun.main`` for every step kind against the reference's record keys.
"""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import INPUT_SHAPES as REF_SHAPES
from repro.launch import specs as rspecs
from repro.models import transformer as rtr
from repro_torch.configs import ARCHS, INPUT_SHAPES
from repro_torch.launch import costprobe, dryrun, specs
from repro_torch.launch.mesh import PartitionSpec as P
from repro_torch.launch.mesh import batch_shards, placements
from repro_torch.models import transformer as ptr

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "_torch_dryrun_worker.py"


def _ref_flat(tree) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))
    return {tuple(getattr(k, "key", getattr(k, "name", k)) for k in path):
            tuple(leaf) for path, leaf in leaves}


def _port_flat(tree, prefix=()) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_flat(v, prefix + (k,)))
        return out
    assert isinstance(tree, P)
    return {prefix: tuple(tree)}


@pytest.mark.parametrize("fsdp", ["data", None, ("pod", "data")])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_equal_the_reference(arch, fsdp):
    """Leaf for leaf, as tuples, at full width (abstract params on both
    sides: ``jax.eval_shape`` and ``meta``)."""
    want = _ref_flat(rtr.param_specs(
        rspecs.abstract_params(REF_ARCHS[arch], jnp.float32), REF_ARCHS[arch],
        fsdp=fsdp, tp="model"))
    got = _port_flat(ptr.param_specs(
        specs.abstract_params(ARCHS[arch], torch.float32), ARCHS[arch],
        fsdp=fsdp, tp="model"))
    assert got == want


def _cache_tuples(cache) -> tuple:
    return tuple(None if f is None else tuple(tuple(p) for p in f)
                 for f in cache)


@pytest.mark.parametrize("batch", ["data", ("pod", "data")])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cache_specs_equal_the_reference(arch, batch):
    rcfg, pcfg = REF_ARCHS[arch], ARCHS[arch]
    rcache = jax.eval_shape(lambda: rtr.init_cache(rcfg, 2, 16,
                                                   dtype=jnp.bfloat16))
    pcache = ptr.init_cache(pcfg, 2, 16, device="meta")
    if rcfg.enc_layers:           # only the cross field's presence is read
        rcache = rcache._replace(cross=(0, 0))
        pcache = pcache._replace(cross=(0, 0))
    want = _cache_tuples(rtr.cache_specs(rcache, rcfg, batch=batch,
                                         tp="model"))
    got = _cache_tuples(ptr.cache_specs(pcache, pcfg, batch=batch,
                                        tp="model"))
    assert got == want


def test_placements_rule():
    """Per mesh dim, the tensor dim that names it; a tuple entry splits its
    dim over those axes, major first; an axis named twice, or a tuple out
    of the mesh's order, is refused as the reference's ``P`` refuses it."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert placements(P(None, "data", "model"), mesh) == (
        Replicate(), Shard(1), Shard(2))
    assert placements(P(("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert placements(P(), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="names tensor dims"):
        placements(P("data", "data"), mesh)
    with pytest.raises(ValueError, match="order"):
        placements(P(("data", "pod")), mesh)
    with pytest.raises(ValueError, match="not in the mesh"):
        placements(P("expert"), mesh)


def test_helpers_equal_the_reference():
    for arch in sorted(ARCHS):
        for name in INPUT_SHAPES:
            assert specs.text_len(ARCHS[arch], INPUT_SHAPES[name]) == \
                rspecs.text_len(REF_ARCHS[arch], REF_SHAPES[name])
        w = specs.windowed_variant(ARCHS[arch])
        rw = rspecs.windowed_variant(REF_ARCHS[arch])
        assert (w.name, w.window) == (rw.name, rw.window)
    for shape, names in (((16, 16), ("data", "model")),
                         ((2, 16, 16), ("pod", "data", "model"))):
        ref_mesh = SimpleNamespace(axis_names=names,
                                   devices=SimpleNamespace(shape=shape))
        mesh = SimpleNamespace(mesh_dim_names=names,
                               mesh=SimpleNamespace(shape=shape),
                               size=lambda i, s=shape: s[i])
        assert specs.default_clients(mesh) == rspecs.default_clients(ref_mesh)
        assert batch_shards(mesh) == rspecs.default_clients(ref_mesh)


def test_combo_list_equals_the_reference(monkeypatch):
    # the reference's module sets XLA_FLAGS on import: restored at teardown
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    from repro.launch import dryrun as rdryrun
    for swa in (False, True):
        assert list(dryrun.iter_combos(swa)) == list(rdryrun.iter_combos(swa))


def test_lin2_on_the_reference_case():
    """``tests/test_models_extra.py:44``'s case, through the port's
    ``_lin2``."""
    c2 = {"flops": 10.0 + 2 * 3.0, "bytes": 5.0 + 2 * 1.0, "coll": 2 * 4.0}
    c4 = {"flops": 10.0 + 4 * 3.0, "bytes": 5.0 + 4 * 1.0, "coll": 4 * 4.0}
    out = costprobe._lin2(c2, c4, 40)
    assert out["flops"] == pytest.approx(10.0 + 40 * 3.0)
    assert out["bytes"] == pytest.approx(5.0 + 40 * 1.0)
    assert out["coll"] == pytest.approx(40 * 4.0)


def test_train_extrapolation_is_bilinear():
    """rest + a l + U (c + l p), recovered exactly at another (U, l)."""
    def cost(u, l):
        return 7.0 + 3.0 * l + u * (5.0 + 2.0 * l)
    samples = {f"U{u}_L{l}": {k: cost(u, l) for k in ("flops", "bytes",
                                                       "coll")}
               for u, l in costprobe.TRAIN_PROBES}
    out = costprobe._train_extrapolation(samples, 16, 32)
    assert out == {k: cost(16, 32) for k in ("flops", "bytes", "coll")}


def test_h100_constants():
    """The roofline's constants are the H100 SXM's, not a TPU v5e's."""
    assert (dryrun.PEAK_FLOPS, dryrun.HBM_BW, dryrun.ICI_BW) == (
        989e12, 3.35e12, 50e9)


# ---------------------------------------------------------------------------
# over fake process groups, in processes of their own
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def worker(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = {part: subprocess.Popen(
        [sys.executable, str(WORKER), part, str(tmp / f"{part}.json"),
         str(tmp / "records")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for part in ("counts", "records", "one_by_one")}
    out = {}
    for part, proc in procs.items():
        log, _ = proc.communicate(timeout=300)
        assert proc.returncode == 0, log[-4000:]
        with open(tmp / f"{part}.json") as f:
            out.update(json.load(f))
    out["records"] = {p.parent.name + "/" + p.name: json.loads(p.read_text())
                      for p in sorted((tmp / "records").rglob("*.json"))}
    return out


def test_hand_counts_on_a_two_by_two_mesh(worker):
    """(8, 16) f32 batch-sharded over data @ (16, 32) column-sharded over
    model: each rank multiplies (4, 16) by (16, 16), 2 * 4 * 16 * 16
    FLOPs, reading both and writing (4, 16); x * 2 is 4 * 16 values. A
    weight also sharded over data is gathered first: one all-gather of its
    (16, 16) model shard. Redistributions of x: to replicated, an
    all-gather of (8, 16); to Shard(1) over data, an all-to-all to (8, 8);
    a partial sum over model to replicated, an all-reduce of (8, 16)."""
    h = worker["hand"]
    assert h["product"] == {"products": 2 * 4 * 16 * 16, "elementwise": 0,
                            "bytes": 4 * (4 * 16 + 16 * 16 + 4 * 16),
                            "coll": {"total": 0, "count": 0},
                            "local_shape": [4, 16]}
    assert h["elementwise"]["elementwise"] == 4 * 16
    assert h["elementwise"]["products"] == 0
    assert h["elementwise"]["bytes"] == 4 * 2 * 4 * 16
    assert h["fsdp_product"]["products"] == 2 * 4 * 16 * 16
    assert h["fsdp_product"]["coll"] == {"all-gather": 4 * 16 * 16,
                                         "total": 4 * 16 * 16, "count": 1}
    assert h["gather"]["coll"] == {"all-gather": 4 * 8 * 16,
                                   "total": 4 * 8 * 16, "count": 1}
    assert h["all_to_all"]["coll"] == {"all-to-all": 4 * 8 * 8,
                                       "total": 4 * 8 * 8, "count": 1}
    assert h["all_to_all"]["local_shape"] == [8, 8]
    assert h["reduce"]["coll"] == {"all-reduce": 4 * 8 * 16,
                                   "total": 4 * 8 * 16, "count": 1}


def test_placements_on_a_two_by_two_mesh(worker):
    p = worker["placements"]
    assert p["dims"] == {"placements": ["S(1)", "S(2)"], "local": [8, 3, 2]}
    assert p["tuple"] == {"placements": ["S(0)", "S(0)"], "local": [2, 6, 4]}
    assert p["model_first"] == {"placements": ["S(2)", "S(0)"],
                                "local": [4, 6, 2]}
    assert p["none"] == {"placements": ["R", "R"], "local": [8, 6, 4]}


def test_one_by_one_count_equals_flop_counter(worker):
    """On a 1 x 1 mesh the products counted on meta are
    ``FlopCounterMode``'s over the same reduced step run on the CPU, a
    prefill and a temporal training round, and the argument bytes are the
    CPU run's params and inputs; no collective."""
    for kind, r in worker["one_by_one"].items():
        assert r["products"] == r["flop_counter"] > 0, kind
        assert r["argument_bytes"] == r["cpu_argument_bytes"], kind
        assert r["collectives"] == {"total": 0, "count": 0}, kind


def test_costprobe_extrapolation_equals_full_depth(worker):
    for kind, r in worker["extrapolation"].items():
        assert r["probe"] == r["full"], kind


def test_client_probe_is_the_temporal_step_body(worker):
    """``build_client_probe`` counts one client's weighted gradient: the
    temporal step over U clients does U times its products."""
    r = worker["client_probe"]
    assert r["step_products"] == r["U"] * r["probe_products"] > 0


def test_build_dryrun_raises_the_reference_errors(worker):
    e = worker["errors"]
    assert "long_500k is skipped" in e["long_500k"]
    assert "not divisible by 2 batch shards" in e["indivisible"]
    assert "needs a process group of 256 ranks; this one has 4" in e[
        "production_mesh"]


def _reference_record_keys() -> dict:
    """The keys of the reference's dry-run record by step, read from its
    source: ``run_combo``'s ``record`` dict and ``build_dryrun``'s
    ``meta`` dicts."""
    def dicts(path, name):
        tree = ast.parse((ROOT / "src" / "repro" / "launch" / path).read_text())
        for node in ast.walk(tree):
            if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                    and any(getattr(t, "id", None) == name
                            for t in node.targets)):
                yield node.value
    record = next(dicts("dryrun.py", "record"))
    base = {k.value for k in record.keys if k is not None}
    out = {}
    for meta in dicts("specs.py", "meta"):
        keys = {k.value for k in meta.keys}
        step = next(v.value for k, v in zip(meta.keys, meta.values)
                    if k.value == "step")
        out[step] = base | keys
    return out


def test_main_records_have_the_reference_keys(worker):
    """``dryrun.main`` over a reduced arch of every step kind (prefill,
    decode, temporal and spatial training) on a 2 x 2 fake mesh: the
    records' keys are the reference's, the memory and roofline keys too,
    and the roofline is read with the H100's constants."""
    want = _reference_record_keys()
    recs = worker["records"]
    assert sorted(recs) == [
        "spatial/qwen1.5-4b__train_4k__2_2.json",
        "temporal/qwen1.5-4b__decode_32k__2_2.json",
        "temporal/qwen1.5-4b__prefill_32k__2_2.json",
        "temporal/qwen1.5-4b__train_4k__2_2.json"]
    for name, rec in recs.items():
        assert set(rec) == want[rec["step"]], name
        assert set(rec["memory"]) == {
            "argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes"}
        assert rec["memory"]["temp_size_in_bytes"] is None
        coll = rec["collective_bytes_per_device"]
        assert coll["total"] == sum(v for k, v in coll.items()
                                    if k not in ("total", "count"))
        roof = rec["roofline"]
        assert roof["compute_s"] == rec["flops_per_device"] / 989e12
        assert roof["memory_s"] == rec["bytes_per_device"] / 3.35e12
        assert roof["collective_s"] == coll["total"] / 50e9
        assert rec["flops_per_device"] > 0 and rec["mesh"] == "2x2"
