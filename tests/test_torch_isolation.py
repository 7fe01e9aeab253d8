"""The PyTorch port stands alone: no JAX and nothing of ``repro`` in
``src/repro_torch``, ``chip_smoke.py`` or ``examples/torch_*.py``, and
entry points run on the card unless the caller asks for the CPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + sorted((ROOT / "examples").glob("torch_*.py"))


def _imported_modules(path: Path) -> list[str]:
    mods = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.append(node.module or "")
    return mods


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_no_jax_or_reference_import(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, mod)


def test_import_leaves_jax_unloaded():
    code = ("import sys, repro_torch, repro_torch.fl.server, "
            "repro_torch.models.paper_models, repro_torch.core.scheduler, "
            "repro_torch.convert, repro_torch.configs, "
            "repro_torch.models.transformer, repro_torch.launch.serve, "
            "repro_torch.kernels.flash_attention, repro_torch.kernels.ssd_scan, "
            "repro_torch.obs, repro_torch.obs.timeline, repro_torch.fl.spec, "
            "repro_torch.fl.backends, repro_torch.core.replan, "
            "repro_torch.configs.base, repro_torch.fleet, "
            "repro_torch.fleet.engine, repro_torch.fleet.scenarios, "
            "repro_torch.fleet.population, repro_torch.fl.tasks, "
            "repro_torch.launch.steps, repro_torch.launch.train, "
            "repro_torch.optim, repro_torch.checkpoint, "
            "repro_torch.autodiff, repro_torch.launch.mesh, "
            "repro_torch.launch.specs, repro_torch.launch.costprobe; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert not any(m == 'repro' or m.startswith('repro.') "
            "for m in sys.modules), 'repro imported'")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)


def _cardless():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the default runs there")


def test_entry_points_default_to_the_card():
    _cardless()
    from repro_torch.core.scheduler import solve
    from repro_torch.core.types import AnalysisConfig
    from repro_torch.fl.backends import (DenseBackend, HierarchicalBackend,
                                         make_backend)
    from repro_torch.fl.runtime import RoundRuntime
    from repro_torch.fl.server import run_federated
    from repro_torch.models.paper_models import make_mlp
    from repro_torch.core.baselines import make_policy

    cfg = AnalysisConfig.default(U=4, L=3, R=3, T_max=6.0)
    model = make_mlp(input_dim=8, hidden=(4, 4))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        solve(cfg, "adam", steps=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DenseBackend(model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        HierarchicalBackend(model, regions=2)
    for backend in ("chunked", "temporal", "buffered", "hierarchical"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_backend(backend, model)
    policy = make_policy("salf", cfg, m=2.0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RoundRuntime(model, policy)
    x = np.zeros((4, 5, 8), np.float32)
    y = np.zeros((4, 5), np.int32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_federated(model, policy, cfg, x, y, np.full(4, 5), x[0], y[0])
    # an explicit CPU request runs
    sch = solve(cfg, "adam", steps=2, device="cpu")
    assert np.isfinite(sch.objective)


def test_fleet_entry_points_default_to_the_card(tmp_path):
    _cardless()
    from repro_torch.data.synthetic import make_image_dataset
    from repro_torch.fleet.engine import partition_fleet, run_fleet
    from repro_torch.models.paper_models import make_mlp

    x, y, xt, yt = make_image_dataset("mnist", n_train=60, n_test=20)
    data = partition_fleet(x, y, xt, yt, 8, alpha=None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_fleet(make_mlp(), "uniform", data, rounds=1, cohort_size=4,
                  method="salf")
    # the scenarios command line runs on the card unless told otherwise
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.fleet.scenarios", "--run",
           "datacenter-always-on", "--rounds", "1", "--quiet",
           "--solver-steps", "2"]
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                          timeout=300, cwd=tmp_path)
    assert proc.returncode != 0 and "device='cpu'" in proc.stderr
    proc = subprocess.run(cmd + ["--device", "cpu"], capture_output=True,
                          text=True, env=env, timeout=300, cwd=tmp_path,
                          check=True)
    assert "[datacenter-always-on] method=adel" in proc.stdout


def test_kernel_wrappers_take_plain_path_only_on_cpu():
    from repro_torch.kernels.adel_agg import (adel_agg, adel_agg_grouped,
                                              adel_agg_q8)
    before = (adel_agg.launches, adel_agg_q8.launches)
    g = torch.ones(2, 1, 4)
    c = torch.ones(2, 1)
    assert torch.equal(adel_agg(g, c), torch.full((1, 4), 2.0))
    q = torch.ones(2, 1, 4, dtype=torch.int8)
    assert torch.equal(adel_agg_q8(q, c, c), torch.full((1, 4), 2.0))
    # the plain path is not a launch
    assert (adel_agg.launches, adel_agg_q8.launches) == before
    # meta (the dry run's) takes the plain version's shapes, no launch
    assert adel_agg(g.to("meta"), c.to("meta")).shape == (1, 4)
    assert adel_agg_q8(q.to("meta"), c.to("meta"), c.to("meta")).shape == (1, 4)
    assert adel_agg_grouped([g.to("meta")], [0], c.to("meta"))[0].shape == (1, 4)
    assert (adel_agg.launches, adel_agg_q8.launches) == before
    # neither CPU, meta nor CUDA: no silent fallback
    other = SimpleNamespace(device=torch.device("xpu"))
    with pytest.raises(ValueError, match="CUDA, CPU or meta"):
        adel_agg(other, c)
    with pytest.raises(ValueError, match="CUDA, CPU or meta"):
        adel_agg_q8(other, c, c)
    with pytest.raises(ValueError, match="CUDA, CPU or meta"):
        adel_agg_grouped([other], [0], c)


def test_lm_entry_points_default_to_the_card():
    _cardless()
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models import transformer as tr

    cfg = get_config("hymba-1.5b").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve("hymba-1.5b", batch=1, prompt_len=2, new_tokens=1,
              verbose=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tr.init_params(torch.Generator(), cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tr.init_cache(cfg, 1, 8)
    # an explicit CPU request runs
    params = tr.init_params(torch.Generator(), cfg, device="cpu")
    assert params["embed"].device.type == "cpu"


def test_lm_training_entry_points_default_to_the_card(tmp_path):
    _cardless()
    from repro_torch.configs import get_config
    from repro_torch.fl.tasks import make_lm_model
    from repro_torch.launch.train import run_training

    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_training("qwen1.5-4b", rounds=1, verbose=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_lm_model(get_config("qwen1.5-4b").reduced()).init(
            torch.Generator(), None)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                           "--arch", "qwen1.5-4b", "--rounds", "1"],
                          capture_output=True, text=True, env=env,
                          timeout=300, cwd=tmp_path)
    assert proc.returncode != 0 and "device='cpu'" in proc.stderr


def test_lm_kernel_wrappers_take_plain_path_only_on_cpu():
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ops import gqa_flash, ssd_chunked_kernel
    from repro_torch.kernels.ssd_scan import ssd_scan
    before = (flash_attention.launches, ssd_scan.launches)
    q = torch.ones(1, 2, 8, 64)
    # uniform scores: the output is the mean of v over the visible keys
    assert torch.allclose(flash_attention(q, q, q), q)
    assert gqa_flash(q, q, q).shape == q.shape
    x = torch.zeros(2, 16, 4)
    la, b = torch.zeros(2, 16), torch.ones(1, 16, 3)
    assert torch.equal(ssd_scan(x, la, b, b, chunk=8), x)
    assert ssd_chunked_kernel(torch.zeros(1, 16, 2, 4), torch.ones(1, 16, 2),
                              torch.ones(2), b, b, chunk=8).shape == (1, 16, 2, 4)
    # the plain path is not a launch
    assert (flash_attention.launches, ssd_scan.launches) == before
    # meta (the dry run's) takes the plain version's shapes, no launch
    m = q.to("meta")
    assert flash_attention(m, m, m).shape == q.shape
    assert ssd_scan(x.to("meta"), la.to("meta"), b.to("meta"), b.to("meta"),
                    chunk=8).shape == x.shape
    assert (flash_attention.launches, ssd_scan.launches) == before
    # neither CPU, meta nor CUDA: no silent fallback
    other = SimpleNamespace(device=torch.device("xpu"))
    with pytest.raises(ValueError, match="CUDA, CPU or meta"):
        flash_attention(other, q, q)
    with pytest.raises(ValueError, match="CUDA, CPU or meta"):
        ssd_scan(other, la, b, b)


def test_dryrun_import_leaves_jax_unloaded():
    """``launch/dryrun.py`` opens its fake world only in ``main`` and its
    functions; importing it in a process of its own loads no JAX, nothing of
    ``repro`` and no process group."""
    code = ("import sys, repro_torch.launch.dryrun; "
            "import torch.distributed as dist; "
            "assert not dist.is_initialized(), 'a process group is open'; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert not any(m == 'repro' or m.startswith('repro.') "
            "for m in sys.modules), 'repro imported'")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)
