"""The port's examples (``examples/torch_*.py``): each one's ``main`` at a
tiny size on the CPU (``--device cpu``), and each one on the card when
given no ``--device``."""
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
NAMES = ("torch_quickstart", "torch_serve_llm", "torch_federated_llm_round",
         "torch_federated_image_classification", "torch_fleet_scenarios",
         "torch_schedule_explorer")


def _example(name: str):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and their thread pools contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_quickstart_on_the_cpu(capsys):
    hist = _example("torch_quickstart").main(["--device", "cpu"])
    assert set(hist) == {"adel", "drop"}
    for h in hist.values():
        assert all(math.isfinite(a) for a in h.accuracy)
        assert h.times[-1] <= 60.0 * 1.001
    assert hist["adel"].accuracy[-1] > 0.1          # above chance
    out = capsys.readouterr().out
    assert "batch scale m =" in out and "[adel ] final accuracy" in out


def test_serve_llm_on_the_cpu(capsys):
    out = _example("torch_serve_llm").main(
        ["--device", "cpu", "--arch", "mamba2-370m", "--prompt-len", "8",
         "--new-tokens", "4"])
    assert np.asarray(out["generated"]).shape == (4, 4)
    # f32 on the CPU: the batched prefill's next token (the chunked SSD
    # forward) is the decode recurrence's first
    assert out["first_token_agree"] == 4
    assert out["tok_per_s"] > 0 and out["prefill_tok_per_s"] > 0
    assert "[done] mamba2-370m" in capsys.readouterr().out


def test_federated_llm_round_on_the_cpu():
    hist = _example("torch_federated_llm_round").main(
        ["--device", "cpu", "--rounds", "1", "--tmax", "60"])
    assert hist.rounds == [1]
    assert math.isfinite(hist.train_loss[-1])


def test_federated_image_classification_on_the_cpu(capsys):
    hist = _example("torch_federated_image_classification").main(
        ["--device", "cpu", "--rounds", "1", "--clients", "4",
         "--methods", "adel,drop"])
    assert set(hist) == {"adel", "drop"}
    assert all(math.isfinite(h.accuracy[-1]) for h in hist.values())
    assert "A=adel" in capsys.readouterr().out


def test_fleet_scenarios_on_the_cpu(capsys):
    runs = _example("torch_fleet_scenarios").main(
        ["--device", "cpu", "--rounds", "1", "--fleet-size", "30"])
    assert set(runs) == {"longtail-mobile-diurnal", "datacenter-always-on"}
    assert all(len(r["rounds"]) == 1 for r in runs.values())
    assert "final: longtail-mobile-diurnal" in capsys.readouterr().out


def test_schedule_explorer_on_the_cpu(capsys):
    out = _example("torch_schedule_explorer").main(
        ["--device", "cpu", "--steps", "30"])
    assert len(out["profiles"]) == 6
    assert all(np.all(np.isfinite(s.T)) for s in out["profiles"].values())
    assert "objective (Theorem-1 bound)" in capsys.readouterr().out


@pytest.mark.parametrize("name", NAMES)
def test_examples_default_to_the_card(name):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the default runs there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _example(name).main([])
