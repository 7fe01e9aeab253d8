"""``repro_torch.fl.calibrate.calibrate_constants`` (pilot estimates of
Theorem 1's sigma_u^2 and G^2): the port of
``tests/test_extensions.py::test_calibrate_constants_shapes_and_positive``,
and ``sigma2`` / ``G2`` against the reference's on the same params (the
reference's init through ``params_from_jax``) and data, rtol 1e-4 (the
gradients' tolerance against ``jax.grad``; XLA-CPU and ATen sum in
different orders).
"""
import jax
import numpy as np
import pytest
import torch

from repro.core.types import AnalysisConfig as RefAnalysisConfig
from repro.fl.calibrate import calibrate_constants as ref_calibrate
from repro.models.paper_models import make_cnn as ref_make_cnn
from repro.models.paper_models import make_mlp as ref_make_mlp
from repro_torch.convert import params_from_jax
from repro_torch.core.types import AnalysisConfig
from repro_torch.data.synthetic import make_image_dataset
from repro_torch.fl.calibrate import calibrate_constants
from repro_torch.fl.partition import iid_partition, stack_clients
from repro_torch.models.paper_models import make_cnn, make_mlp

REF_TOL = dict(rtol=1e-4, atol=0.0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small CPU tensors: the suite runs
    several test processes at once, and their thread pools contend for
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(kind, U, n_train):
    x, y, _, _ = make_image_dataset(kind, n_train=n_train, n_test=10, seed=0)
    return stack_clients(x, y, iid_partition(len(y), U, seed=0))


def test_calibrate_constants_shapes_and_positive():
    U = 4
    cx, cy, counts = _data("mnist", U, 300)
    model = make_mlp()
    cfg = AnalysisConfig.default(U=U, L=model.L, R=5, T_max=10.0, seed=0)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    out = calibrate_constants(cfg, model, params, cx, cy, counts,
                              n_probe=16)
    assert out.sigma2.shape == (U,) and out.sigma2.dtype == np.float32
    assert np.all(out.sigma2 > 0)
    assert out.G2 > 0
    assert out.R == cfg.R and out.U == cfg.U


@pytest.mark.parametrize("model_name,kind,n_probe,g_ref", [
    ("mlp", "mnist", 16, 8), ("mlp", "mnist", 3, 1), ("cnn", "mnist", 8, 4)])
def test_calibrate_constants_match_reference(model_name, kind, n_probe,
                                             g_ref):
    """The same params and client arrays through both packages; a client
    with fewer samples than ``n_probe`` (a padded row count below it) and
    the ``max(n, 2)`` floor are exercised by ``n_per_client``."""
    U = 4
    cx, cy, counts = _data(kind, U, 240)
    counts = np.asarray(counts).copy()
    counts[1] = 1                     # the floor: 2 samples
    counts[2] = min(int(counts[2]), 5)
    ref_model = {"mlp": ref_make_mlp, "cnn": ref_make_cnn}[model_name]()
    model = {"mlp": make_mlp, "cnn": make_cnn}[model_name]()
    ref_params = jax.tree.map(np.asarray,
                              ref_model.init(jax.random.PRNGKey(1)))
    ref = ref_calibrate(RefAnalysisConfig.default(U=U, L=ref_model.L, R=5,
                                                  T_max=10.0, seed=0),
                        ref_model, ref_params, cx, cy, counts,
                        n_probe=n_probe, g_ref_batch=g_ref)
    out = calibrate_constants(
        AnalysisConfig.default(U=U, L=model.L, R=5, T_max=10.0, seed=0),
        model, params_from_jax(ref_params, "cpu"), cx, cy, counts,
        n_probe=n_probe, g_ref_batch=g_ref)
    np.testing.assert_allclose(out.sigma2, np.asarray(ref.sigma2), **REF_TOL)
    np.testing.assert_allclose(out.G2, ref.G2, **REF_TOL)
