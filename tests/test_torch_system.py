"""Direct pins of port pieces that other tests reach only indirectly, against
the reference on the same inputs:

* the top-k int8 fold (``core.compression.aggregate_compressed`` in
  ``topk8``) at kept fractions below 1, on ``tests/test_torch_agg_wire.py``'s
  shapes, against the reference's ``agg_impl="jnp"`` path. Both scatter
  the same dequantized values (``q * scale``, the same products) into
  zeros and fold them with the same coefficients in the same order, so the
  folds are equal bit for bit;
* the port's numpy copies ``data.synthetic.make_lm_dataset``,
  ``make_image_dataset`` and ``fl.partition.iid_partition``: equal arrays
  on several seeds and sizes;
* the straggler model's B3 properties (the port of
  ``tests/test_system.py:84-117``) on the port's ``core.straggler``;
* ``tests/test_backends.py:167 test_topk8_compressed_converges`` under the
  reference's draws, through the port's draw seam (ROADMAP 3.5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro.core import compression as rcmp
from repro.core.baselines import make_policy as ref_make_policy
from repro.core.scheduler import solve as ref_solve
from repro.core.types import AnalysisConfig as RefConfig
from repro.fl.server import run_federated as ref_run_federated
from repro.models.paper_models import make_mlp as ref_make_mlp
from repro.data import synthetic as rsyn
from repro.fl import partition as rpart
from repro_torch.convert import params_from_jax
from repro_torch.core.baselines import make_policy
from repro_torch.core.compression import (aggregate_compressed,
                                          compress_deltas, make_compression)
from repro_torch.core.scheduler import Schedule
from repro_torch.core.types import AnalysisConfig
from repro_torch.fl.server import run_federated
from repro_torch.models.paper_models import make_mlp
from repro_torch.core.straggler import (batch_sizes, contribution_mask,
                                        poisson_rates)
from repro_torch.data import synthetic as psyn
from repro_torch.fl import partition as ppart
from test_torch_agg_wire import _ids, _mask_p, _port, _t, _tree
from test_torch_fl import ReferenceDraws


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small CPU tensors: the suite runs
    several test processes at once, and their thread pools contend for
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("frac", [0.05, 0.25, 0.5])
def test_topk8_fold_equals_reference(frac, seed):
    grads, params = _tree(seed)
    ids, rids = _ids()
    mask, p = _mask_p(seed + 10)
    cfg = make_compression(("topk8", frac))
    payload = compress_deltas(_port(grads), ids, cfg)
    out = aggregate_compressed(payload, _port(params), ids, _t(mask), _t(p),
                               cfg=cfg)
    rcfg = rcmp.make_compression(("topk8", frac))
    rpayload = rcmp.compress_deltas({k: jnp.asarray(v) for k, v in
                                     grads.items()}, rids, rcfg)
    for ours, ref in zip(payload, rpayload):      # the same wire payload
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    ref = rcmp.aggregate_compressed(
        rpayload, {k: jnp.asarray(v) for k, v in params.items()}, rids,
        jnp.asarray(mask), jnp.asarray(p), cfg=rcfg, agg_impl="jnp")
    for key in params:
        assert bool(out[key].abs().sum() > 0)
        np.testing.assert_array_equal(out[key].numpy(), np.asarray(ref[key]))


@pytest.mark.parametrize("seed,vocab,n_tokens,order", [
    (0, 64, 2_000, 2), (3, 1024, 50_000, 2), (7, 512, 9_999, 3)])
def test_make_lm_dataset_equals_reference(seed, vocab, n_tokens, order):
    a = psyn.make_lm_dataset(vocab=vocab, n_tokens=n_tokens, seed=seed,
                             order=order)
    b = rsyn.make_lm_dataset(vocab=vocab, n_tokens=n_tokens, seed=seed,
                             order=order)
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed,kind,n_train", [
    (0, "mnist", 300), (4, "cifar", 200), (9, "mnist", 1_001)])
def test_make_image_dataset_equals_reference(seed, kind, n_train):
    ours = psyn.make_image_dataset(kind, n_train=n_train, n_test=37,
                                   seed=seed)
    ref = rsyn.make_image_dataset(kind, n_train=n_train, n_test=37, seed=seed)
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed,n,U", [(0, 100, 4), (5, 1_000, 7),
                                      (11, 33, 10)])
def test_iid_partition_equals_reference(seed, n, U):
    ours = ppart.iid_partition(n, U, seed=seed)
    ref = rpart.iid_partition(n, U, seed=seed)
    assert len(ours) == len(ref) == U
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)


@settings(deadline=None, max_examples=50)
@given(st.floats(0.5, 100.0), st.floats(1.0, 50.0),
       st.floats(0.1, 10.0), st.floats(0.0, 0.4))
def test_b3_batch_sizes_properties(T_d, m, P, Bfrac):
    """B3 invariants: S >= 1; S grows with m."""
    B = Bfrac * T_d
    s = float(batch_sizes(T_d, m, P, B))
    assert s >= 1.0
    assert float(batch_sizes(T_d, 2 * m, P, B)) >= s - 1e-6


@settings(deadline=None, max_examples=50)
@given(st.integers(1, 40), st.integers(0, 60))
def test_contribution_mask_is_suffix(L, z):
    """A client contributes a SUFFIX of layers (backprop reaches the output
    side first): mask rows are nondecreasing in l."""
    mask = contribution_mask(torch.tensor([float(z)]), L).numpy()[0]
    assert mask.shape == (L,)
    assert np.all(np.diff(mask) >= 0)
    assert mask.sum() == min(z, L)


@settings(deadline=None, max_examples=30)
@given(st.floats(1.0, 60.0), st.floats(1.0, 20.0))
def test_poisson_rate_lower_bound(T_d, m):
    """Appendix A: lambda_u >= T/m for every user in the feasible regime
    m P_u >= 1 (S_u >= 1 before clipping)."""
    P = np.asarray([0.5, 1.0, 3.0], np.float32)
    feasible = m * P >= 1.0
    lam = poisson_rates(T_d, m, P, np.zeros(3, np.float32)).numpy()
    assert np.all(lam[feasible] >= T_d / m - 1e-4)


# tests/test_backends.py:139 and :167
COMPRESSED_ACC_TOL = 0.02


def test_topk8_compressed_converges_under_reference_draws():
    """``tests/test_backends.py:167``'s setting (MLP, 600 samples over U=8
    Dirichlet(0.5) clients, 200 test samples, R=5, the reference's own
    150-step Adam schedule): dense ADEL against topk8 at a kept fraction
    of 0.5, the final accuracies within the reference's 0.02. Each port
    run replays the reference run's draws (its Poisson depths, minibatch
    indices and init) through the draw seam, so the port's gap is held to
    the same bar the reference's is, and each port trajectory to the
    reference's within one test sample in 100 (2 of 200)."""
    R, U = 5, 8
    x_tr, y_tr, x_te, y_te = psyn.make_image_dataset(
        "mnist", n_train=600, n_test=200, seed=0, noise_std=1.0)
    cx, cy, counts = ppart.stack_clients(x_tr, y_tr, ppart.dirichlet_partition(
        y_tr, U, alpha=0.5, seed=0))
    ref_model = ref_make_mlp()
    kw = dict(U=U, L=ref_model.L, R=R, T_max=R * ref_model.L * 0.5, eta0=2.0,
              seed=0)
    ref_cfg, cfg = RefConfig.default(**kw), AnalysisConfig.default(**kw)
    ref_sched = ref_solve(ref_cfg, "adam", steps=150)
    sched = Schedule(T=np.asarray(ref_sched.T), m=float(ref_sched.m),
                     objective=float(ref_sched.objective),
                     p1=np.asarray(ref_sched.p1))
    ref_data = tuple(jnp.asarray(a) for a in (cx, cy, counts, x_te, y_te))
    ref, port = {}, {}
    for name, comp in (("dense", None), ("topk8", ("topk8", 0.5))):
        _, ref[name] = ref_run_federated(
            ref_model, ref_make_policy("adel", ref_cfg, schedule=ref_sched),
            ref_cfg, *ref_data, key=jax.random.PRNGKey(0), backend="dense",
            compression=comp)
        draws = ReferenceDraws(0, R, ref_sched.T, ref_sched.m, ref_cfg)
        init = params_from_jax(jax.tree.map(
            np.asarray, ref_model.init(draws.k_init)), "cpu")
        _, port[name] = run_federated(
            make_mlp(), make_policy("adel", cfg, schedule=sched), cfg, cx, cy,
            counts, x_te, y_te, draws=draws, init_params=init,
            compression=comp, device="cpu")
    for name in ref:
        np.testing.assert_allclose(port[name].times, ref[name].times,
                                   rtol=1e-6)
        np.testing.assert_allclose(port[name].accuracy, ref[name].accuracy,
                                   rtol=0, atol=2.0 / len(y_te) + 1e-9)
    np.testing.assert_allclose(port["topk8"].times, port["dense"].times,
                               rtol=1e-6)
    ref_gap = abs(ref["topk8"].accuracy[-1] - ref["dense"].accuracy[-1])
    gap = abs(port["topk8"].accuracy[-1] - port["dense"].accuracy[-1])
    assert ref_gap <= COMPRESSED_ACC_TOL, ref_gap
    assert gap <= COMPRESSED_ACC_TOL, (gap, ref_gap)
