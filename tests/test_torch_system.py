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
  ``tests/test_system.py:84-117``) on the port's ``core.straggler``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro.core import compression as rcmp
from repro.data import synthetic as rsyn
from repro.fl import partition as rpart
from repro_torch.core.compression import (aggregate_compressed,
                                          compress_deltas, make_compression)
from repro_torch.core.straggler import (batch_sizes, contribution_mask,
                                        poisson_rates)
from repro_torch.data import synthetic as psyn
from repro_torch.fl import partition as ppart
from test_torch_agg_wire import _ids, _mask_p, _port, _t, _tree


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
