"""The paper's theory in the port, against the reference on the same numpy
inputs: the ports of ``tests/test_gamma.py`` (the incomplete-gamma ladder,
the Auxiliary Lemma), ``tests/test_lemma1.py`` (Lemma 1), ``tests/
test_scheduler.py`` (the Problem-2 solvers), ``tests/test_unbiasedness.py``
(Lemma 2 and the late-set fold), ``tests/test_variance.py`` (Lemma 3) and
``tests/test_extensions.py`` without ``calibrate`` (``q_inv``, the solver's
feasibility, ``solve_rounds``; ``fl/calibrate.py`` has its own file,
``tests/test_torch_calibrate.py``).

Tolerances: the ladder and the exact probabilities rtol 1e-5 / atol 1e-6
(f32 log-space sums in another order, ``tests/test_torch_core.py``); a
power ``Q^U`` multiplies that relative error by U, so rtol U x 1e-5. The
Monte-Carlo tests draw from the port's own generator (its Poisson draws
cannot be the reference's) and hold the estimate to the same analytic
target and slack as the reference's test, after checking that the target
is the same in both packages. Solver objectives rtol 5e-3 (Adam in f32 on
another framework's autodiff, as ``tests/test_torch_core.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st
from scipy.special import gammaincc
from scipy.stats import poisson

from repro.core import cost as rc
from repro.core import gamma as rg
from repro.core import scheduler as rs
from repro.core import straggler as rst
from repro.core.types import AnalysisConfig as RefConfig
from repro_torch.core import cost as pc
from repro_torch.core import gamma as pg
from repro_torch.core import scheduler as ps
from repro_torch.core import straggler as pst
from repro_torch.core.aggregation import (aggregate_grads,
                                          aggregate_with_coeffs,
                                          layer_coefficients)
from repro_torch.core.types import AnalysisConfig


def _f(x):
    return torch.tensor(x, dtype=torch.float32)


def _cfgs(**kw):
    ref, port = RefConfig.default(**kw), AnalysisConfig.default(**kw)
    for name in ("P", "B", "eta", "sigma2"):
        np.testing.assert_array_equal(np.asarray(getattr(port, name)),
                                      np.asarray(getattr(ref, name)))
    return ref, port


# ---------------------------------------------------------------------------
# test_gamma: the Auxiliary Lemma ladder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [1, 2, 5, 17])
@pytest.mark.parametrize("x", [0.0, 0.3, 1.0, 7.5, 40.0])
def test_q_gamma_matches_scipy_and_reference(s, x):
    ours = float(pg.q_gamma(s, _f(x)))
    assert abs(ours - float(gammaincc(s, x))) < 1e-5, (s, x, ours)
    ref = float(rg.q_gamma(s, jnp.float32(x)))
    assert abs(ours - ref) <= 1e-6 + 1e-5 * abs(ref), (s, x, ours, ref)


def test_poisson_cdf_identity():
    """Q(s, x) = P[Poisson(x) <= s-1], in both packages."""
    for lam in [0.1, 2.0, 9.0]:
        for k in range(6):
            ours = float(pg.poisson_cdf(k, _f(lam)))
            assert abs(ours - float(poisson.cdf(k, lam))) < 1e-5
            ref = float(rg.poisson_cdf(k, jnp.float32(lam)))
            assert abs(ours - ref) <= 1e-6 + 1e-5 * abs(ref)


def test_ladder_consistent():
    x = np.asarray([0.5, 3.0, 12.0], np.float32)
    all_q = pg.q_gamma_all(8, torch.from_numpy(x))
    for s in range(1, 9):
        np.testing.assert_allclose(all_q[:, s - 1].numpy(),
                                   [float(pg.q_gamma(s, _f(v))) for v in x],
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(all_q.numpy(),
                               np.asarray(rg.q_gamma_all(8, jnp.asarray(x))),
                               rtol=1e-5, atol=1e-6)


def test_layer_monotonicity():
    """p_t^l decreases with the layer index l (layer L easiest)."""
    L = 10
    q = pg.layer_q(L, _f(4.0)).numpy()
    assert q.shape == (L,)
    assert np.all(np.diff(q) <= 1e-7)
    assert q[-1] == pytest.approx(np.exp(-4.0), rel=1e-4)   # Q(1, x) = e^-x
    np.testing.assert_allclose(q, np.asarray(rg.layer_q(L, jnp.float32(4.0))),
                               rtol=1e-5, atol=1e-6)


@settings(deadline=None, max_examples=40)
@given(st.integers(1, 30), st.floats(0.01, 60.0), st.integers(1, 40))
def test_lemma1_bound_properties(L, x, U):
    """0 <= Q^U <= 1, monotone in U, and log-stable for large x."""
    p = pg.p_no_contributor(L, _f(x), U).numpy()
    assert p.shape == (L,)
    assert np.all(p >= 0) and np.all(p <= 1 + 1e-6)
    p2 = pg.p_no_contributor(L, _f(x), U + 1).numpy()
    assert np.all(p2 <= p + 1e-6)
    assert np.all(np.isfinite(p))


@pytest.mark.parametrize("L,U", [(1, 1), (7, 12), (30, 40)])
def test_lemma1_bound_matches_reference(L, U):
    """The bound over the hypothesis test's x range, rtol U x 1e-5."""
    x = np.geomspace(0.01, 60.0, 25).astype(np.float32)
    ours = torch.stack([pg.p_no_contributor(L, _f(v), U) for v in x])
    ref = np.stack([np.asarray(v) for v in jax.jit(jax.vmap(
        lambda v: rg.p_no_contributor(L, v, U)))(jnp.asarray(x))])
    np.testing.assert_allclose(ours.numpy(), ref, rtol=U * 1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# test_lemma1: p_t^l against its bound, Monte-Carlo
# ---------------------------------------------------------------------------

def _lemma_cfgs(U=12, L=8, seed=3):
    return _cfgs(U=U, L=L, R=10, T_max=100.0, seed=seed)


def test_lemma1_montecarlo_bound():
    ref_cfg, cfg = _lemma_cfgs()
    T_d, m = 9.0, 1.2
    emp = pst.simulate_p_empirical(T_d, m, cfg, n_trials=4000)
    bound = pg.p_no_contributor(cfg.L, _f(T_d / m), cfg.U).numpy()
    np.testing.assert_allclose(
        bound, np.asarray(rg.p_no_contributor(cfg.L, jnp.float32(T_d / m),
                                              cfg.U)),
        rtol=cfg.U * 1e-5, atol=1e-7)
    # Monte-Carlo noise: 3-sigma slack on 4000 trials
    sigma = np.sqrt(np.maximum(bound * (1 - bound), 1e-4) / 4000)
    assert np.all(emp <= bound + 3 * sigma), (emp, bound)


def test_exact_p_below_lemma1_bound():
    """The exact product form is at most the Lemma-1 bound, which replaces
    every lambda_u by the uniform lower bound T/m; the exact form equals
    the reference's."""
    ref_cfg, cfg = _lemma_cfgs(U=20, L=12)
    T_d, m = 7.0, 1.0
    lam = pst.poisson_rates(T_d, m, cfg.P, cfg.B)
    ref_lam = rst.poisson_rates(T_d, m, jnp.asarray(ref_cfg.P),
                                jnp.asarray(ref_cfg.B))
    np.testing.assert_allclose(lam.numpy(), np.asarray(ref_lam), rtol=1e-6)
    exact = pst.exact_p_layers(lam, cfg.L).numpy()
    np.testing.assert_allclose(exact,
                               np.asarray(rst.exact_p_layers(ref_lam, cfg.L)),
                               rtol=1e-4, atol=1e-7)
    bound = pg.p_no_contributor(cfg.L, _f(T_d / m), cfg.U).numpy()
    assert np.all(exact <= bound + 1e-6)


def test_empirical_matches_exact_p():
    ref_cfg, cfg = _lemma_cfgs(U=10, L=6, seed=7)
    T_d, m = 6.0, 1.5
    emp = pst.simulate_p_empirical(T_d, m, cfg, n_trials=8000, seed=5)
    lam = pst.poisson_rates(T_d, m, cfg.P, cfg.B)
    exact = pst.exact_p_layers(lam, cfg.L).numpy()
    ref = np.asarray(rst.exact_p_layers(
        rst.poisson_rates(T_d, m, jnp.asarray(ref_cfg.P),
                          jnp.asarray(ref_cfg.B)), cfg.L))
    np.testing.assert_allclose(exact, ref, rtol=1e-4, atol=1e-7)
    sigma = np.sqrt(np.maximum(exact * (1 - exact), 1e-4) / 8000)
    assert np.all(np.abs(emp - exact) <= 4 * sigma + 5e-3), (emp, exact)


# ---------------------------------------------------------------------------
# test_scheduler: the Problem-2 solvers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sched_cfgs():
    return _cfgs(U=10, L=8, R=12, T_max=120.0, seed=1)


@pytest.fixture(scope="module")
def adam_1200(sched_cfgs):
    ref_cfg, cfg = sched_cfgs
    return (ps.solve_adam(cfg, steps=1200, device="cpu"),
            rs.solve_adam(ref_cfg, steps=1200))


def _check_feasible(s, cfg):
    assert s.T.shape == (cfg.R,)
    assert np.all(s.T > 0)
    assert s.T.sum() <= cfg.T_max * (1 + 1e-4)
    assert np.all(np.diff(s.T) <= 1e-5), "deadlines must be nonincreasing"
    assert np.all(np.asarray(s.p1) < 0.2 + 1e-6), "Lemma-3 validity"
    assert s.m >= 1.0


def test_adam_solver_feasible_and_improves(sched_cfgs, adam_1200):
    ref_cfg, cfg = sched_cfgs
    s, ref = adam_1200
    base = ps.constant_schedule(cfg, device="cpu")
    _check_feasible(s, cfg)
    assert s.objective <= base.objective * (1 + 1e-5)
    assert s.objective == pytest.approx(ref.objective, rel=5e-3)
    assert base.objective == pytest.approx(
        rs.constant_schedule(ref_cfg).objective, rel=1e-5)


def test_trust_region_solver_feasible_and_improves(sched_cfgs):
    ref_cfg, cfg = sched_cfgs
    base = ps.constant_schedule(cfg, device="cpu")
    s = ps.solve_trust_region(cfg, maxiter=150, device="cpu")
    _check_feasible(s, cfg)
    assert s.objective <= base.objective * (1 + 1e-4)
    ref = rs.solve_trust_region(ref_cfg, maxiter=150)
    assert s.objective == pytest.approx(ref.objective, rel=5e-3)


def test_deadlines_decrease_like_paper(adam_1200):
    """Fig. 2a/3a: the optimized allocation decreases over rounds, in
    both packages."""
    s, ref = adam_1200
    assert s.T[0] > s.T[-1] and ref.T[0] > ref.T[-1]


def test_batch_sizes_b3(sched_cfgs):
    ref_cfg, cfg = sched_cfgs
    s = ps.solve_adam(cfg, steps=300, device="cpu")
    S = s.batch_sizes(cfg)
    assert S.shape == (cfg.R, cfg.U)
    assert np.all(S >= 1)
    fast, slow = np.argmax(cfg.P), np.argmin(cfg.P)
    assert S[0, fast] >= S[0, slow]
    # the same (T, m) give the same B3 batch sizes in the reference
    ref = rs.Schedule(T=s.T, m=s.m, objective=s.objective, p1=s.p1)
    np.testing.assert_array_equal(S, np.asarray(ref.batch_sizes(ref_cfg)))


# ---------------------------------------------------------------------------
# test_unbiasedness: Lemma 2, Monte-Carlo on the port's generator
# ---------------------------------------------------------------------------

def _mc_folds(g, ids, n, seed, coeffs_of):
    """n draws of the Eq. 5 fold of fixed grads ``g`` under exchangeable
    rates (lam = 5): the port's Poisson draws, its masks and its fold."""
    gen = torch.Generator().manual_seed(seed)
    lam = torch.full((g.shape[0],), 5.0)
    out = []
    for _ in range(n):
        mask = pst.contribution_mask(pst.sample_depths(gen, lam), g.shape[1])
        out.append(aggregate_with_coeffs({"w": g}, {"w": ids},
                                         coeffs_of(mask))["w"])
    return torch.stack(out)


def _grads(U, L, F, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (U, L, F)).astype(np.float32))


def test_unbiased_montecarlo():
    """E[g~^l] = (1 - p_l) * masked mean / (1 - p_l) = the FedAvg mean,
    under B3's exchangeable rates."""
    U, L, F = 8, 5, 12
    g, ids = _grads(U, L, F, 0), torch.arange(L)
    lam = torch.full((U,), 5.0)
    p = pst.exact_p_layers(lam, L)
    np.testing.assert_allclose(
        p.numpy(), np.asarray(rst.exact_p_layers(jnp.full((U,), 5.0), L)),
        rtol=1e-5, atol=1e-7)
    agg = _mc_folds(g, ids, 6000, 42, lambda m: layer_coefficients(m, p))
    mean, se = agg.mean(0), agg.std(0) / np.sqrt(agg.shape[0])
    err = (mean - g.mean(0)).abs()
    assert bool((err <= 4.5 * se + 2e-3).all()), (float(err.max()),
                                                  float(se.max()))


def test_late_fold_unbiased_montecarlo():
    """Eq. 5 on the LATE mask ``1 - mask`` with the late-set probabilities
    estimates the same FedAvg mean (the buffered backend's carried fold at
    staleness weight 1)."""
    U, L, F = 8, 5, 12
    g, ids = _grads(U, L, F, 1), torch.arange(L)
    lam = torch.full((U,), 5.0)
    p_late = pst.late_p_layers(lam, L)
    np.testing.assert_allclose(
        p_late.numpy(), np.asarray(rst.late_p_layers(jnp.full((U,), 5.0), L)),
        rtol=1e-4, atol=1e-7)
    agg = _mc_folds(g, ids, 6000, 43,
                    lambda m: layer_coefficients(1.0 - m, p_late))
    mean, se = agg.mean(0), agg.std(0) / np.sqrt(agg.shape[0])
    err = (mean - g.mean(0)).abs()
    assert bool((err <= 4.5 * se + 2e-3).all()), (float(err.max()),
                                                  float(se.max()))


def test_late_p_layers_mirrors_exact_p():
    """p_late^l is the probability that NO client is late at layer l:
    equal to the reference's, and to a direct Monte-Carlo estimate."""
    U, L = 6, 4
    lam_np = np.asarray([2.0, 3.0, 5.0, 7.0, 4.0, 6.0], np.float32)
    p_late = pst.late_p_layers(torch.from_numpy(lam_np), L).numpy()
    np.testing.assert_allclose(
        p_late, np.asarray(rst.late_p_layers(jnp.asarray(lam_np), L)),
        rtol=1e-4, atol=1e-7)
    gen = torch.Generator().manual_seed(7)
    z = torch.poisson(torch.from_numpy(lam_np).expand(20000, U).contiguous(),
                      generator=gen)
    thresh = L - torch.arange(L)
    late = (z[:, :, None] < thresh).to(torch.float32)       # (n, U, L)
    mc = (late.sum(1) == 0).to(torch.float32).mean(0).numpy()
    np.testing.assert_allclose(p_late, mc, atol=0.02)
    assert np.all(np.diff(p_late) >= -1e-6)


def test_layer_preserved_when_empty():
    """A layer nobody reached keeps its params (g~ = 0); the others are
    bias-corrected; the reference gives the same values."""
    U, L, F = 4, 3, 7
    g = np.ones((U, L, F), np.float32)
    mask = np.ones((U, L), np.float32)
    mask[:, 0] = 0.0
    p = np.asarray([0.9, 0.1, 0.0], np.float32)
    agg = aggregate_grads({"w": torch.from_numpy(g)}, {"w": torch.arange(L)},
                          torch.from_numpy(mask), torch.from_numpy(p))["w"]
    np.testing.assert_allclose(agg[0].numpy(), 0.0)
    np.testing.assert_allclose(agg[1].numpy(), 1.0 / (1 - 0.1), rtol=1e-6)
    np.testing.assert_allclose(agg[2].numpy(), 1.0, rtol=1e-6)
    from repro.core.aggregation import aggregate_grads as ref_agg
    ref = ref_agg({"w": jnp.asarray(g)}, {"w": jnp.arange(L)},
                  jnp.asarray(mask), jnp.asarray(p))["w"]
    np.testing.assert_allclose(agg.numpy(), np.asarray(ref), rtol=1e-6)


# ---------------------------------------------------------------------------
# test_variance: Lemma 3
# ---------------------------------------------------------------------------

def _var_cfg(cls, U, L, R, T_max, eta):
    return cls(U=U, L=L, R=R, T_max=T_max, eta=np.asarray(eta), rho_c=0.1,
               rho_s=1.0, sigma2=np.ones(U), G2=1.0, het_gap=0.0,
               P=np.ones(U), B=np.zeros(U))


def test_variance_bound_single_round():
    """E||w~ - w||^2 <= eta^2 C_t for one round, Monte-Carlo; C_t equal to
    the reference's."""
    U, L, F = 12, 6, 16
    eta = 0.1
    g = _grads(U, L, F, 0)
    g = g / torch.linalg.norm(g.reshape(U, -1), dim=1)[:, None, None]
    T_d, m = 8.0, 1.0
    lam = torch.full((U,), T_d / m)
    p = pst.exact_p_layers(lam, L)
    assert float(p[0]) < 0.2, "the setup must satisfy p_t^1 < 0.2"
    gen = torch.Generator().manual_seed(7)
    fedavg = g.mean(0)
    sq = []
    for _ in range(4000):
        mask = pst.contribution_mask(pst.sample_depths(gen, lam), L)
        a = aggregate_grads({"w": g}, {"w": torch.arange(L)}, mask, p)["w"]
        sq.append(float((((a - fedavg) * eta) ** 2).sum()))
    var = float(np.mean(sq))
    cfg = _var_cfg(AnalysisConfig, U, L, 1, T_d, [eta])
    ref_cfg = _var_cfg(RefConfig, U, L, 1, T_d, [eta])
    c = float(pc.c_term(_f([T_d]), _f(m), cfg)[0])
    assert c == pytest.approx(float(rc.c_term(jnp.asarray([T_d], jnp.float32),
                                              jnp.float32(m), ref_cfg)[0]),
                              rel=1e-5)
    assert 0.0 < var <= eta ** 2 * c, (var, eta ** 2 * c)


def test_variance_decreases_with_deadline():
    """Longer deadlines (relative to m) shrink the truncation variance
    term C_t, in both packages alike."""
    U, L = 10, 8
    cfg = _var_cfg(AnalysisConfig, U, L, 3, 100.0, np.full(3, 0.1))
    ref_cfg = _var_cfg(RefConfig, U, L, 3, 100.0, np.full(3, 0.1))
    T = np.asarray([9.0, 7.0, 5.5], np.float32)
    c = pc.c_term(torch.from_numpy(T), _f(1.0), cfg).numpy()
    assert c[0] < c[1] < c[2]
    np.testing.assert_allclose(
        c, np.asarray(rc.c_term(jnp.asarray(T), jnp.float32(1.0), ref_cfg)),
        rtol=1e-5)


# ---------------------------------------------------------------------------
# test_extensions (without calibrate): q_inv, feasibility, solve_rounds
# ---------------------------------------------------------------------------

def test_q_inv_inverts_q():
    for s in (3, 10, 40):
        for target in (0.9, 0.5, 0.1):
            x = pg.q_inv(s, target)
            assert abs(float(pg.q_gamma(s, _f(x))) - target) < 1e-3
            assert x == pytest.approx(rg.q_inv(s, target), rel=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_solver_feasible_by_construction(seed):
    _, cfg = _cfgs(U=8, L=12, R=20, T_max=150.0, eta0=0.5, seed=seed)
    sch = ps.solve(cfg, "adam", steps=500, device="cpu")
    assert np.all(np.diff(sch.T) <= 1e-5)
    assert sch.T.sum() <= cfg.T_max * (1 + 1e-5)
    assert np.all(sch.p1 < 0.2), sch.p1.max()
    assert np.all(sch.batch_sizes(cfg) >= 1)


def test_solve_rounds_at_least_as_good_as_fixed_R():
    ref_cfg, cfg = _cfgs(U=10, L=10, R=30, T_max=120.0, eta0=0.5, seed=0)
    fixed = ps.solve(cfg, "adam", steps=400, device="cpu")
    sch, cfg_r = ps.solve_rounds(cfg, "adam", steps=400, device="cpu")
    assert sch.objective <= fixed.objective * (1 + 1e-4)
    assert cfg_r.R in range(2, 61)
    assert sch.T.shape == (cfg_r.R,)
    # the chosen schedule costs the same under the reference's Theorem-1
    # bound at the same R and learning rates
    ref_cfg_r = dataclasses.replace(ref_cfg, R=cfg_r.R, eta=cfg_r.eta)
    ref_obj = float(rc.theorem1_bound(jnp.asarray(sch.T, jnp.float32),
                                      jnp.float32(sch.m), ref_cfg_r))
    assert sch.objective == pytest.approx(ref_obj, rel=1e-5)
