"""The port's ADEL-FL math (``repro_torch.core``) against the reference on
the same inputs: the incomplete-gamma ladder, the Theorem-1 cost, the
straggler model and policies given the same depth draws, and the Problem-2
solver.

Tolerances: gamma and cost functions rtol 1e-5 (float32, different
operation order); masks and batch sizes exactly equal given the same z, and
``exact_p_layers`` / ``late_p_layers`` to rtol 1e-5 (the reference's
associative-scan logaddexp and ``torch.logcumsumexp`` differ in the last
bits); the 800-step Adam solve within 0.5% on the objective and rtol 1e-2
on T and m (800 Adam steps amplify float32 operation-order differences).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as rb
from repro.core import cost as rc
from repro.core import gamma as rg
from repro.core import scheduler as rs
from repro.core import straggler as rst
from repro.core.types import AnalysisConfig as RefConfig
from repro_torch.core import baselines as pb
from repro_torch.core import cost as pc
from repro_torch.core import gamma as pg
from repro_torch.core import scheduler as ps
from repro_torch.core import straggler as pst
from repro_torch.core.types import AnalysisConfig

QS = dict(U=10, L=3, R=25, T_max=60.0, eta0=2.0, seed=3)   # quickstart cfg


def _cfgs(**kw):
    return RefConfig.default(**kw), AnalysisConfig.default(**kw)


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


@pytest.mark.parametrize("L", [1, 3, 11])
def test_gamma_ladder(L):
    x = np.concatenate([np.linspace(0.05, 3.0, 17),
                        np.linspace(3.0, 60.0, 13)]).astype(np.float32)
    ref = jax.jit(lambda x: (rg.log_q_gamma_all(L, x), rg.q_gamma_all(L, x),
                             rg.layer_q(L, x), rg.poisson_cdf(L - 1, x),
                             rg.p_no_contributor(L, x, 10)))(jnp.asarray(x))
    out = (pg.log_q_gamma_all(L, _t(x)), pg.q_gamma_all(L, _t(x)),
           pg.layer_q(L, _t(x)), pg.poisson_cdf(L - 1, _t(x)),
           pg.p_no_contributor(L, _t(x), 10))
    for o, r in zip(out[:4], ref[:4]):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-6)
    # Q^U multiplies the ladder's relative error by U = 10: the reference's
    # associative-scan logaddexp sits up to 5e-6 below 1 where Q -> 1
    np.testing.assert_allclose(out[4].numpy(), np.asarray(ref[4]), rtol=1e-4,
                               atol=1e-7)


def test_q_inv():
    assert pg.q_inv(3, 0.3) == pytest.approx(rg.q_inv(3, 0.3), rel=1e-5)


@pytest.mark.parametrize("u_round", [False, True])
def test_cost_terms(u_round):
    ref_cfg, cfg = _cfgs(**QS)
    if u_round:
        ur = np.linspace(10.0, 4.0, QS["R"]).astype(np.float32)
        ref_cfg = dataclasses.replace(ref_cfg, U_round=ur, bytes_full=4e6,
                                      comm_scale=0.25)
        cfg = dataclasses.replace(cfg, U_round=ur, bytes_full=4e6,
                                  comm_scale=0.25)
    rng = np.random.default_rng(0)
    T = np.sort(rng.uniform(1.5, 4.0, QS["R"]))[::-1].astype(np.float32)
    m = np.float32(0.8)
    for rfn, pfn in ((rc.b_term, pc.b_term), (rc.c_term, pc.c_term),
                     (rc.p1_round, pc.p1_round),
                     (rc.theorem1_bound, pc.theorem1_bound)):
        ref = jax.jit(lambda T, m: rfn(T, m, ref_cfg))(jnp.asarray(T), m)
        np.testing.assert_allclose(pfn(_t(T), _t(m), cfg).numpy(),
                                   np.asarray(ref), rtol=1e-5)
    val, (obj, p1) = pc.objective_and_penalty(_t(T), _t(m), cfg)
    rval, (robj, rp1) = jax.jit(
        lambda T, m: rc.objective_and_penalty(T, m, ref_cfg))(
            jnp.asarray(T), m)
    np.testing.assert_allclose(float(val), float(rval), rtol=1e-5)
    np.testing.assert_allclose(p1.numpy(), np.asarray(rp1), rtol=1e-5)
    np.testing.assert_allclose(pc.upload_bytes(cfg).numpy(),
                               np.asarray(rc.upload_bytes(ref_cfg)), rtol=1e-6)


def test_straggler_given_same_depths():
    ref_cfg, cfg = _cfgs(**QS)
    T_d, m = 2.4, 0.76
    lam_r = rst.poisson_rates(T_d, m, jnp.asarray(ref_cfg.P),
                              jnp.asarray(ref_cfg.B_eff))
    lam_p = pst.poisson_rates(T_d, m, cfg.P, cfg.B_eff)
    np.testing.assert_allclose(lam_p.numpy(), np.asarray(lam_r), rtol=1e-6)
    assert np.array_equal(
        pst.batch_sizes(T_d, m, cfg.P, cfg.B_eff).numpy(),
        np.asarray(rst.batch_sizes(T_d, m, jnp.asarray(ref_cfg.P),
                                   jnp.asarray(ref_cfg.B_eff))))
    z = rst.sample_depths(jax.random.PRNGKey(7), lam_r)
    zt = torch.as_tensor(np.array(z))
    assert np.array_equal(pst.contribution_mask(zt, cfg.L).numpy(),
                          np.asarray(rst.contribution_mask(z, cfg.L)))
    np.testing.assert_allclose(pst.exact_p_layers(lam_p, cfg.L).numpy(),
                               np.asarray(rst.exact_p_layers(lam_r, cfg.L)),
                               rtol=1e-5, atol=1e-12)
    np.testing.assert_allclose(pst.late_p_layers(lam_p, cfg.L).numpy(),
                               np.asarray(rst.late_p_layers(lam_r, cfg.L)),
                               rtol=1e-5, atol=1e-12)
    np.testing.assert_allclose(
        pst.late_arrival_delays(zt, lam_p, cfg.B_eff, cfg.L).numpy(),
        np.asarray(rst.late_arrival_delays(z, lam_r, ref_cfg.B_eff, cfg.L)),
        rtol=1e-6)
    assert pst.fixed_batch(T_d, m, cfg) == float(
        rst.fixed_batch(T_d, m, ref_cfg))


class _ReplayDraws:
    """Hands the port the reference's own draws for round ``t``."""

    def __init__(self, key):
        self.key = key

    def poisson(self, t, lam):
        z = jax.random.poisson(self.key, jnp.asarray(lam.numpy()))
        return torch.as_tensor(np.array(z))

    def gamma(self, t, a, n):
        return torch.as_tensor(np.array(
            jax.random.gamma(self.key, a, shape=(n,))))


@pytest.mark.parametrize("method", ["adel", "salf", "drop", "wait"])
def test_policies_match_given_same_draws(method):
    ref_cfg, cfg = _cfgs(**QS)
    sch_r = rs.constant_schedule(ref_cfg, m=0.76)
    sch_p = ps.constant_schedule(cfg, m=0.76, device="cpu")
    rpol = rb.make_policy(method, ref_cfg, schedule=sch_r, m=0.76)
    ppol = pb.make_policy(method, cfg, schedule=sch_p, m=0.76, device="cpu")
    for t in (0, 7, 24):
        key = jax.random.PRNGKey(100 + t)
        rp = rpol.round(key, t)
        pp = ppol.round(_ReplayDraws(key), t)
        assert np.array_equal(pp.mask.numpy(), np.asarray(rp.mask))
        assert np.array_equal(pp.batch_sizes.numpy(),
                              np.asarray(rp.batch_sizes))
        np.testing.assert_allclose(pp.p.numpy(), np.asarray(rp.p),
                                   rtol=1e-5, atol=1e-12)
        assert pp.bias_correct == rp.bias_correct
        assert pp.elapsed == pytest.approx(rp.elapsed, rel=1e-6)


def test_heterofl_matches_reference_given_same_draws():
    ref_cfg, cfg = _cfgs(**QS)
    rpol = rb.make_policy("heterofl", ref_cfg, m=0.76)
    ppol = pb.make_policy("heterofl", cfg, m=0.76, device="cpu")
    assert isinstance(ppol, pb.HeteroFLPolicy)
    assert ppol.LEVELS == rpol.LEVELS
    assert np.array_equal(ppol.ratios, rpol.ratios)
    assert ppol.ratios.dtype == rpol.ratios.dtype == np.float32
    assert ppol.describe() == rpol.describe()
    for t in (0, 7, 24):
        key = jax.random.PRNGKey(200 + t)
        rp = rpol.round(key, t)
        pp = ppol.round(_ReplayDraws(key), t)
        assert np.array_equal(pp.mask.numpy(), np.asarray(rp.mask))
        assert np.array_equal(pp.batch_sizes.numpy(),
                              np.asarray(rp.batch_sizes))
        assert np.array_equal(pp.p.numpy(), np.asarray(rp.p))
        assert np.array_equal(pp.width_ratios, rp.width_ratios)
        assert pp.bias_correct is rp.bias_correct is False
        assert pp.elapsed == pytest.approx(rp.elapsed, rel=1e-6)


@pytest.mark.parametrize("U", [4, 7, 10, 33])
def test_heterofl_capability_ratios_match_reference(U):
    P = np.random.default_rng(U).uniform(0.5, 4.0, U).astype(np.float32)
    assert np.array_equal(pb.HeteroFLPolicy._capability_ratios(P),
                          rb.HeteroFLPolicy._capability_ratios(P))


def test_solve_adam_matches_reference():
    ref_cfg, cfg = _cfgs(**QS)
    ref = rs.solve(ref_cfg, "adam", steps=800)
    out = ps.solve(cfg, "adam", steps=800, device="cpu")
    assert out.objective == pytest.approx(ref.objective, rel=5e-3)
    np.testing.assert_allclose(out.T, ref.T, rtol=1e-2)
    assert out.m == pytest.approx(ref.m, rel=1e-2)
    np.testing.assert_allclose(out.p1, np.asarray(ref.p1), rtol=1e-2,
                               atol=1e-6)
    assert out.T.sum() == pytest.approx(cfg.T_max, rel=1e-5)
    assert np.all(np.diff(out.T) <= 1e-6)                 # nonincreasing
    assert np.array_equal(out.batch_sizes(cfg), ref.batch_sizes(ref_cfg))


def test_schedule_helpers_match_reference():
    ref_cfg, cfg = _cfgs(**QS)
    ref = rs.constant_schedule(ref_cfg)
    out = ps.constant_schedule(cfg, device="cpu")
    assert out.m == ref.m
    assert out.objective == pytest.approx(ref.objective, rel=1e-5)
    T = np.linspace(3.0, 1.9, QS["R"])
    np.testing.assert_allclose(ps.invert_schedule(cfg, T, 0.7),
                               np.asarray(rs.invert_schedule(ref_cfg, T, 0.7)),
                               rtol=1e-5)
