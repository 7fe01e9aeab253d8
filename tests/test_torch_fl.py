"""The port's round loop end to end: ``run_federated`` against the
reference's under the reference's own draws, and the paper's end-to-end
claims (``tests/test_fl_end2end.py``) under the port's own RNG.

Injected draws: the port cannot reproduce JAX's threefry draws, so the
test replays the reference's key sequence (``fl/runtime.py:493`` splits
``k_init``; ``:546`` splits ``(plan_key, k_round, k_batch)`` every round)
through the port's draw seam and starts from the reference's init. Then
every round's mask, ``p`` and minibatch are the reference's, and the
History agrees: accuracy within 2 test samples, loss rtol 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import straggler as rst
from repro.core.baselines import make_policy as ref_make_policy
from repro.core.types import AnalysisConfig as RefConfig
from repro.core.types import Schedule as RefSchedule
from repro.fl.server import run_federated as ref_run_federated
from repro.models.paper_models import make_mlp as ref_make_mlp
from repro_torch.convert import params_from_jax
from repro_torch.core.baselines import make_policy
from repro_torch.core.scheduler import solve
from repro_torch.core.types import AnalysisConfig
from repro_torch.data.synthetic import make_image_dataset
from repro_torch.fl.partition import dirichlet_partition, stack_clients
from repro_torch.fl.server import run_federated
from repro_torch.models.paper_models import make_mlp


@pytest.fixture(scope="module")
def mnist_setup():
    # the Fig.-2 regime of tests/test_fl_end2end.py
    x_tr, y_tr, x_te, y_te = make_image_dataset(
        "mnist", n_train=2500, n_test=800, seed=0, noise_std=1.0)
    U = 10
    parts = dirichlet_partition(y_tr, U, alpha=0.5, seed=0)
    cx, cy, counts = stack_clients(x_tr, y_tr, parts)
    return U, cx, cy, counts, x_te, y_te


class ReferenceDraws:
    """The reference run's draws, replayed round by round: its ``k_round``
    Poisson depths for the schedule and its ``k_batch`` minibatch indices."""

    def __init__(self, seed, R, sched_T, m, ref_cfg):
        key, self.k_init = jax.random.split(jax.random.PRNGKey(seed))
        depths = jax.jit(lambda k, T: rst.sample_round(k, T, m, ref_cfg)[3])
        self.z, self.k_batch = [], []
        for t in range(R):
            key, k_round, k_batch = jax.random.split(key, 3)
            self.z.append(torch.as_tensor(np.array(
                depths(k_round, jnp.float32(sched_T[t])))))
            self.k_batch.append(k_batch)

    def poisson(self, t, lam):
        return self.z[t]

    def batch_indices(self, t, U, s_max):
        idx = jax.random.randint(self.k_batch[t], (U, s_max), 0, 2 ** 30)
        return torch.as_tensor(np.array(idx))


def test_five_rounds_under_reference_draws(mnist_setup):
    U, cx, cy, counts, x_te, y_te = mnist_setup
    R = 5
    kw = dict(U=U, L=3, R=R, T_max=R * 3 * 0.5, eta0=2.0, seed=0)
    ref_cfg, cfg = RefConfig.default(**kw), AnalysisConfig.default(**kw)
    # both packages run the port's schedule (the solver has its own test)
    sched = solve(cfg, "adam", steps=200, device="cpu")
    ref_sched = RefSchedule(T=sched.T, m=sched.m, objective=sched.objective,
                            p1=sched.p1)
    ref_model = ref_make_mlp()
    _, ref_hist = ref_run_federated(
        ref_model, ref_make_policy("adel", ref_cfg, schedule=ref_sched),
        ref_cfg, jnp.asarray(cx), jnp.asarray(cy), jnp.asarray(counts),
        jnp.asarray(x_te), jnp.asarray(y_te), key=jax.random.PRNGKey(0))
    # the port plans with its own schedule and draws the reference's depths
    draws = ReferenceDraws(0, R, ref_sched.T, ref_sched.m, ref_cfg)
    init = params_from_jax(jax.tree.map(np.asarray,
                                        ref_model.init(draws.k_init)), "cpu")
    _, hist = run_federated(make_mlp(), make_policy("adel", cfg,
                                                    schedule=sched), cfg,
                            cx, cy, counts, x_te, y_te, draws=draws,
                            init_params=init, device="cpu")
    assert hist.rounds == ref_hist.rounds
    np.testing.assert_allclose(hist.times, ref_hist.times, rtol=1e-5)
    np.testing.assert_allclose(hist.accuracy, ref_hist.accuracy, rtol=0,
                               atol=2.0 / len(y_te) + 1e-9)
    np.testing.assert_allclose(hist.train_loss, ref_hist.train_loss,
                               rtol=1e-4)


_RUNS: dict = {}


def _run(method, mnist_setup, R=25):
    """A port run under the port's own RNG (cached per method and R)."""
    if (method, R) not in _RUNS:
        U, cx, cy, counts, x_te, y_te = mnist_setup
        model = make_mlp()
        cfg = AnalysisConfig.default(U=U, L=model.L, R=R,
                                     T_max=R * model.L * 0.5, eta0=2.0, seed=0)
        schedule = (solve(cfg, "adam", steps=800, device="cpu")
                    if method == "adel" else None)
        policy = make_policy(method, cfg, schedule=schedule, device="cpu")
        _, _RUNS[(method, R)] = run_federated(
            model, policy, cfg, cx, cy, counts, x_te, y_te, seed=0,
            eval_every=5, device="cpu")
    return _RUNS[(method, R)]


def test_adel_runs_and_learns(mnist_setup):
    hist = _run("adel", mnist_setup)
    assert len(hist.accuracy) >= 3
    assert hist.accuracy[-1] > 0.3, hist.accuracy
    assert hist.times[-1] <= 37.5 * 1.001


def test_adel_beats_drop_stragglers(mnist_setup):
    acc_adel = _run("adel", mnist_setup).accuracy[-1]
    acc_drop = _run("drop", mnist_setup).accuracy[-1]
    assert acc_adel > acc_drop, (acc_adel, acc_drop)


def test_adel_at_least_matches_salf(mnist_setup):
    acc_adel = np.mean(_run("adel", mnist_setup, R=40).accuracy[-2:])
    acc_salf = np.mean(_run("salf", mnist_setup, R=40).accuracy[-2:])
    assert acc_adel >= acc_salf - 0.02, (acc_adel, acc_salf)


def test_wait_fits_fewer_rounds(mnist_setup):
    h_wait = _run("wait", mnist_setup)
    h_adel = _run("adel", mnist_setup)
    assert h_wait.rounds[-1] < h_adel.rounds[-1]
