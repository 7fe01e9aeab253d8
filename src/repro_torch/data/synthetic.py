"""Synthetic datasets: a numpy-only copy of ``repro.data.synthetic``, so the
port builds the same data without importing the JAX package.

* ``make_image_dataset`` — procedural class-template image classification
  data with MNIST-like (28x28x1) or CIFAR-like (32x32x3) shapes. Each class
  is a smooth random template; samples are shifted, scaled and noised copies.
  Linear models reach moderate accuracy, convnets high accuracy — enough
  signal to reproduce the paper's *ordering* claims under a time budget.
* ``make_lm_dataset`` — deterministic synthetic token streams with local
  n-gram structure for the LM-architecture federated examples.
"""
from __future__ import annotations

import numpy as np

__all__ = ["make_image_dataset", "make_lm_dataset"]


def _smooth_noise(rng, shape, passes: int = 3):
    x = rng.standard_normal(shape).astype(np.float32)
    for _ in range(passes):
        for ax in range(len(shape) - 1):  # skip channel axis
            x = 0.5 * x + 0.25 * (np.roll(x, 1, ax) + np.roll(x, -1, ax))
    return x


def make_image_dataset(kind: str = "mnist", n_train: int = 6000,
                       n_test: int = 1000, n_classes: int = 10,
                       seed: int = 0, noise_std: float = 1.5,
                       templates_per_class: int = 3):
    """Returns (x_train, y_train, x_test, y_test); centered floats, NHWC.

    ``noise_std`` controls task difficulty (templates are unit-std).
    ``templates_per_class`` > 1 makes each class a UNION of clusters, so
    narrow models (e.g. HeteroFL width-reduced submodels) lack the capacity
    to separate all of them — matching the qualitative behaviour of the
    paper's real-image experiments.
    """
    if kind == "mnist":
        h, w, c = 28, 28, 1
    elif kind == "cifar":
        h, w, c = 32, 32, 3
    else:
        raise ValueError(kind)
    rng = np.random.default_rng(seed)
    K = templates_per_class
    templates = np.stack([
        _smooth_noise(rng, (h, w, c)) for _ in range(n_classes * K)])
    templates = templates / np.abs(templates).std(axis=(1, 2, 3), keepdims=True)

    def sample(n, rg):
        y = rg.integers(0, n_classes, n)
        sub = rg.integers(0, K, n)
        shift_y = rg.integers(-2, 3, n)
        shift_x = rg.integers(-2, 3, n)
        gain = rg.uniform(0.8, 1.2, n).astype(np.float32)
        x = templates[y * K + sub]
        for i in range(n):
            x[i] = np.roll(np.roll(x[i], shift_y[i], 0), shift_x[i], 1)
        x = gain[:, None, None, None] * x
        x = x + noise_std * rg.standard_normal(x.shape).astype(np.float32)
        x = x - x.mean()
        x = x / max(x.std(), 1e-6)   # zero-mean, unit-std (as real pipelines)
        return x.astype(np.float32), y.astype(np.int32)

    x_tr, y_tr = sample(n_train, np.random.default_rng(seed + 1))
    x_te, y_te = sample(n_test, np.random.default_rng(seed + 2))
    return x_tr, y_tr, x_te, y_te


def make_lm_dataset(vocab: int = 1024, n_tokens: int = 262144, seed: int = 0,
                    order: int = 2):
    """Markov token stream: learnable short-range structure."""
    rng = np.random.default_rng(seed)
    # sparse transition preference: each context prefers a few tokens
    n_ctx = 4096
    pref = rng.integers(0, vocab, size=(n_ctx, 4))
    toks = np.empty(n_tokens, np.int32)
    toks[:order] = rng.integers(0, vocab, order)
    state = int(toks[:order].sum()) % n_ctx
    for i in range(order, n_tokens):
        if rng.random() < 0.8:
            toks[i] = pref[state][rng.integers(0, 4)]
        else:
            toks[i] = rng.integers(0, vocab)
        state = (state * 31 + int(toks[i])) % n_ctx
    return toks
