"""Client data partitioning: IID and Dirichlet non-IID (Hsu et al. 2019),
as used in the paper's CIFAR-10 experiments (alpha = 0.5).

A numpy-only copy of ``repro.fl.partition``."""
from __future__ import annotations

import numpy as np

__all__ = ["iid_partition", "dirichlet_partition", "stack_clients"]


def iid_partition(n: int, U: int, seed: int = 0) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    return [np.sort(s) for s in np.array_split(perm, U)]


def dirichlet_partition(labels: np.ndarray, U: int, alpha: float = 0.5,
                        seed: int = 0, min_per_client: int = 2) -> list[np.ndarray]:
    """Sample client-specific label proportions from Dir(alpha) and allocate."""
    rng = np.random.default_rng(seed)
    labels = np.asarray(labels)
    classes = np.unique(labels)
    client_idx: list[list[int]] = [[] for _ in range(U)]
    for c in classes:
        idx = rng.permutation(np.where(labels == c)[0])
        props = rng.dirichlet(np.full(U, alpha))
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for u, part in enumerate(np.split(idx, cuts)):
            client_idx[u].extend(part.tolist())
    # guarantee a minimum per client (move from the largest donors)
    for u in range(U):
        while len(client_idx[u]) < min_per_client:
            donor = int(np.argmax([len(ci) for ci in client_idx]))
            client_idx[u].append(client_idx[donor].pop())
    return [np.sort(np.asarray(ci, dtype=np.int64)) for ci in client_idx]


def stack_clients(x: np.ndarray, y: np.ndarray, parts: list[np.ndarray],
                  n_pad: int | None = None
                  ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad per-client shards to a common N and stack to (U, N, ...).

    Padding repeats each client's own data (valid counts returned separately),
    so with-replacement sampling never sees foreign samples. ``n_pad``
    overrides the common N (callers needing a jit-stable shape across
    varying client subsets, e.g. the fleet engine, pass a fixed one).
    """
    U = len(parts)
    n_max = max(len(p) for p in parts) if n_pad is None else int(n_pad)
    xs = np.zeros((U, n_max) + x.shape[1:], x.dtype)
    ys = np.zeros((U, n_max), y.dtype)
    counts = np.zeros((U,), np.int32)
    for u, p in enumerate(parts):
        k = len(p)
        reps = int(np.ceil(n_max / k))
        tiled = np.tile(p, reps)[:n_max]
        xs[u] = x[tiled]
        ys[u] = y[tiled]
        counts[u] = min(k, n_max)   # never index past an n_pad truncation
    return xs, ys, counts
