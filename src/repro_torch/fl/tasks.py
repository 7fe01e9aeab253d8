"""Task adapters: what the round runtime trains and evaluates (port of
``repro.fl.tasks``).

A :class:`Task` bundles the three task-specific pieces the
:class:`repro_torch.fl.runtime.RoundRuntime` needs, so the round loop
itself stays workload-agnostic:

* a :class:`repro_torch.fl.runtime.ModelAPI` (init / loss / predict /
  layer_ids / optional HeteroFL width masks),
* a data source in cohort form — classification tasks carry
  ``(U, n, feat...)`` inputs with integer labels, LM tasks carry
  ``(U, n, seq+1)`` token ROWS whose shifted-label split
  ``tok = x[:, :-1], lab = x[:, 1:]`` happens INSIDE the model's loss, so
  :func:`repro_torch.fl.client.sample_client_batches` handles both payloads
  identically (the label array is all-zero and unused for LM),
* eval metrics — classification accuracy + head loss
  (:func:`repro_torch.fl.runtime.eval_metrics`) or next-token accuracy +
  token CE (:func:`lm_eval_metrics`), both kept on the device until a
  report boundary reads them.

:func:`make_lm_model` adapts the LM backbone
(:mod:`repro_torch.models.transformer`, every family) to the ``ModelAPI``
contract, with FFN-hidden-width HeteroFL masks.
:func:`lm_task` builds the synthetic-token-stream task of the LM training
entry point (:mod:`repro_torch.launch.train`), and :func:`lm_fleet_data`
packages the same streams as a :class:`repro_torch.fleet.engine.FleetData`
so LM workloads run against simulated device fleets.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.data.synthetic import make_lm_dataset
from repro_torch.device import resolve_device
from repro_torch.fl.runtime import (DeviceRatio, ModelAPI, StaticCohortSource,
                                    eval_metrics)
from repro_torch.models import transformer as tr

PyTree = Any

__all__ = ["Task", "classification_task", "lm_task", "lm_fleet_data",
           "make_lm_model", "lm_eval_metrics"]


# ---------------------------------------------------------------------------
# the Task bundle
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Task:
    """One workload for the round runtime.

    ``client_x``/``client_y``/``counts`` are the pre-stacked population
    (what :class:`repro_torch.fl.runtime.StaticCohortSource` replays every
    round); ``test_x``/``test_y`` the held-out eval split. ``kind`` selects
    the eval metrics: ``"classification"`` (accuracy + head loss) or
    ``"lm"`` (next-token accuracy + token CE).
    """

    model: ModelAPI
    client_x: Any
    client_y: Any
    counts: Any
    test_x: Any
    test_y: Any = None
    kind: str = "classification"
    name: str = "task"

    @property
    def n_per_client(self) -> int:
        """Padded per-client pool size (caps the s_max probe)."""
        return int(self.client_y.shape[1])

    def source(self, device) -> StaticCohortSource:
        return StaticCohortSource(self.client_x, self.client_y, self.counts,
                                  device=device)

    def eval_fn(self, device) -> Callable[[PyTree], tuple]:
        """``params -> (metric, loss)`` for :meth:`RoundRuntime.run`, with
        the eval split copied to ``device`` once."""
        dev = resolve_device(device)
        tx = torch.as_tensor(self.test_x, device=dev)
        if self.kind == "lm":
            return lambda params: lm_eval_metrics(self.model, params, tx)
        ty = torch.as_tensor(self.test_y, device=dev)
        return lambda params: eval_metrics(self.model, params, tx, ty)


def classification_task(model: ModelAPI, client_x, client_y, counts,
                        test_x, test_y, *, name: str = "") -> Task:
    """Wrap pre-stacked classification arrays (the ``run_federated``
    layout) as a :class:`Task`."""
    return Task(model=model, client_x=client_x, client_y=client_y,
                counts=counts, test_x=test_x, test_y=test_y,
                kind="classification", name=name or model.name)


# ---------------------------------------------------------------------------
# LM model adapter over repro_torch.models.transformer
# ---------------------------------------------------------------------------

_FFN_PARENTS = ("mlp", "moe", "shared", "dense")


def _lm_width_masks(cfg: ArchConfig):
    """FFN-hidden-width HeteroFL masks for the stacked transformer params.

    Client u updates the first ``ceil(r_u * F)`` hidden units of every
    block's FFN (``wg``/``wu``/``wd`` under an FFN parent key: the dense
    SwiGLU, the MoE experts (L, E, D, F) / (L, E, F, D), the shared and
    dense-residual FFNs), matched by the leaf's dict path as in the
    reference. Attention, SSM, norm and
    embedding leaves stay full-width (a mask of ones), so every entry is
    covered by the full-width clients and the width-overlap mean
    (:func:`repro_torch.core.aggregation.hetero_overlap_mean`) is always
    defined. Masks are f32 broadcast views with a leading client axis, on
    the leaf's device.
    """

    def width_masks(params: PyTree, ratios: np.ndarray) -> PyTree:
        r = np.asarray(ratios, np.float32)
        U = int(r.shape[0])

        def leaf_mask(path: tuple, leaf: torch.Tensor) -> torch.Tensor:
            name = path[-1] if path else ""
            parent = path[-2] if len(path) >= 2 else ""
            full = (U,) + tuple(leaf.shape)
            if not (parent in _FFN_PARENTS and name in ("wg", "wu", "wd")
                    and leaf.dim() >= 2):
                return torch.ones((), dtype=torch.float32,
                                  device=leaf.device).expand(full)
            # hidden dim F: last axis for wg/wu, second-to-last for wd
            ax = leaf.dim() - 1 if name in ("wg", "wu") else leaf.dim() - 2
            F = leaf.shape[ax]
            keep = torch.ceil(torch.from_numpy(r) * F).to(torch.int32)
            m = (torch.arange(F)[None, :] < keep[:, None]).to(torch.float32)
            shape = [U] + [1] * leaf.dim()
            shape[ax + 1] = F
            return m.reshape(shape).to(leaf.device).expand(full)

        def walk(tree, path):
            if isinstance(tree, dict):
                return {k: walk(tree[k], path + (k,)) for k in sorted(tree)}
            return leaf_mask(path, tree)

        return walk(params, ())

    return width_masks


def make_lm_model(cfg: ArchConfig, *, moe_aux_coef: float = 0.01,
                  remat: bool = False) -> ModelAPI:
    """A :class:`ModelAPI` over the LM backbone.

    The data payload is a ``(b, seq+1)`` token ROW per sample; the
    shifted-label split happens inside ``loss``/``predict``, so the generic
    minibatch sampler and cohort padding treat LM data like feature
    vectors. ``loss`` is the sample-weighted next-token CE (the runtime
    weights rows by 1/S_u, so the weighted sum is the batch mean), plus
    ``moe_aux_coef * aux / L`` when the config routes.
    ``init(gen, device)`` seeds a generator on ``device`` from ``gen`` (a
    full-width init drawn on the CPU would take tens of seconds) and draws
    the f32 params there; ``"meta"`` gives shapes only. A vlm or audio
    config trains on the text alone, as the reference's: no frontend
    reaches the forward, so the encoder's and cross-attention's leaves get
    zero gradients and are folded like every other leaf.
    """

    def init(gen: torch.Generator, device) -> PyTree:
        dev = resolve_device(device)
        if dev.type != "meta":
            seed = int(torch.randint(0, 2 ** 62, (1,), generator=gen))
            gen = torch.Generator(device=dev).manual_seed(seed)
        return tr.init_params(gen, cfg, device=dev)

    def loss(params, x, y, w):
        tok, lab = x[:, :-1], x[:, 1:]
        logits, aux = tr.forward(params, cfg, tok, remat=remat,
                                 with_aux=True)
        return tr.with_moe_aux(torch.sum(w * tr.token_nll(logits, lab)
                                         .mean(-1)), aux, cfg, moe_aux_coef)

    def predict(params, x):
        # per-position next-token logits for (b, seq+1) rows
        return tr.forward(params, cfg, x[:, :-1])

    def layer_ids(params):
        return tr.layer_ids(params, cfg)

    return ModelAPI(init=init, loss=loss, predict=predict,
                    layer_ids=layer_ids, L=cfg.n_blocks_total,
                    name=f"lm-{cfg.name}", width_masks=_lm_width_masks(cfg))


@torch.no_grad()
def lm_eval_metrics(model: ModelAPI, params: PyTree, test_rows,
                    test_y=None, *, batch: int = 64
                    ) -> tuple[DeviceRatio, torch.Tensor]:
    """(next-token accuracy, mean token CE) over held-out token rows
    ``test_rows`` (n, seq+1); perplexity is ``exp`` of the loss.
    ``test_y`` is accepted and ignored, so the signature matches
    :func:`repro_torch.fl.runtime.eval_metrics`. Both stay on the device
    (the correct count and the summed CE accumulate there, batch by batch):
    ``float()`` each for a Python number."""
    del test_y
    n, seq = int(test_rows.shape[0]), int(test_rows.shape[1]) - 1
    dev = test_rows.device
    correct = torch.zeros((), dtype=torch.int64, device=dev)
    nll = torch.zeros((), dtype=torch.float32, device=dev)
    for i in range(0, n, batch):
        rows = test_rows[i:i + batch]
        logits = model.predict(params, rows)                 # (b, S, V)
        labels = rows[:, 1:]
        nll = nll + tr.token_nll(logits, labels).sum()
        correct = correct + (logits.argmax(-1) == labels).sum()
    tokens = n * seq
    return DeviceRatio(correct, tokens), nll / float(tokens)


# ---------------------------------------------------------------------------
# LM tasks: synthetic token streams, static population or fleet
# ---------------------------------------------------------------------------

def _lm_rows(cfg: ArchConfig, n_rows: int, seq: int, seed: int,
             vocab: Optional[int]) -> np.ndarray:
    v = int(vocab or min(cfg.vocab, 2048))
    toks = make_lm_dataset(vocab=v, n_tokens=n_rows * (seq + 1), seed=seed)
    return toks.reshape(n_rows, seq + 1)


def lm_task(cfg: ArchConfig, *, U: int, seq: int = 64, n_seq: int = 96,
            n_eval: int = 64, seed: int = 0, vocab: Optional[int] = None,
            holdout: bool = False, moe_aux_coef: float = 0.01,
            remat: bool = False) -> Task:
    """Synthetic-token-stream LM task: ``U`` clients with contiguous stream
    shards (non-IID by stream position).

    ``client_x``: (U, n_seq, seq+1) token rows; ``client_y`` all-zero (the
    labels live inside the rows); eval is next-token accuracy + token CE
    over a FIXED HEAD of each client's pool, as in the reference: the
    stream's n-gram state is a rolling hash of the whole history, which one
    window cannot recover, so held-out rows have near-constant CE and the
    in-pool head is what tracks optimization. ``holdout=True`` evaluates on
    disjoint stream rows instead.
    """
    rows = _lm_rows(cfg, U * n_seq + (n_eval if holdout else 0), seq, seed,
                    vocab)
    pool = rows[:U * n_seq].reshape(U, n_seq, seq + 1)
    if holdout:
        test = rows[U * n_seq:]
    else:
        head = max(n_eval // U, 1)
        test = pool[:, :head].reshape(-1, seq + 1)
    return Task(model=make_lm_model(cfg, moe_aux_coef=moe_aux_coef,
                                    remat=remat), client_x=pool,
                client_y=np.zeros((U, n_seq), np.int32),
                counts=np.full((U,), n_seq, np.int32),
                test_x=test, kind="lm", name=f"lm-{cfg.name}")


def lm_fleet_data(cfg: ArchConfig, n_devices: int, *, seq: int = 32,
                  rows_per_device: int = 24, n_eval: int = 64,
                  seed: int = 0, vocab: Optional[int] = None,
                  holdout: bool = False):
    """Synthetic token streams as fleet-engine data, so LM workloads run
    against simulated device fleets like image tasks.

    Returns a :class:`repro_torch.fleet.engine.FleetData` whose ``x`` rows
    are (seq+1)-token sequences and whose labels are all-zero; pair it with
    :func:`make_lm_model` and ``run_fleet(..., eval_metrics=
    lm_eval_metrics)``. Eval rows are a per-device head of the training
    shards (as in :func:`lm_task`); ``holdout=True`` uses disjoint rows.
    """
    from repro_torch.fleet.engine import FleetData

    n_rows = n_devices * rows_per_device
    rows = _lm_rows(cfg, n_rows + (n_eval if holdout else 0), seq, seed,
                    vocab)
    x = rows[:n_rows]
    if holdout:
        test = rows[n_rows:]
    else:
        head = max(n_eval // n_devices, 1)
        test = x.reshape(n_devices, rows_per_device,
                         seq + 1)[:, :head].reshape(-1, seq + 1)
    parts = [np.arange(u * rows_per_device, (u + 1) * rows_per_device)
             for u in range(n_devices)]
    return FleetData(x=x, y=np.zeros((n_rows,), np.int32), parts=parts,
                     x_test=test, y_test=np.zeros((len(test),), np.int32))
