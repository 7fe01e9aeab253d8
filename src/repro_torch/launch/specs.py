"""Abstract inputs and their placements for every (architecture x input
shape x mesh) combination: the dry run's path (port of
``repro.launch.specs``).

Nothing is allocated here: params, caches and batches live on the
``meta`` device, wrapped as DTensors on a ``torch.distributed``
``DeviceMesh`` with the placements of :func:`repro_torch.models.
transformer.param_specs` and ``cache_specs`` (the reference's
``jax.ShapeDtypeStruct`` stand-ins with their ``NamedSharding`` s).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.launch.mesh import PartitionSpec as P
from repro_torch.launch.mesh import batch_axes, batch_shards, placements
from repro_torch.models import transformer as tr

PyTree = Any

__all__ = ["abstract_params", "default_clients", "build_dryrun",
           "build_client_probe", "text_len", "windowed_variant",
           "place_tree", "local_bytes"]


def abstract_params(cfg: ArchConfig, dtype) -> PyTree:
    """``init_params`` on the ``meta`` device: the params' shapes and
    dtypes, nothing drawn."""
    return tr.init_params(None, cfg, dtype=dtype, device="meta")


def default_clients(mesh) -> int:
    """Simulated FL clients U = data-parallel group count (the reference's
    DESIGN §5)."""
    names = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    return names.get("data", 1) * names.get("pod", 1)


def text_len(cfg: ArchConfig, shape: InputShape) -> int:
    """Text tokens through the decoder. VLM: shape.seq_len covers the image
    patches + text; audio: the decoder length is shape.seq_len (frames are a
    fixed encoder-side budget)."""
    if cfg.frontend == "vision":
        return max(shape.seq_len - cfg.n_frontend_tokens, 128)
    return shape.seq_len


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def place_tree(tree: PyTree, specs: PyTree, mesh) -> PyTree:
    """Each meta tensor of ``tree`` as a DTensor on ``mesh`` with its
    spec's placements (its local shard on ``meta``)."""
    from torch.distributed.tensor import distribute_tensor

    def one(t, s):
        return distribute_tensor(t, mesh, placements(s, mesh))

    if isinstance(tree, torch.Tensor):
        return one(tree, specs)
    if isinstance(tree, dict):
        return {k: place_tree(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, tr.Cache):
        return tr.Cache(*(None if v is None else place_tree(v, s, mesh)
                          for v, s in zip(tree, specs)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(place_tree(v, s, mesh) for v, s in zip(tree, specs))
    raise TypeError(f"cannot place {type(tree).__name__}")


def _placed(mesh, args, specs) -> tuple:
    return tuple(a if not isinstance(a, (torch.Tensor, dict, tuple))
                 else place_tree(a, s, mesh) for a, s in zip(args, specs))


def _place_specs(mesh, specs) -> tuple:
    """The placements tree of each spec tree (the reference's
    ``NamedSharding`` s)."""
    def one(s):
        if isinstance(s, P):
            return placements(s, mesh)
        if isinstance(s, dict):
            return {k: one(v) for k, v in s.items()}
        if isinstance(s, tuple):
            return type(s)(*(one(v) for v in s)) if isinstance(s, tr.Cache) \
                else tuple(one(v) for v in s)
        return s
    return one(specs)


def _bspec(mesh):
    batch = batch_axes(mesh)
    return batch if len(batch) > 1 else batch[0]


def build_dryrun(cfg: ArchConfig, shape: InputShape, mesh, *,
                 mode: str = "temporal", U: int | None = None,
                 remat: bool = True, fsdp: str | None = "data",
                 unroll: bool = False, spatial_batch_axes=None,
                 frontend_dtype=torch.bfloat16):
    """Returns (step_fn, args, in_placements, out_placements, meta).

    The args are meta DTensors on ``mesh``, placed by ``param_specs`` and
    ``cache_specs``; ``in_placements``/``out_placements`` are their
    placement trees (the reference's in/out shardings). ``unroll`` is
    recorded only: the port's blocks always run as a Python loop, so a
    count over the step already covers every block. A serve step's ``pos``
    is the cache's last slot (every position attended). Patch or frame
    embeddings are ``frontend_dtype`` (bf16, as the reference's; a caller
    matching a run that draws them in f32 passes that).

    Raises ValueError for (arch, shape) combinations that are skipped by
    design (long_500k on full-attention archs) and for a temporal client
    batch the batch shards do not divide.
    """
    from repro_torch.launch import steps as st

    if unroll:
        cfg = dataclasses.replace(cfg, unroll_layers=True)
    bspec = _bspec(mesh)
    n_batch_shards = batch_shards(mesh)
    if shape.global_batch % n_batch_shards != 0:
        bspec = None               # e.g. long_500k B=1: replicate the batch dim
    L_tot = cfg.n_blocks_total
    f32, bf16, i64 = torch.float32, torch.bfloat16, torch.long

    if shape.kind == "train":
        if U is None:
            if mode == "spatial":
                U = n_batch_shards          # clients live on the batch axes
            else:
                # temporal: per-client batch exactly fills the batch shards
                U = max(shape.global_batch // n_batch_shards, 1)
        b = st.client_batch(cfg, shape, U)
        if mode != "spatial" and b % n_batch_shards != 0:
            raise ValueError(f"client batch {b} not divisible by "
                             f"{n_batch_shards} batch shards")
        S = text_len(cfg, shape)
        params = abstract_params(cfg, f32)
        pspec = tr.param_specs(params, cfg, fsdp=fsdp, tp="model")
        dspec = P(bspec, None, None) if mode == "spatial" else \
            P(None, bspec, None)
        args = [params, _meta((U, b, S), i64), _meta((U, b, S), i64),
                _meta((U, L_tot), f32), _meta((L_tot,), f32), _meta((), f32)]
        spec = [pspec, dspec, dspec, P(None, None), P(None), P()]
        step = st.make_train_step(cfg, U=U, mode=mode, remat=remat)
        if cfg.frontend != "none":
            args.append(_meta((U, b, cfg.n_frontend_tokens, cfg.d_model),
                              frontend_dtype))
            spec.append(P(None, bspec, None, None) if mode != "spatial"
                        else P(bspec, None, None, None))
        out_spec = pspec
        meta = {"step": "train_step", "U": U, "client_batch": b, "seq": S}

    elif shape.kind == "prefill":
        B = shape.global_batch
        S = text_len(cfg, shape)
        params = abstract_params(cfg, bf16)
        pspec = tr.param_specs(params, cfg, fsdp=fsdp, tp="model")
        step = st.make_prefill_step(cfg)
        args = [params, _meta((B, S), i64)]
        spec = [pspec, P(bspec, None)]
        if cfg.frontend != "none":
            args.append(_meta((B, cfg.n_frontend_tokens, cfg.d_model),
                              frontend_dtype))
            spec.append(P(bspec, None, None))
        out_spec = P(bspec, "model")
        meta = {"step": "prefill_step", "B": B, "seq": S}

    else:  # decode
        if not cfg.sub_quadratic and shape.seq_len > 262_144:
            raise ValueError(
                f"{cfg.name} is full-attention; long_500k is skipped per "
                "DESIGN.md §4 (use --attn-window for the SWA variant)")
        B = shape.global_batch
        S = shape.seq_len
        params = abstract_params(cfg, bf16)
        pspec = tr.param_specs(params, cfg, fsdp=fsdp, tp="model")
        cache = tr.init_cache(cfg, B, S, dtype=bf16, device="meta")
        if cfg.enc_layers:
            cache = cache._replace(cross=tuple(
                _meta((cfg.L, B, cfg.n_frontend_tokens, cfg.n_kv,
                       cfg.head_dim), bf16) for _ in range(2)))
        cspec = tr.cache_specs(cache, cfg, batch=bspec, tp="model")
        step = st.make_serve_step(cfg)
        args = [params, cache, _meta((B,), i64), S - 1]
        spec = [pspec, cspec, P(bspec), None]
        out_spec = (P(bspec), cspec)
        meta = {"step": "serve_step", "B": B, "cache_seq": S}

    placed = _placed(mesh, args, spec)
    return (step, placed, tuple(_place_specs(mesh, s) for s in spec),
            _place_specs(mesh, out_spec), meta)


def build_client_probe(cfg: ArchConfig, shape: InputShape, mesh, *,
                       U: int, b: int, remat: bool = True,
                       fsdp: str | None = "data", unroll: bool = True):
    """The temporal step's per-client body on its own (one client's
    weighted gradient, ``launch/steps.py:make_client_grad``), with the
    train step's placements. Returns (step_fn, args, in_placements,
    out_placements)."""
    from repro_torch.launch import steps as st

    if unroll:
        cfg = dataclasses.replace(cfg, unroll_layers=True)
    bspec = _bspec(mesh)
    S = text_len(cfg, shape)
    params = abstract_params(cfg, torch.float32)
    pspec = tr.param_specs(params, cfg, fsdp=fsdp, tp="model")
    args = [params, _meta((b, S), torch.long), _meta((b, S), torch.long),
            _meta((cfg.n_blocks_total,), torch.float32)]
    spec = [pspec, P(bspec, None), P(bspec, None), P(None)]
    if cfg.frontend != "none":
        args.append(_meta((b, cfg.n_frontend_tokens, cfg.d_model),
                          torch.bfloat16))
        spec.append(P(bspec, None, None))
    step = st.make_client_grad(cfg, remat=remat)
    return (step, _placed(mesh, args, spec),
            tuple(_place_specs(mesh, s) for s in spec),
            _place_specs(mesh, pspec))


def windowed_variant(cfg: ArchConfig, window: int = 4096) -> ArchConfig:
    """Beyond-paper sliding-window serve variant for dense archs (enables
    long_500k dry-runs)."""
    return dataclasses.replace(cfg, window=window,
                               name=f"{cfg.name}-swa{window}")


def local_bytes(tree: PyTree) -> int:
    """Bytes of the local shards of a tree's DTensors (and of its plain
    tensors whole): what one rank holds."""
    from torch.distributed.tensor import DTensor
    return sum((t.to_local() if isinstance(t, DTensor) else t).nbytes
               for t in _tensors(tree))


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)
