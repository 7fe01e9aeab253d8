"""``ExecSpec`` — one execution spec for every federated entry point, in
PyTorch (port of ``repro.fl.spec``).

:class:`ExecSpec` bundles how rounds execute — ``backend`` and its knobs,
the local update's ``local_iters`` / ``l2``, ``donate``, the wire
``compression`` and ``agg_impl`` — plus the buffered backend's staleness
knobs ``lam`` / ``max_age`` / ``buffer_cap``, into one frozen dataclass
that is:

* accepted as ``exec=`` by every entry point, with the old kwargs kept as
  aliases resolved through the single parsing path :meth:`ExecSpec.resolve`
  (bit-identical trajectories either way);
* the single source of the CLI surface (:meth:`ExecSpec.add_cli_args` /
  :meth:`ExecSpec.from_cli`);
* where knob validation lives: :meth:`ExecSpec.resolve` warns on knob
  combinations the selected backend ignores — or raises, under
  ``strict=True`` / ``REPRO_EXEC_STRICT=1``.

The backends are ``dense``, ``chunked``, ``shard_map`` (over a
``torch.distributed`` process group), ``temporal``, ``buffered`` and
``hierarchical``, and ``pipeline`` is ``serial`` or ``prefetch``. Both
``agg_impl`` values are kept so
a spec round-trips through :meth:`as_dict` and the CLI; in the port both
route every fold through the hand-written grouped kernels on the card (and
their plain versions on the CPU).
"""
from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Any, Optional

from repro_torch.core.compression import (MODES as COMPRESSION_MODES,
                                          CompressionConfig, make_compression)
from repro_torch.launch.mesh import MESH_AXES

__all__ = ["BACKENDS", "AGG_IMPLS", "PIPELINES", "ExecSpec"]

# dense: one vmap over the cohort; chunked: sequential chunk sums;
# shard_map: each rank of a process group folds its slice, all_reduce sums
# the partials; temporal: one client at a time into an f32 accumulator;
# buffered: dense + a staleness-weighted delayed-gradient carry buffer;
# hierarchical: per-edge-region partial aggregates + one global fold
BACKENDS = ("dense", "chunked", "shard_map", "temporal", "buffered",
            "hierarchical")

AGG_IMPLS = ("jnp", "pallas")

PIPELINES = ("serial", "prefetch")

# legacy-kwarg aliases `resolve` understands, in ExecSpec field order
_FIELDS = ("backend", "chunk_size", "mesh", "local_iters", "l2", "donate",
           "compression", "agg_impl", "lam", "max_age", "buffer_cap",
           "regions", "pipeline")


@dataclasses.dataclass(frozen=True)
class ExecSpec:
    """How federated rounds execute: backend + its knobs, in one value.

    ``backend`` selects the :mod:`repro_torch.fl.backends` execution
    backend; ``chunk_size`` configures the chunked backend, ``regions`` the
    hierarchical backend's fallback edge-region count (the cohort splits
    into this many contiguous regions; ``regions=1`` is the dense fold, bit
    for bit); ``local_iters`` / ``l2`` shape the client-side local update;
    ``donate`` is kept for the reference's surface (the port's round steps
    never update params in place); ``compression`` is the client->server
    wire format (normalized to a :class:`CompressionConfig`); ``agg_impl``
    names the reference's fold implementation, reported by ``describe()``.
    ``mesh`` is the shard_map backend's ``torch.distributed`` process group
    (None: the default group if one is initialized, else one shard).
    ``pipeline`` is the round loop: ``serial``, or ``prefetch``, which plans
    round t+1 on a worker thread while round t runs. The staleness knobs
    drive the ``buffered`` backend: a straggler's unfinished layers are
    banked and folded into a later round with weight ``lam ** tau``
    (``tau`` = rounds of staleness); ``lam=0`` (default) is the dense
    round, bit for bit. ``max_age`` drops banked work older than that many
    rounds; ``buffer_cap`` bounds the carry ring (one slot a round).
    """

    backend: str = "dense"
    chunk_size: int = 16
    mesh: Any = None
    local_iters: int = 1
    l2: float = 0.0
    donate: bool = True
    compression: CompressionConfig = CompressionConfig()
    agg_impl: str = "jnp"
    # buffered (semi-async) staleness knobs
    lam: float = 0.0
    max_age: int = 4
    buffer_cap: int = 4
    # hierarchical backend: fallback edge-region count
    regions: int = 4
    pipeline: str = "serial"

    def __post_init__(self):
        object.__setattr__(self, "compression",
                           make_compression(self.compression))
        if self.backend not in BACKENDS and not hasattr(self.backend,
                                                        "run_round"):
            raise ValueError(f"unknown backend {self.backend!r}; "
                             f"known: {BACKENDS}")
        if self.agg_impl not in AGG_IMPLS:
            raise ValueError(f"unknown agg_impl {self.agg_impl!r}; "
                             f"known: {AGG_IMPLS}")
        if not 0.0 <= float(self.lam) <= 1.0:
            raise ValueError(f"staleness decay lam={self.lam} must be in "
                             f"[0, 1] (w(tau) = lam ** tau)")
        if int(self.max_age) < 1 or int(self.buffer_cap) < 1:
            raise ValueError("max_age and buffer_cap must be >= 1")
        if int(self.regions) < 1:
            raise ValueError(f"regions must be >= 1, got {self.regions}")
        if self.pipeline not in PIPELINES:
            raise ValueError(f"unknown pipeline {self.pipeline!r}; "
                             f"known: {PIPELINES}")

    # ------------------------------------------------------------------
    @classmethod
    def resolve(cls, exec: Optional["ExecSpec"] = None, *,
                base: Optional["ExecSpec"] = None,
                strict: Optional[bool] = None,
                validate: bool = True, **legacy) -> "ExecSpec":
        """THE parsing path every entry point funnels through.

        Starts from ``exec`` (or ``base``, or the defaults), overlays any
        legacy kwarg that was explicitly passed (non-None), and validates
        the result, so ``run_federated(backend="chunked")`` and
        ``run_federated(exec=ExecSpec(backend="chunked"))`` resolve to the
        same spec — and the same trajectory.
        """
        unknown = set(legacy) - set(_FIELDS)
        if unknown:
            raise TypeError(f"unknown execution kwargs {sorted(unknown)}; "
                            f"known: {_FIELDS}")
        spec = exec if exec is not None else (base if base is not None
                                              else cls())
        if not isinstance(spec, cls):
            raise TypeError(f"exec= expects an ExecSpec, got {type(spec)}")
        overrides = {k: v for k, v in legacy.items() if v is not None}
        if overrides:
            spec = dataclasses.replace(spec, **overrides)
        if validate:
            spec.validate(strict=strict)
        return spec

    def validate(self, *, strict: Optional[bool] = None) -> "ExecSpec":
        """Warn (or raise, under strict) on knobs the backend ignores."""
        if strict is None:
            strict = bool(os.environ.get("REPRO_EXEC_STRICT"))
        defaults = ExecSpec()
        issues = []
        if self.chunk_size != defaults.chunk_size and \
                self.backend != "chunked":
            issues.append(f"chunk_size={self.chunk_size} is ignored by "
                          f"backend={self.backend!r} (chunked only)")
        if self.mesh is not None and self.backend != "shard_map":
            issues.append(f"mesh= is ignored by backend={self.backend!r} "
                          f"(shard_map only)")
        if self.backend != "buffered" and (
                self.lam != defaults.lam or
                self.max_age != defaults.max_age or
                self.buffer_cap != defaults.buffer_cap):
            issues.append(f"staleness knobs (lam={self.lam}, "
                          f"max_age={self.max_age}, "
                          f"buffer_cap={self.buffer_cap}) are ignored by "
                          f"backend={self.backend!r} (buffered only)")
        if self.regions != defaults.regions and \
                self.backend != "hierarchical":
            issues.append(f"regions={self.regions} is ignored by "
                          f"backend={self.backend!r} (hierarchical only)")
        for msg in issues:
            if strict:
                raise ValueError(f"ExecSpec: {msg}")
            warnings.warn(f"ExecSpec: {msg}", UserWarning, stacklevel=3)
        return self

    # ------------------------------------------------------------------
    def backend_kwargs(self) -> dict:
        """Constructor kwargs shared by every execution backend."""
        return dict(local_iters=self.local_iters, l2=self.l2,
                    donate=self.donate, compression=self.compression,
                    agg_impl=self.agg_impl)

    def as_dict(self) -> dict:
        """JSON-friendly description (a process group elided to the mesh
        axis names it stands for)."""
        d = {f: getattr(self, f) for f in _FIELDS}
        d["compression"] = dataclasses.asdict(self.compression)
        if self.mesh is not None:
            d["mesh"] = list(MESH_AXES)
        return d

    # ------------------------------------------------------------------
    @staticmethod
    def add_cli_args(parser) -> None:
        """Install the shared execution-spec argparse group. Every flag
        defaults to None (= keep the resolved spec's value), so front-ends
        layer CLI overrides on top of their own defaults."""
        g = parser.add_argument_group(
            "execution", "execution backend spec (repro_torch.fl.spec."
            "ExecSpec); unset flags keep the front-end's resolved defaults")
        g.add_argument("--backend", default=None, choices=list(BACKENDS),
                       help="execution backend (repro_torch.fl.backends)")
        g.add_argument("--chunk-size", type=int, default=None,
                       help="client-shard axis chunk (chunked backend)")
        g.add_argument("--no-donate", dest="donate", action="store_false",
                       default=None,
                       help="the reference's params-donation switch (no "
                            "effect on the port's round steps)")
        g.add_argument("--compression", default=None,
                       choices=list(COMPRESSION_MODES),
                       help="client->server wire compression: int8 "
                            "symmetric quantization or topk8 "
                            "sparsification")
        g.add_argument("--topk-frac", type=float, default=None,
                       help="kept fraction per (client, layer) in topk8 "
                            "mode")
        g.add_argument("--agg-impl", default=None, choices=list(AGG_IMPLS),
                       help="the reference's fold implementation name; the "
                            "port folds through its grouped kernels under "
                            "either")
        g.add_argument("--lam", type=float, default=None,
                       help="buffered backend: staleness decay of delayed "
                            "gradients, w(tau) = lam**tau (0 = exact "
                            "round-synchronous semantics)")
        g.add_argument("--max-age", type=int, default=None,
                       help="buffered backend: drop carried work older "
                            "than this many rounds")
        g.add_argument("--buffer-cap", type=int, default=None,
                       help="buffered backend: carry ring-buffer slots "
                            "(one per recent round)")
        g.add_argument("--pipeline", default=None, choices=list(PIPELINES),
                       help="round-loop pipelining: prefetch plans round "
                            "t+1 on a worker thread while round t runs")

    @classmethod
    def from_cli(cls, args, *, base: Optional["ExecSpec"] = None,
                 strict: Optional[bool] = None) -> "ExecSpec":
        """Resolve the spec from parsed :meth:`add_cli_args` flags."""
        compression = None
        if args.compression is not None:
            compression = (args.compression if args.topk_frac is None
                           else (args.compression, args.topk_frac))
        elif args.topk_frac is not None and base is not None:
            compression = dataclasses.replace(base.compression,
                                              top_k=float(args.topk_frac))
        return cls.resolve(base=base, strict=strict,
                           backend=args.backend,
                           chunk_size=args.chunk_size,
                           donate=args.donate,
                           compression=compression,
                           agg_impl=args.agg_impl,
                           lam=args.lam, max_age=args.max_age,
                           buffer_cap=args.buffer_cap,
                           pipeline=getattr(args, "pipeline", None))
