"""ArchConfig: one dataclass describing every supported architecture family,
plus the four assigned input shapes, and ``FleetConfig``, the fleet
simulation block (port of ``repro.configs.base``).

The port keeps its own copy: the reference module imports the compression,
re-planning and execution-spec modules of the JAX package; this one
imports the port's.

Families: dense (GQA transformer), ssm (Mamba2 SSD), moe (GQA/MLA + MoE FFN),
vlm / audio (transformer backbone with a stubbed modality frontend), hybrid
(parallel attention + SSM heads, Hymba-style), and enc-dec (audio). The
port's model covers every family (``models/transformer.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.compression import CompressionConfig
from repro_torch.core.replan import ReplanConfig
from repro_torch.fl.spec import ExecSpec

__all__ = ["ArchConfig", "CompressionConfig", "ExecSpec", "FleetConfig",
           "InputShape", "INPUT_SHAPES", "ReplanConfig", "pad_vocab"]


def pad_vocab(v: int, multiple: int = 512) -> int:
    """Pad vocab so the embedding/lm-head shard evenly on the model axis."""
    return ((v + multiple - 1) // multiple) * multiple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | ssm | moe | vlm | audio | hybrid
    L: int                         # decoder blocks
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    source: str = ""               # citation bracket from the assignment
    # attention
    attention: str = "gqa"         # gqa | mla | none
    d_head: int = 0                # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_mode: str = "full"        # full | half (ChatGLM 2d) | none
    rope_theta: float = 10000.0
    window: int = 0                # sliding-window size (0 = full attention)
    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared: int = 0
    moe_d_ff: int = 0              # per-expert hidden dim (0 -> d_ff)
    dense_residual: bool = False   # Arctic: dense FFN parallel to MoE
    capacity_factor: float = 1.25  # GShard capacity (decode is dropless)
    # MLA (DeepSeek-V2)
    kv_lora: int = 0
    mla_nope_dim: int = 128
    mla_rope_dim: int = 64
    mla_v_dim: int = 128
    # SSM (Mamba2 SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 64            # SSD chunk length Q
    # enc-dec (audio)
    enc_layers: int = 0
    # modality frontend stub
    frontend: str = "none"         # none | vision | audio
    n_frontend_tokens: int = 0     # patch/frame embeddings per sample
    # misc
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    # the reference's lowering switch (scan vs unrolled layers); the port's
    # blocks are always a Python loop, so it is carried but not read
    unroll_layers: bool = False

    # ------------------------------------------------------------------
    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        return pad_vocab(self.vocab)

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def n_blocks_total(self) -> int:
        """Total mask layers L for ADEL (encoder blocks count as deeper layers)."""
        return self.L + self.enc_layers

    @property
    def has_attention(self) -> bool:
        return self.attention != "none"

    @property
    def has_ssm(self) -> bool:
        return self.ssm_state > 0

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def expert_d_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    @property
    def sub_quadratic(self) -> bool:
        """True iff the arch can serve long_500k (no dense full-attn KV cache)."""
        return (not self.has_attention) or self.window > 0

    def param_count(self) -> int:
        """Approximate parameter count (embeddings included once if tied)."""
        D, V = self.d_model, self.padded_vocab
        n = V * D * (1 if self.tie_embeddings else 2)
        per = 2 * D  # norms
        if self.has_attention:
            if self.attention == "mla":
                dn, dr, dv, c = (self.mla_nope_dim, self.mla_rope_dim,
                                 self.mla_v_dim, self.kv_lora)
                per += D * self.n_heads * (dn + dr) + D * c + D * dr
                per += c * self.n_heads * (dn + dv) + self.n_heads * dv * D
            else:
                hd = self.head_dim
                per += D * self.n_heads * hd + 2 * D * self.n_kv * hd
                per += self.n_heads * hd * D
        if self.has_ssm:
            di, N = self.d_inner, self.ssm_state
            per += D * (2 * di + 2 * N + self.ssm_heads)  # in_proj (z,x,b,c,dt)
            per += self.ssm_conv * (di + 2 * N)           # conv1d
            per += di * D + 2 * self.ssm_heads            # out_proj, A_log, D skip
        if self.is_moe:
            F = self.expert_d_ff
            per += D * self.n_experts                      # router
            per += self.n_experts * 3 * D * F              # routed experts
            if self.n_shared:
                per += 3 * D * (self.n_shared * F)
            if self.dense_residual:
                per += 3 * D * self.d_ff
        elif not self.has_ssm or self.family == "hybrid":
            per += 3 * D * self.d_ff                       # SwiGLU
        n += self.L * per
        if self.enc_layers:
            hd = self.head_dim
            enc_per = (D * self.n_heads * hd + 2 * D * self.n_kv * hd
                       + self.n_heads * hd * D + 3 * D * self.d_ff + 2 * D)
            # decoder cross-attention
            n += self.L * (D * self.n_heads * hd + 2 * D * self.n_kv * hd
                           + self.n_heads * hd * D + D)
            n += self.enc_layers * enc_per
        return n

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k routed + shared experts
        + dense residual only)."""
        if not self.is_moe:
            return self.param_count()
        full = self.param_count()
        F = self.expert_d_ff
        routed_all = self.L * self.n_experts * 3 * self.d_model * F
        routed_active = self.L * self.top_k * 3 * self.d_model * F
        return full - routed_all + routed_active

    def nonembedding_param_count(self) -> int:
        V, D = self.padded_vocab, self.d_model
        emb = V * D * (1 if self.tie_embeddings else 2)
        return self.param_count() - emb

    def reduced(self, **overrides) -> "ArchConfig":
        """Smoke-test variant: 2 layers, d_model <= 512, <= 4 experts."""
        kw = dataclasses.asdict(self)
        shrink = max(1, self.d_model // 256)
        d_red = max(128, (self.d_model // shrink) // 64 * 64)
        kw.update(
            L=2,
            enc_layers=min(self.enc_layers, 2),
            d_model=d_red,
            n_heads=max(self.n_heads // shrink, 1),
            n_kv=max(self.n_kv // shrink, 1),
            d_head=min(self.head_dim, 64),
            d_ff=max(self.d_ff // shrink, 8),
            vocab=min(self.vocab, 512),
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            moe_d_ff=max(self.expert_d_ff // shrink, 8) if self.is_moe else 0,
            kv_lora=min(self.kv_lora, 64),
            mla_nope_dim=min(self.mla_nope_dim, 32),
            mla_rope_dim=min(self.mla_rope_dim, 16),
            mla_v_dim=min(self.mla_v_dim, 32),
            ssm_state=min(self.ssm_state, 16),
            ssm_head_dim=min(self.ssm_head_dim, 16),
            n_frontend_tokens=min(self.n_frontend_tokens, 16),
            window=min(self.window, 64) if self.window else 0,
            dtype="float32",
        )
        kw.update(overrides)
        # keep n_heads a multiple of n_kv
        kw["n_heads"] = max(kw["n_heads"] - kw["n_heads"] % kw["n_kv"], kw["n_kv"])
        return ArchConfig(**kw)


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Fleet-simulation block consumed by ``repro_torch.fleet``.

    Describes a heterogeneous device population and the per-round cohort
    drawn from it (see ``repro_torch/fleet/__init__.py``).
    ``availability_kwargs`` is a tuple of (key, value) pairs so the config
    stays hashable and frozen; :meth:`availability_dict` consumes it.
    """

    preset: str = "uniform"        # profiles.PRESETS key (ignored w/ trace)
    size: int = 500                # number of simulated devices
    trace_path: Optional[str] = None   # JSON device trace overrides preset
    # population source (repro_torch.fleet.population.PopulationSpec
    # forms: "PRESET" | "trace:PATH" | "mobiperf:PATH" |
    # "parametric:PRESET"); when set it wins over preset/trace_path
    population: Optional[str] = None
    availability: str = "always-on"    # availability.AVAILABILITY key
    availability_kwargs: tuple = ()
    # edge-region count for hierarchical two-tier aggregation (device id %
    # regions); 1 = flat single-server topology
    regions: int = 1
    cohort_size: int = 32          # U clients planned per round
    cohort_strategy: str = "uniform"   # uniform | power-of-choice | stratified
    # the full execution spec (repro_torch.fl.spec.ExecSpec); when set it
    # wins over the backend/chunk_size/compression fields below
    exec: Optional[ExecSpec] = None
    # execution backend (repro_torch.fl.backends): dense | chunked |
    # shard_map | temporal | buffered | hierarchical
    backend: str = "chunked"
    chunk_size: int = 16           # client-shard axis chunk (chunked backend)
    # online re-planning (repro_torch.core.replan): trigger "never" keeps
    # the static schedule; "every-k" / "drift" re-solve the remaining
    # horizon against the reachable population
    replan: ReplanConfig = ReplanConfig()
    # client->server wire compression (repro_torch.core.compression); also
    # scales the solver's per-user communication time B_u by the wire ratio
    compression: CompressionConfig = CompressionConfig()
    seed: int = 0

    def availability_dict(self) -> dict:
        return dict(self.availability_kwargs)

    def population_spec(self):
        """The config's :class:`repro_torch.fleet.population.
        PopulationSpec`: ``population`` when set, else the preset/trace
        fields mapped onto the spec's source forms (imported lazily, so
        configs import without the fleet subsystem)."""
        from repro_torch.fleet.population import PopulationSpec
        source = self.population or (f"trace:{self.trace_path}"
                                     if self.trace_path else self.preset)
        return PopulationSpec(source=source, size=self.size,
                              availability=self.availability,
                              availability_kwargs=self.availability_kwargs,
                              regions=self.regions, seed=self.seed)

    def exec_spec(self) -> ExecSpec:
        """The effective execution spec: ``exec`` when set, else one built
        from the backend / chunk_size / compression fields."""
        if self.exec is not None:
            return self.exec
        return ExecSpec(backend=self.backend, chunk_size=self.chunk_size,
                        compression=self.compression)


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
