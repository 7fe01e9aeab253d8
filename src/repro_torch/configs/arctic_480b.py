"""arctic-480b [moe] — 128 experts top-2 + dense residual
[hf:Snowflake/snowflake-arctic-base].

Dense-MoE hybrid: every block has a dense SwiGLU FFN (d_ff=4864) in residual
parallel with a 128-expert top-2 MoE (per-expert hidden 4864).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="arctic-480b", family="moe",
    L=35, d_model=7168, n_heads=56, n_kv=8, d_head=128,
    d_ff=4864, vocab=32000,
    n_experts=128, top_k=2, moe_d_ff=4864, dense_residual=True,
    rope_mode="full", rope_theta=10_000.0,
    source="hf:Snowflake/snowflake-arctic-base",
)
