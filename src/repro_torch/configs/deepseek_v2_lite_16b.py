"""deepseek-v2-lite-16b [moe] — MLA kv_lora=512 [arXiv:2405.04434].

MLA latent attention (compressed KV cache), MoE FFN with 2 shared + 64
routed experts, top-6 routing, per-expert hidden 1408. The assignment
bracket mentions "160 routed" which matches full V2; we follow the explicit
``MoE 64e top-6`` field of the config line (V2-Lite).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b", family="moe",
    L=27, d_model=2048, n_heads=16, n_kv=16,
    d_ff=1408, vocab=102400,
    attention="mla", kv_lora=512,
    mla_nope_dim=128, mla_rope_dim=64, mla_v_dim=128,
    n_experts=64, top_k=6, n_shared=2, moe_d_ff=1408,
    rope_mode="full", rope_theta=10_000.0,
    source="arXiv:2405.04434",
)
