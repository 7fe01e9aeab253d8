"""mamba2-370m [ssm] — SSD (state-space duality) [arXiv:2405.21060].

Attention-free: 48 SSD blocks, d_model=1024, d_inner=2048, state N=128,
head dim P=64 (32 value heads). Sub-quadratic: long_500k runs.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-370m", family="ssm",
    L=48, d_model=1024, n_heads=16, n_kv=16, d_ff=0, vocab=50280,
    attention="none", rope_mode="none",
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_conv=4,
    tie_embeddings=True,
    source="arXiv:2405.21060",
)
