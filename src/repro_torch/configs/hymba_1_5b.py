"""hymba-1.5b [hybrid] — parallel attn+mamba heads [arXiv:2411.13676].

Every block runs GQA attention (sliding-window 1024, hd=64) and a Mamba2 SSD
path in parallel on the same input; the two normalized outputs are averaged
(the paper's learned per-head fusion is simplified to a mean, as in the
reference package). Sub-quadratic (SWA + SSM state): long_500k runs.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b", family="hybrid",
    L=32, d_model=1600, n_heads=25, n_kv=5, d_head=64,
    d_ff=5504, vocab=32001,
    window=1024,
    ssm_state=16, ssm_head_dim=50, ssm_expand=2, ssm_conv=4,
    rope_mode="full", rope_theta=10_000.0,
    source="arXiv:2411.13676",
)
