"""chatglm3-6b [dense] — RoPE 2d (half-rotary), GQA kv=2 [arXiv:2406.12793]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="chatglm3-6b", family="dense",
    L=28, d_model=4096, n_heads=32, n_kv=2, d_head=128,
    d_ff=13696, vocab=65024, qkv_bias=True,
    rope_mode="half", rope_theta=10_000.0,
    source="arXiv:2406.12793",
)
