"""qwen1.5-4b [dense] — QKV bias [hf:Qwen/Qwen1.5-0.5B]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-4b", family="dense",
    L=40, d_model=2560, n_heads=20, n_kv=20, d_head=128,
    d_ff=6912, vocab=151936, qkv_bias=True,
    rope_mode="full", rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen1.5-0.5B",
)
