"""yi-6b [dense] — llama-arch GQA [arXiv:2403.04652]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="yi-6b", family="dense",
    L=32, d_model=4096, n_heads=32, n_kv=4, d_head=128,
    d_ff=11008, vocab=64000,
    rope_mode="full", rope_theta=5_000_000.0,
    source="arXiv:2403.04652",
)
