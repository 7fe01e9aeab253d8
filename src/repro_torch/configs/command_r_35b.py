"""command-r-35b [dense] — GQA, no-bias [hf:CohereForAI/c4ai-command-r-v01]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="command-r-35b", family="dense",
    L=40, d_model=8192, n_heads=64, n_kv=8, d_head=128,
    d_ff=22528, vocab=256000,
    rope_mode="full", rope_theta=8_000_000.0, tie_embeddings=True,
    source="hf:CohereForAI/c4ai-command-r-v01",
)
