"""llava-next-34b [vlm] — anyres tiling [hf:llava-hf/llava-v1.6-mistral-7b-hf].

Language backbone only; the SigLIP/ViT tower + projector is a stub —
``input_specs`` supplies precomputed patch embeddings (anyres: base tile +
4 sub-tiles of 576 patches = 2880 image tokens) of shape (B, 2880, d_model).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-34b", family="vlm",
    L=60, d_model=7168, n_heads=56, n_kv=8, d_head=128,
    d_ff=20480, vocab=64000,
    rope_mode="full", rope_theta=5_000_000.0,
    frontend="vision", n_frontend_tokens=2880,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
)
