"""seamless-m4t-medium [audio] — enc-dec, multimodal [arXiv:2308.11596].

Transformer backbone only: 12 encoder + 12 decoder blocks (L=12 per stack),
d_model=1024, 16 heads, d_ff=4096. The conformer speech frontend
(mel-spectrogram + conv feature extractor) is a stub — ``input_specs``
supplies precomputed frame embeddings (B, n_frames, d_model) to the encoder.
ADEL mask layers: encoder blocks are the deepest (ids 0..11), decoder blocks
ids 12..23 (backprop reaches the decoder first).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium", family="audio",
    L=12, enc_layers=12, d_model=1024, n_heads=16, n_kv=16, d_head=64,
    d_ff=4096, vocab=256206,
    rope_mode="none",                      # sinusoidal/learned in the original
    frontend="audio", n_frontend_tokens=1024,
    source="arXiv:2308.11596",
)
