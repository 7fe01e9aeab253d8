"""Step functions of the LM path (port of ``repro.launch.steps``):
:func:`make_prefill_step` and :func:`make_serve_step`. The FL training step
waits for ROADMAP 1.13.1.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as tr

__all__ = ["make_prefill_step", "make_serve_step"]


def make_prefill_step(cfg: ArchConfig):
    """prefill_step(params, tokens) -> last-position logits (B, V)."""
    tr.check_supported(cfg)

    @torch.inference_mode()
    def prefill_step(params, tokens):
        return tr.prefill(params, cfg, tokens)

    return prefill_step


def make_serve_step(cfg: ArchConfig):
    """serve_step(params, cache, token, pos) -> (next_token, cache).

    ONE new token against a KV/SSM cache, greedy (argmax), as in the
    reference.
    """
    tr.check_supported(cfg)

    @torch.inference_mode()
    def serve_step(params, cache, token, pos):
        logits, cache = tr.decode_step(params, cfg, cache, token, pos)
        return logits.argmax(-1).to(torch.int32), cache

    return serve_step
