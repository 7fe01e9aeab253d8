"""Batched serving loop: step a batch of prompts through the decode path
to fill the cache, then greedy-decode (port of ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \
        --batch 4 --prompt-len 64 --new-tokens 32 --full

Runs on the card unless ``--device cpu`` (or ``device="cpu"``) asks for the
CPU. ``--full`` uses the published widths and depth; without it the
arch's ``reduced()`` variant. An encoder-decoder arch (seamless-m4t-medium)
first encodes ``n_frontend_tokens`` random frames and fills the decoder's
cross-attention cache from them.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_serve_step
from repro_torch.models import transformer as tr

__all__ = ["serve", "main"]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(arch: str, *, batch: int = 4, prompt_len: int = 32,
          new_tokens: int = 32, seed: int = 0, reduced: bool = True,
          device=None, verbose: bool = True) -> dict:
    """Random params and prompts from ``seed``; returns the arch, decode
    tokens per second and the generated tokens (batch, new_tokens)."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = tr.init_params(gen, cfg, device=dev)
    prompts = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=gen,
                            device=dev)
    cache = tr.init_cache(cfg, batch, prompt_len + new_tokens,
                          dtype=torch.float32, device=dev)
    if cfg.enc_layers:
        frames = 0.02 * torch.randn((batch, cfg.n_frontend_tokens,
                                     cfg.d_model), generator=gen, device=dev)
        with torch.inference_mode():
            enc_out = tr._run_encoder(params, cfg, frames,
                                      getattr(torch, cfg.dtype))
            cache = cache._replace(cross=tr.build_cross_cache(params, cfg,
                                                              enc_out))
    step = make_serve_step(cfg)

    # prefill by stepping the prompt through the decode path (cache fill)
    _sync(dev)
    t0 = time.perf_counter()
    for i in range(prompt_len - 1):
        _, cache = step(params, cache, prompts[:, i], i)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    out = []
    tok = prompts[:, -1]
    pos = prompt_len - 1
    t0 = time.perf_counter()
    for j in range(new_tokens):
        tok, cache = step(params, cache, tok, pos + j)
        out.append(tok)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    gen_tokens = torch.stack(out, dim=1).cpu()
    tps = batch * new_tokens / max(t_decode, 1e-9)
    if verbose:
        print(f"[serve] {cfg.name} on {dev}: prefill {prompt_len} toks in "
              f"{t_prefill:.2f}s; decoded {new_tokens} x {batch} in "
              f"{t_decode:.2f}s ({tps:.1f} tok/s)")
        print(f"[serve] sample continuation: {gen_tokens[0, :16].tolist()}")
    return {"arch": cfg.name, "tok_per_s": tps, "prefill_s": t_prefill,
            "decode_s": t_decode, "generated": gen_tokens.tolist()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    serve(args.arch, batch=args.batch, prompt_len=args.prompt_len,
          new_tokens=args.new_tokens, seed=args.seed, reduced=not args.full,
          device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
