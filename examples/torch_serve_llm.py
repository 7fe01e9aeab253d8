"""Batched LLM serving with a KV/SSM cache on the PyTorch port.

Prefills a batch of prompts through ``make_prefill_step`` (the full-sequence
forward: on the card its attention and SSD scan are the hand-written
kernels), then greedy-decodes new tokens through the same ``serve_step``
that the decode_32k / long_500k dry-run shapes run on the production mesh
(``repro_torch.launch.dryrun``), the cache filled by stepping the prompt.

The port's counterpart of ``examples/serve_llm.py``: its flags and output,
on the card unless ``--device cpu``, at the arch's reduced size unless
``--full``.

Run:  PYTHONPATH=src python examples/torch_serve_llm.py --arch mamba2-370m
      PYTHONPATH=src python examples/torch_serve_llm.py --arch mamba2-370m --full
      (try an SSM/hybrid arch for O(1)-state decode, or a dense GQA arch)
"""
import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device, sync
from repro_torch.launch.serve import serve
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models import transformer as tr


def prefill(arch: str, *, batch: int, prompt_len: int, full: bool,
            seed: int, device) -> dict:
    """One batched prefill of random prompts (the params and prompts
    ``serve`` draws from the same seed): last-position logits, wall and
    tokens/s (the second of two calls)."""
    cfg = get_config(arch)
    if not full:
        cfg = cfg.reduced()
    gen = torch.Generator(device=device).manual_seed(seed)
    params = tr.init_params(gen, cfg, device=device)
    prompts = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=gen,
                            device=device)
    extra = ()
    if cfg.frontend != "none":
        extra = (0.02 * torch.randn((batch, cfg.n_frontend_tokens,
                                     cfg.d_model), generator=gen,
                                    device=device),)
    step = make_prefill_step(cfg)
    step(params, prompts, *extra)                        # warm-up
    sync(device)
    t0 = time.perf_counter()
    logits = step(params, prompts, *extra)
    sync(device)
    wall = time.perf_counter() - t0
    return {"logits": logits, "prefill_wall_s": wall,
            "prefill_tok_per_s": batch * prompt_len / max(wall, 1e-9)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="mamba2-370m")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=48)
    ap.add_argument("--full", action="store_true",
                    help="the arch at full width and depth (f32 params)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    pre = prefill(args.arch, batch=args.batch, prompt_len=args.prompt_len,
                  full=args.full, seed=0, device=dev)
    print(f"[prefill] {args.arch}: {args.batch} x {args.prompt_len} tokens "
          f"in {pre['prefill_wall_s'] * 1e3:.1f} ms "
          f"({pre['prefill_tok_per_s']:.1f} tok/s)")
    out = serve(args.arch, batch=args.batch, prompt_len=args.prompt_len,
                new_tokens=args.new_tokens, reduced=not args.full,
                device=dev)
    first = pre["logits"].argmax(-1).cpu().tolist()
    agree = sum(a == g[0] for a, g in zip(first, out["generated"]))
    print(f"[done] {out['arch']}: {out['tok_per_s']:.1f} tok/s; the "
          f"prefill's next token equals the decode's first in {agree} of "
          f"{args.batch} rows")
    return {**out, **{k: v for k, v in pre.items() if k != "logits"},
            "first_token_agree": agree}


if __name__ == "__main__":
    main()
