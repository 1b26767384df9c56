"""Serving launcher: batched prefill, then token-by-token decode, with the
engine's step functions, at an arch's smoke config.

Counterpart of ``repro/launch/serve.py``, with the same arguments and
``--device`` (default: the card; ``cpu`` runs the plain versions):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \
      --batch 4 --prompt-len 32 --gen 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b \
      --long 256 --block 64      # chunked long-context ingestion
  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \
      --long 256 --block 64      # the shared block windowed over a block
  PYTHONPATH=src python -m repro_torch.launch.serve --arch pixtral-12b
                                 # prefill from precomputed embeddings

The LM families only: whisper's decode runs in the tests, as in the
reference.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import torch

from repro_torch.configs import canonical, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.models.lm import init_decode_cache, init_lm
from repro_torch.serve.engine import (make_decode_step, make_long_ingest,
                                      make_prefill_step)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@torch.no_grad()
def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--long", type=int, default=0,
                    help="long-context ingest length (ssm/hybrid only)")
    ap.add_argument("--block", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(canonical(args.arch))
    if cfg.family == "audio":
        raise SystemExit("the serve launcher covers LM families; whisper "
                         "decode is exercised in tests/test_torch_encdec.py")
    if args.long and cfg.family not in ("ssm", "hybrid"):
        raise SystemExit("--long needs a sub-quadratic arch (ssm/hybrid)")
    if args.long and cfg.family == "hybrid":
        cfg = cfg.with_(hybrid=dataclasses.replace(
            cfg.hybrid, attn_window_long=args.block))
    dev = resolve_device(args.device)
    model = init_lm(cfg, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    b = args.batch

    if args.long:
        tokens = torch.randint(0, cfg.vocab, (b, args.long), generator=gen,
                               device=dev)
        ingest = make_long_ingest(cfg, block=args.block)
        t0 = time.perf_counter()
        logits, _ = ingest(model, tokens)
        _sync(dev)
        print(f"[long] ingested {args.long} tokens x{b} in blocks of "
              f"{args.block}: {time.perf_counter() - t0:.2f}s; last-token "
              f"logits {tuple(logits.shape)}")
        return 0

    tokens = torch.randint(0, cfg.vocab, (b, args.prompt_len), generator=gen,
                           device=dev)
    prefill = make_prefill_step(cfg)
    # vlm: the prompt is precomputed (vision + text) embeddings
    batch = {"tokens": tokens} if cfg.embed_inputs else {
        "embeds": torch.randn((b, args.prompt_len, cfg.d_model),
                              generator=gen, device=dev).to(cfg.dtype)}
    t0 = time.perf_counter()
    logits = prefill(model, batch)
    _sync(dev)
    print(f"[prefill] {args.prompt_len} tokens x{b}: "
          f"{time.perf_counter() - t0:.2f}s")

    # the cache is filled token by token here, as the JAX launcher does
    cache = init_decode_cache(cfg, b, args.prompt_len + args.gen, device=dev)
    step = make_decode_step(cfg)
    for t in range(args.prompt_len):
        _, cache = step(model, cache, tokens[:, t])
    tok = torch.argmax(logits[:, -1], dim=-1)
    out = [tok]
    t0 = time.perf_counter()
    for _ in range(args.gen):
        logits_t, cache = step(model, cache, tok)
        tok = torch.argmax(logits_t, dim=-1)
        out.append(tok)
    _sync(dev)
    dt = time.perf_counter() - t0
    print(f"[decode] {args.gen} tokens x{b}: {dt:.2f}s "
          f"({b * args.gen / dt:.1f} tok/s); sample row: "
          f"{[int(x[0]) for x in out[:8]]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
