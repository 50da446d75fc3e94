"""Batched serving launcher: prefill + decode with early-exit retirement.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \
      --requests 8 --prompt-len 32 --gen 24

Port of ``repro.launch.serve``: the same flags and printed lines.  The
model is the arch's ``get_reduced`` config (``--reduced`` is on and cannot
be turned off, as in the JAX package), with weights drawn from a generator
seeded 0.  It runs on the CUDA card; ``main(..., device="cpu")`` runs it on
the CPU.
"""

from __future__ import annotations

import argparse
import time

import torch

from ..configs import get_reduced
from ..device import resolve_device
from ..distributed.sharding import make_rules, use_rules
from ..models import lm_init
from ..serve import generate, stability_gate
from .mesh import make_local_mesh

__all__ = ["main"]


def main(argv=None, *, device=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--patience", type=int, default=3)
    ap.add_argument("--reduced", action="store_true", default=True)
    args = ap.parse_args(argv)

    dev = resolve_device(device)
    cfg = get_reduced(args.arch)
    gen = torch.Generator(device=dev).manual_seed(0)
    model = lm_init(cfg, generator=gen, device=dev)
    prompts = {"tokens": torch.randint(
        0, cfg.vocab_size, (args.requests, args.prompt_len),
        generator=gen, device=dev, dtype=torch.int32)}
    if cfg.is_encdec:
        prompts["frames"] = torch.full(
            (args.requests, cfg.encoder_seq, cfg.d_model), 0.02,
            dtype=torch.float32, device=dev)

    mesh = make_local_mesh(devices=None if dev.type == "cuda" else [dev])
    with use_rules(make_rules(mesh, fsdp=False)):
        t0 = time.perf_counter()
        toks, active = generate(
            model, prompts, cfg, steps=args.gen,
            max_len=args.prompt_len + args.gen + 1,
            early_exit_fn=stability_gate(args.requests, args.patience,
                                         device=dev))
        active = active.cpu().numpy()          # waits for the device
        dt = time.perf_counter() - t0

    total_steps = active.sum()
    dense_steps = args.requests * args.gen
    print(f"generated {tuple(toks.shape)} in {dt:.2f}s")
    print(f"active sequence-steps: {total_steps}/{dense_steps} "
          f"({100 * total_steps / dense_steps:.0f}% — early exit saved "
          f"{100 * (1 - total_steps / dense_steps):.0f}%)")
    print("per-step active:", active.tolist())


if __name__ == "__main__":
    main()
