"""Batched serving launcher: prefill + decode with early-exit retirement.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \
      --requests 8 --prompt-len 32 --gen 24

Port of ``repro.launch.serve``: the same flags and printed lines.  The
model is the arch's ``get_reduced`` config (``--reduced`` is on and cannot
be turned off, as in the JAX package), with weights drawn from a generator
seeded 0.  It runs on the CUDA card; ``main(..., device="cpu")`` (or
``--device cpu``) runs it on the CPU.

Under ``torchrun`` it serves over ``launch.mesh.make_local_mesh()``, one
rank per card (``nccl``; ``gloo`` with ``--device cpu``): every rank draws
the same weights and prompts, places them by the production rules
(``fsdp=False``) and runs the same program on its shards; rank 0 prints.

  torchrun --nproc-per-node 4 -m repro_torch.launch.serve --device cpu
"""

from __future__ import annotations

import argparse
import time

import torch

import torch.distributed as dist

from ..configs import get_reduced
from ..device import resolve_device
from ..distributed.partition import batch_specs, param_specs, place, \
    to_shardings
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
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU (gloo under torchrun)")
    args = ap.parse_args(argv)

    device = device if device is not None else args.device
    mesh = make_local_mesh(
        devices=None if device is None or torch.device(device).type == "cuda"
        else [torch.device(device)], device=device)
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

    rules = make_rules(mesh, fsdp=False)
    with use_rules(rules):
        if mesh.torch_mesh is not None:
            model = place(model, to_shardings(
                mesh, rules, param_specs(cfg, model), model), mesh)
            prompts = place(prompts, to_shardings(
                mesh, rules, batch_specs(prompts), prompts), mesh)
        t0 = time.perf_counter()
        toks, active = generate(
            model, prompts, cfg, steps=args.gen,
            max_len=args.prompt_len + args.gen + 1,
            early_exit_fn=stability_gate(args.requests, args.patience,
                                         device=dev))
        active = active.cpu().numpy()          # waits for the device
        dt = time.perf_counter() - t0

    if dist.is_initialized() and dist.get_rank() != 0:
        return
    total_steps = active.sum()
    dense_steps = args.requests * args.gen
    print(f"generated {tuple(toks.shape)} in {dt:.2f}s")
    print(f"active sequence-steps: {total_steps}/{dense_steps} "
          f"({100 * total_steps / dense_steps:.0f}% — early exit saved "
          f"{100 * (1 - total_steps / dense_steps):.0f}%)")
    print("per-step active:", active.tolist())


if __name__ == "__main__":
    main()
