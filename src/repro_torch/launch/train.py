"""End-to-end training launcher (port of ``repro.launch.train``).

Runs real steps (reduced variants of the assigned archs by default, or an
arch at its published config with ``--full``) with the production
machinery: the train step, checkpointing, straggler detection, resume.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \\
      --steps 50 --reduced --batch 8 --seq 64 --ckpt-dir /tmp/run1

The same flags and printed lines as the JAX package's launcher.  It runs
on the CUDA card; ``main(..., device="cpu")`` runs it on the CPU.  The
parameters are drawn from a generator seeded 0.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..checkpoint import CheckpointManager, latest_step
from ..configs import get_config, get_reduced
from ..data import tokens as tok
from ..data.pipeline import prefetch
from ..device import resolve_device
from ..distributed.partition import to_shardings, train_state_specs
from ..distributed.sharding import make_rules, use_rules
from ..train import (StragglerDetector, TrainLoop, TrainSettings, init_state,
                     make_train_step)
from .mesh import make_local_mesh

__all__ = ["main", "train", "make_batches"]


def make_batches(cfg, batch: int, seq: int, seed: int = 0):
    stream = tok.TokenStreamConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                   global_batch=batch, seed=seed)
    for b in prefetch(tok.token_batches(stream)):
        out = {"tokens": b["tokens"], "labels": b["labels"]}
        if cfg.frontend == "vision":
            p = min(cfg.num_patches, seq // 2)
            out["patches"] = np.full((batch, p, cfg.d_model), 0.02, np.float32)
            out["tokens"] = out["tokens"][:, : seq - p]
        if cfg.is_encdec:
            out["frames"] = np.full((batch, cfg.encoder_seq, cfg.d_model),
                                    0.02, np.float32)
        yield out


def train(arch: str, *, steps: int = 50, batch: int = 8, seq: int = 64,
          reduced: bool = True, ckpt_dir: str | None = None,
          ckpt_every: int = 20, lr: float = 1e-3, microbatches: int = 1,
          metrics_hook=None, device=None):
    """Train ``arch`` for ``steps`` steps on the token stream (seed 0) on
    ``device`` (None = the CUDA card); resumes from ``ckpt_dir``'s latest
    checkpoint where there is one.  Returns ``(final state, history)``."""
    dev = resolve_device(device)
    cfg = get_reduced(arch) if reduced else get_config(arch)
    settings = TrainSettings(learning_rate=lr, warmup_steps=max(steps // 10, 1),
                             total_steps=steps, num_microbatches=microbatches)

    mesh = make_local_mesh(devices=None if dev.type == "cuda" else [dev])
    rules = make_rules(mesh, fsdp=True)
    with use_rules(rules):
        state = init_state(torch.Generator(device=dev).manual_seed(0), cfg,
                           settings, device=dev)
        # the reference shards its jit over these; on one card they
        # resolve (every rule name checked) and place nothing
        to_shardings(mesh, rules,
                     train_state_specs(cfg, cfg.optimizer, state), state)
        step = make_train_step(cfg, settings)

        mgr = None
        if ckpt_dir:
            mgr = CheckpointManager(ckpt_dir)
            if latest_step(ckpt_dir) is not None:
                state, at = mgr.restore(state, device=dev)
                print(f"resumed from step {at}")

        loop = TrainLoop(step, state, ckpt_manager=mgr,
                         ckpt_every=ckpt_every,
                         detector=StragglerDetector(),
                         metrics_hook=metrics_hook)
        final = loop.run(make_batches(cfg, batch, seq), steps)
    return final, loop.history


def main(argv=None, *, device=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    args = ap.parse_args(argv)

    def hook(rec):
        if rec["step"] % 10 == 0 or rec["step"] <= 2:
            print(f"step {rec['step']:5d}  loss {rec['loss']:.4f}  "
                  f"acc {rec['acc']:.3f}  {rec['wall_s']*1e3:.0f} ms"
                  + ("  [straggler]" if rec["straggler"] else ""))

    _, hist = train(args.arch, steps=args.steps, batch=args.batch,
                    seq=args.seq, reduced=args.reduced,
                    ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                    lr=args.lr, microbatches=args.microbatches,
                    metrics_hook=hook, device=device)
    print(f"final loss {hist[-1]['loss']:.4f}  "
          f"(first {hist[0]['loss']:.4f})")


if __name__ == "__main__":
    main()
