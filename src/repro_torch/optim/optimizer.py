"""Optimizers as plain functions over trees of tensors (port of
``repro.optim.optimizer``'s SGD / AdamW half).

The API mirrors the reference's:  ``opt = adamw(...); state =
opt.init(params); updates, state = opt.update(grads, state, params);
params = apply_updates(params, updates)``.  A tree is a dict, list or tuple
nesting of tensors (the SNN's ``{"layers": [{"w": ...}]}``).  States keep
the reference's fields (``step``, ``momentum`` / ``mu``, ``nu``); ``step``
is a Python int, so a schedule costs no device work.

The math follows the reference term for term: the schedule is read at the
step before the increment, AdamW adds ``eps`` after ``sqrt(v / bc2)`` and
puts the weight decay inside ``-lr·(…)``, and its default ``b2`` is 0.95
(``torch.optim.AdamW``'s is 0.999).  Schedules and bias corrections are
computed in float32, as the reference computes them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

__all__ = ["Optimizer", "sgd", "adamw", "apply_updates",
           "clip_by_global_norm", "global_norm", "tree_map", "tree_leaves",
           "cosine_schedule", "linear_warmup_cosine", "constant_schedule"]

Tree = Any
_f32 = np.float32


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (same structure); dicts, lists and tuples are nodes."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree: Tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Tree], Any]
    update: Callable[..., tuple[Tree, Any]]  # (grads, state, params) ->
                                             # (updates, state)


def _sqrt32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root: the float64 root rounded
    once to float32.  Torch's vectorised float32 ``sqrt`` on the CPU may
    miss the IEEE result in the last place, where XLA's does not."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def global_norm(tree: Tree) -> torch.Tensor:
    return _sqrt32(sum(torch.sum(torch.square(l.to(torch.float32)))
                       for l in tree_leaves(tree)))


def clip_by_global_norm(grads: Tree, max_norm: float
                        ) -> tuple[Tree, torch.Tensor]:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads), norm


def apply_updates(params: Tree, updates: Tree) -> Tree:
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


# ---------------------------------------------------------------------------
# Schedules: step (int) -> learning rate (a float32 value as a Python float)
# ---------------------------------------------------------------------------

def constant_schedule(lr: float):
    return lambda step: float(_f32(lr))


def _cosine_f32(lr: float, total_steps: int, final_frac: float, step):
    t = np.clip(_f32(step) / _f32(max(total_steps, 1)), _f32(0), _f32(1))
    cos = _f32(0.5) * (_f32(1) + np.cos(_f32(math.pi) * t))
    return _f32(lr) * (_f32(final_frac) + _f32(1 - final_frac) * cos)


def cosine_schedule(lr: float, total_steps: int, final_frac: float = 0.1):
    return lambda step: float(_cosine_f32(lr, total_steps, final_frac, step))


def linear_warmup_cosine(lr: float, warmup: int, total_steps: int,
                         final_frac: float = 0.1):
    total = max(total_steps - warmup, 1)

    def fn(step):
        if step < warmup:
            w = np.clip(_f32(step) / _f32(max(warmup, 1)), _f32(0), _f32(1))
            return float(_f32(lr) * w)
        return float(_cosine_f32(lr, total, final_frac, step - warmup))
    return fn


# ---------------------------------------------------------------------------
# SGD / AdamW
# ---------------------------------------------------------------------------

class SGDState(NamedTuple):
    step: int
    momentum: Tree


def sgd(schedule, momentum: float = 0.9, nesterov: bool = False) -> Optimizer:
    def init(params):
        return SGDState(0, tree_map(
            lambda p: torch.zeros_like(p, dtype=torch.float32), params))

    def update(grads, state, params=None):
        lr = schedule(state.step)
        mom = tree_map(lambda m, g: momentum * m + g.to(torch.float32),
                       state.momentum, grads)
        if nesterov:
            upd = tree_map(lambda m, g: -(lr * (momentum * m + g)), mom,
                           grads)
        else:
            upd = tree_map(lambda m: -lr * m, mom)
        return upd, SGDState(state.step + 1, mom)

    return Optimizer(init, update)


class AdamWState(NamedTuple):
    step: int
    mu: Tree
    nu: Tree


def adamw(schedule, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        def z(p):
            return torch.zeros_like(p, dtype=torch.float32)
        return AdamWState(0, tree_map(z, params), tree_map(z, params))

    def update(grads, state, params):
        step = state.step + 1
        lr = schedule(state.step)
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.to(torch.float32),
                      state.mu, grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2)
                      * torch.square(g.to(torch.float32)), state.nu, grads)
        bc1 = float(_f32(1) - _f32(b1) ** _f32(step))
        bc2 = float(_f32(1) - _f32(b2) ** _f32(step))

        def u(m, v, p):
            upd = (m / bc1) / (_sqrt32(v / bc2) + eps)
            if weight_decay:
                upd = upd + weight_decay * p.to(torch.float32)
            return -lr * upd

        return tree_map(u, mu, nu, params), AdamWState(step, mu, nu)

    return Optimizer(init, update)
