"""Optimizers as plain functions over trees of tensors (port of
``repro.optim.optimizer``: SGD, AdamW and Adafactor).

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

__all__ = ["Optimizer", "sgd", "adamw", "adafactor", "apply_updates",
           "clip_by_global_norm", "global_norm", "tree_map", "tree_leaves",
           "tree_items", "factored",
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


def tree_items(tree: Tree, prefix: str = "") -> list[tuple[str, Any]]:
    """``(dotted name, leaf)`` pairs in :func:`tree_leaves` order: dict
    keys and list indices joined by dots (a flat dict keyed by
    ``named_parameters()`` names keeps its names)."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in tree_items(v, f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in tree_items(v, f"{prefix}{i}.")]
    return [(prefix[:-1], tree)]


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Tree], Any]
    update: Callable[..., tuple[Tree, Any]]  # (grads, state, params) ->
                                             # (updates, state)
    # True where every state and update element depends only on the same
    # element of the gradient and parameter: a leaf may then be updated in
    # slices (the train step's streamed update bounds its temporaries so)
    elementwise: bool = True


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
    # as the reference promotes: a bf16 gradient times the float32 scale
    # is float32
    return tree_map(lambda g: g.to(torch.promote_types(
        g.dtype, torch.float32)) * scale, grads), norm


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


# ---------------------------------------------------------------------------
# Adafactor (Shazeer & Stern 2018): factored second moment
# ---------------------------------------------------------------------------

class AdafactorState(NamedTuple):
    step: int
    vr: Tree   # row second-moment (or full moment for unfactored leaves)
    vc: Tree   # col second-moment (dummy for unfactored leaves)


def factored(shape: tuple, min_dim_factored: int = 128) -> bool:
    """The reference's factoring rule on a leaf's shape: the trailing dim
    against everything before it, both at least ``min_dim_factored``."""
    if len(shape) < 2 or shape[-1] < min_dim_factored:
        return False
    return math.prod(shape[:-1]) >= min_dim_factored


def adafactor(schedule, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0, min_dim_factored: int = 128,
              weight_decay: float = 0.0, *, stacks=None) -> Optimizer:
    """Adafactor, term for term as the reference.

    The JAX package stacks layer parameters on a leading axis and decides
    factored-ness on the stacked leaf; the port's layers are separate
    tensors.  ``stacks(name)`` gives, for a leaf's dotted name, ``(key,
    count)``: the stacked leaf it belongs to there and that leaf's
    leading length (None: a leaf kept alone, the default for every leaf).
    Factored-ness is decided on ``(count, *shape)``.  A factored leaf keeps
    its moments per layer (``vr`` of ``shape[:-1]``, ``vc`` of
    ``shape[:-2] + shape[-1:]``); an unfactored stacked leaf's dummy
    ``vc`` is a scalar per layer (``(count,)`` stacked).

    The update's RMS clip is taken over every leaf of one key in one
    ``update`` call: the whole stack when the tree is updated at once (the
    reference with ``stream_optimizer=False``), one layer when the train
    step streams the update a layer at a time (its default).

    ``update(..., layout=...)`` takes local shards of placed leaves:
    ``layout`` maps a leaf's name to ``(mesh, placements, global shape)``
    of its parameter (the moments are placed as the parameter's dims they
    keep).  A row or column mean along a sharded dim is the local sum
    all-reduced over the mesh dims that shard it, over the global length;
    the RMS clip sums each leaf's local squares all-reduced over the dims
    it is sharded on (a replicated leaf counted once) over the global
    element count.
    """
    stack_of = stacks or (lambda name: None)

    def _is_factored(name, p):
        st = stack_of(name)
        shape = tuple(p.shape) if st is None else (st[1], *p.shape)
        if factored(shape, min_dim_factored) and st is not None \
                and p.dim() < 2:
            # the reference's column moment of a stacked vector would span
            # the stacking axis, coupling the layers
            raise ValueError(f"{name}: a factored stacked vector")
        return factored(shape, min_dim_factored)

    def init(params):
        vr, vc = [], []
        for name, p in tree_items(params):
            if _is_factored(name, p):
                vr.append(torch.zeros(p.shape[:-1], dtype=torch.float32,
                                      device=p.device))
                vc.append(torch.zeros(p.shape[:-2] + p.shape[-1:],
                                      dtype=torch.float32, device=p.device))
            else:
                vr.append(torch.zeros_like(p, dtype=torch.float32))
                dummy = () if stack_of(name) is not None else \
                    (tuple(p.shape[:1]) or (1,))
                vc.append(torch.zeros(dummy, dtype=torch.float32,
                                      device=p.device))
        ivr, ivc = iter(vr), iter(vc)
        return AdafactorState(0, tree_map(lambda _: next(ivr), params),
                              tree_map(lambda _: next(ivc), params))

    def update(grads, state, params, *, layout=None):
        step = state.step + 1
        lr = schedule(state.step)
        # beta2 ramps toward 1 (Shazeer-Stern schedule), in float32
        beta2 = _f32(1) - _f32(step) ** _f32(-decay)
        b2, omb = float(beta2), float(_f32(1) - beta2)
        layout = layout or {}
        mesh = next((lay[0] for lay in layout.values()), None)

        outs = []
        for (name, p), g, vr, vc in zip(tree_items(params),
                                        tree_leaves(grads),
                                        tree_leaves(state.vr),
                                        tree_leaves(state.vc)):
            lay = layout.get(name)
            g = g.to(torch.float32)
            g2 = torch.square(g) + eps
            # factored-ness is read from the state's shape, which init
            # decided on the stacked shape
            if vr.dim() < p.dim():
                nd = p.dim()
                new_vr = b2 * vr + omb * _mean(g2, -1, nd - 1, lay)
                new_vc = b2 * vc + omb * _mean(g2, -2, nd - 2, lay)
                # rank-1 reconstruction of the preconditioner
                r = new_vr / torch.clamp(
                    _mean(new_vr, -1, nd - 2, lay, keepdim=True), min=eps)
                u = g / (_sqrt32(r)[..., None]
                         * _sqrt32(new_vc)[..., None, :] + eps)
            else:
                new_vr = b2 * vr + omb * g2
                new_vc = vc
                u = g / (_sqrt32(new_vr) + eps)
            st = stack_of(name)
            outs.append((name if st is None else st[0], u, new_vr, new_vc,
                         p, lay))

        # update clipping by RMS, over each key's leaves in this call: the
        # squares summed per key and per set of sharded mesh dims
        sq, n = {}, {}
        for key, u, _, _, p, lay in outs:
            dims = _sharded_dims(lay)
            sq.setdefault(key, {})
            sq[key][dims] = sq[key].get(dims, 0) + torch.sum(torch.square(u))
            n[key] = n.get(key, 0) + (math.prod(lay[2]) if lay else
                                      u.numel())
        rms = {}
        for key, parts in sq.items():
            total = 0
            for dims, v in parts.items():
                for i in dims:
                    v = _all_reduce(v, mesh, i)
                total = total + v
            rms[key] = _sqrt32(total / n[key] + eps)

        def finish(key, u, p):
            u = u / torch.clamp(rms[key] / clip_threshold, min=1.0)
            if weight_decay:
                u = u + weight_decay * p.to(torch.float32)
            return -lr * u

        ups = iter([finish(k, u, p) for k, u, _, _, p, _ in outs])
        vrs = iter([o[2] for o in outs])
        vcs = iter([o[3] for o in outs])
        return (tree_map(lambda _: next(ups), params),
                AdafactorState(step, tree_map(lambda _: next(vrs), params),
                               tree_map(lambda _: next(vcs), params)))

    return Optimizer(init, update, elementwise=False)


def _sharded_dims(lay) -> tuple:
    """The mesh dims a placed leaf is sharded over (none unplaced)."""
    if lay is None:
        return ()
    from torch.distributed.tensor import Shard

    return tuple(i for i, p in enumerate(lay[1]) if isinstance(p, Shard))


def _all_reduce(t: torch.Tensor, mesh, i: int) -> torch.Tensor:
    from ..distributed.sharding import all_reduce

    return all_reduce(t, mesh, mesh.mesh_dim_names[i])


def _mean(t: torch.Tensor, dim: int, pdim: int, lay, *,
          keepdim: bool = False) -> torch.Tensor:
    """``t.mean(dim)`` of a leaf whose ``dim`` is its parameter's dim
    ``pdim``; on a local shard (``lay`` given), the local sum all-reduced
    over the mesh dims that shard ``pdim``, over its global length."""
    if lay is None:
        return torch.mean(t, dim=dim, keepdim=keepdim)
    from torch.distributed.tensor import Shard

    mesh, pl, shape = lay
    out = torch.sum(t, dim=dim, keepdim=keepdim)
    for i, p in enumerate(pl):
        if isinstance(p, Shard) and p.dim == pdim:
            out = _all_reduce(out, mesh, i)
    return out / shape[pdim]
