"""Parameter / cache / batch partition specs, derived from leaf names
(port of ``repro.distributed.partition``).

The model names its parameters consistently (wq/wk/wv/wo, w1/w2/w3,
router, embed, ...), so a leaf's logical axes come from one rule table
keyed on its name, the t5x/MaxText "named rules" approach.  The JAX
package stacks layers on a leading axis whose spec is ``None``; the port's
layers are separate tensors (``layers.<i>...``, ``encoder.layers.<i>...``,
one cache entry per layer), so their specs are the JAX package's without
that leading ``None``.

Logical axes used (resolved to mesh axes by ``ShardingRules``):
  fsdp    → "data"   ZeRO-3 parameter sharding
  heads   → "model"  TP over attention q-heads / mamba heads
  kv      → None     GQA kv-heads replicated (kv < TP degree)
  mlp     → "model"  TP over FFN hidden / mamba inner
  vocab   → "model"  TP over embedding / lm-head vocab
  experts → "model"  EP over MoE experts
  batch   → data axes; kv_seq → "model" (decode-time flash-decoding split)

:func:`to_shardings` resolves logical axes to mesh axes, as the
reference's does.  :func:`place` puts a tree (parameters, a train state,
a cache, a batch) on a process mesh under them, as DTensors: what the
reference's ``in_shardings`` do.  Every family's trees are placed so: MoE
weights by expert, a hybrid stack's mixed attention and Mamba caches,
whisper's cross caches and frames, llava's patches, and Adafactor's row
and column moments on the dims of the parameter they keep.  The pieces
only the port's Nemotron-H has (:func:`unplaced_pieces`) have no rule:
``place`` refuses a model that holds one, naming it.  Without a
process group nothing is placed and the one-process path runs
(``distributed.sharding.shard`` then only checks names).
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from ..optim.optimizer import (AdafactorState, AdamWState, SGDState,
                               factored)
from .sharding import DeviceMesh, ShardingRules, placements

__all__ = ["param_logical_axes", "param_specs", "cache_specs", "batch_specs",
           "unplaced_pieces",
           "opt_state_specs", "to_shardings", "train_state_specs", "place"]

Tree = Any


def _is_spec_leaf(x) -> bool:
    """Plain tuple of axis names = a spec leaf (NamedTuples are nodes)."""
    return (isinstance(x, tuple) and not hasattr(x, "_fields")
            and all(e is None or isinstance(e, (str, tuple)) for e in x))


def _shape(x) -> tuple:
    return tuple(x.shape) if hasattr(x, "shape") else ()


def _named(tree) -> dict:
    return dict(tree.named_parameters()) if isinstance(tree, nn.Module) \
        else tree


def param_logical_axes(cfg, path, leaf) -> tuple:
    """Logical axis names for one parameter leaf: ``path`` its dotted name
    (or the names along it), ``leaf`` anything with a ``shape``."""
    names = path.split(".") if isinstance(path, str) else \
        [str(p) for p in path]
    last = names[-1]
    ndim = len(leaf.shape)

    def out(*axes):
        if len(axes) != ndim:
            raise ValueError(f"{names}: {tuple(leaf.shape)} has no rank-"
                             f"{len(axes)} spec {axes}")
        return axes

    if last == "embed":
        return ("vocab", "fsdp")
    if last == "pos_embed":
        return (None, "fsdp")
    if last == "lm_head":
        return ("fsdp", "vocab")

    if last == "wq":
        return out("fsdp", "heads", None)
    if last in ("wk", "wv"):
        kvp = leaf.shape[-2]
        ax = "heads" if kvp == cfg.padded_num_heads else "kv"
        return out("fsdp", ax, None)
    if last == "wo":
        return out("heads", None, "fsdp")
    if last in ("q_norm", "k_norm"):
        return out(None)

    if last == "router":
        return out("fsdp", None)
    if last in ("w1", "w3"):
        if ndim == 3:                       # MoE (E, D, F)
            return out("experts", "fsdp", None)
        return out("fsdp", "mlp")
    if last == "w2":
        if ndim == 3:                       # MoE (E, F, D)
            return out("experts", None, "fsdp")
        return out("mlp", "fsdp")

    # mamba
    if last in ("wz", "wx"):
        return out("fsdp", "mlp")
    if last in ("wb", "wc"):
        return out("fsdp", None)
    if last == "wdt":
        return out("fsdp", "heads")
    if last == "conv_x":
        return out(None, "mlp")
    if last in ("conv_b", "conv_c"):
        return out(None, None)
    if last in ("A_log", "D", "dt_bias"):
        return out("heads")
    if last == "out":
        return out("mlp", "fsdp")
    if last == "norm":                      # mamba gated-norm scale (d_inner)
        return out("mlp")

    # norm scales/biases and anything 1-D: replicated
    return out(*([None] * ndim))


def param_specs(cfg, params_shape) -> dict:
    """Logical-axis tuples (unresolved) by parameter name, for a
    ``Transformer`` or a ``{name: tensor}`` dict."""
    return {n: param_logical_axes(cfg, n, p)
            for n, p in _named(params_shape).items()}


def cache_specs(cfg, cache_shape: list, *, decode: bool = True) -> list:
    """Logical axes for a KV/SSM cache (one entry per layer)."""

    def one(name, leaf):
        if name in ("k", "v"):
            # (B, S, KV, hd): shard the cache sequence for decode (flash-
            # decoding); prefill keeps heads on model via activation specs
            return ("batch", "kv_seq" if decode else None, None, None)
        if name == "ssm":
            return ("batch", "heads", None, None)
        if name == "conv_x":
            return ("batch", None, "mlp")
        if name in ("conv_b", "conv_c"):
            return ("batch", None, None)
        return (None,) * leaf.dim()

    return [{part: type(c)(*(one(f, getattr(c, f)) for f in c._fields))
             for part, c in entry.items()} for entry in cache_shape]


def batch_specs(batch_shape: dict) -> dict:
    return {k: ("batch",) + (None,) * (len(_shape(v)) - 1)
            for k, v in batch_shape.items()}


def opt_state_specs(opt_name: str, pspecs: dict, params_shape,
                    min_dim_factored: int = 128, *, cfg=None):
    """Spec tree for optimizer state, mirroring ``optim.optimizer``'s
    layouts.  For Adafactor, ``cfg`` names the layers the JAX package
    stacks: their factored-ness is decided on the stacked shape, as the
    optimizer decides it, and an unfactored one's dummy column moment is a
    scalar per layer (spec ``()``)."""
    from ..models.transformer import stack_position

    scalar = ()
    if opt_name == "adamw":
        return AdamWState(step=scalar, mu=pspecs, nu=pspecs)
    if opt_name == "sgd":
        return SGDState(step=scalar, momentum=pspecs)
    if opt_name == "adafactor":
        shapes = {n: tuple(p.shape) for n, p in _named(params_shape).items()}
        vr, vc = {}, {}
        for n, spec in pspecs.items():
            pos = None if cfg is None else stack_position(cfg, n)
            shape = shapes[n] if pos is None else (pos[2], *shapes[n])
            if factored(shape, min_dim_factored):
                vr[n] = tuple(spec[:-1])
                vc[n] = tuple(spec[:-2]) + tuple(spec[-1:])
            else:
                vr[n] = tuple(spec)
                vc[n] = () if pos is not None else \
                    (tuple(spec[:1]) if shapes[n] else (None,))
        return AdafactorState(step=scalar, vr=vr, vc=vc)
    raise ValueError(opt_name)


def train_state_specs(cfg, opt_name: str, state_shape) -> Any:
    """Specs for a ``train.TrainState`` (step, params, opt_state[,
    comp_err])."""
    pspecs = param_specs(cfg, state_shape.params)
    ospecs = opt_state_specs(opt_name, pspecs, state_shape.params, cfg=cfg)
    comp = pspecs if state_shape.comp_err is not None else None
    return type(state_shape)(step=(), params=pspecs, opt_state=ospecs,
                             comp_err=comp)


def to_shardings(mesh: DeviceMesh, rules: ShardingRules, spec_tree: Tree,
                 shape_tree: Tree | None = None):
    """Resolve logical-axis tuples to mesh-axis tuples (a
    ``PartitionSpec``'s entries) under ``rules``; nothing is placed.

    With ``shape_tree`` given, axes that don't divide the dim are dropped
    (e.g. "batch" sharding of a global_batch=1 long-context decode).
    ``mesh`` is the reference's argument; the rules carry its axis sizes.
    """
    del mesh

    def walk(spec, shape):
        if spec is None:
            return None
        if _is_spec_leaf(spec):
            if shape is None:
                return rules.spec(*spec)
            return rules.spec_for_shape(_shape(shape), *spec)
        if shape is not None:
            shape = _named(shape)
        if isinstance(spec, dict):
            return {k: walk(v, None if shape is None else shape[k])
                    for k, v in spec.items()}
        if hasattr(spec, "_fields"):
            return type(spec)(*(walk(getattr(spec, f), None if shape is None
                                     else getattr(shape, f))
                                for f in spec._fields))
        return type(spec)(walk(v, None if shape is None else shape[i])
                          for i, v in enumerate(spec))

    return walk(spec_tree, shape_tree)


def _place_tensor(t: torch.Tensor, entries, tmesh):
    """One tensor as a DTensor under mesh-axis ``entries``: the local
    shard of ``distribute_tensor`` for data (every rank holds the same
    global tensor, so nothing is sent), ``DTensor.from_local`` of an empty
    shard on ``meta`` (no global tensor is ever allocated)."""
    from torch.distributed.tensor import DTensor, Shard, distribute_tensor

    pl = placements(tuple(entries) if entries else (None,) * t.dim(),
                    tmesh.mesh_dim_names)
    if t.device.type != "meta":
        return distribute_tensor(t.detach(), tmesh, pl, src_data_rank=None)
    local = list(t.shape)
    for i, p in enumerate(pl):
        if isinstance(p, Shard):
            local[p.dim] //= tmesh.size(i)
    return DTensor.from_local(torch.empty(local, dtype=t.dtype,
                                          device="meta"),
                              tmesh, pl, run_check=False)


def unplaced_pieces(cfg) -> list[str]:
    """The pieces of ``cfg`` no placement rule covers: the port's own
    fields (``configs.base.PORT_FIELDS``) that change a layer; [] for
    every architecture of the JAX package."""
    pieces = []
    if cfg.layer_pattern:
        pieces.append("layer_pattern (blocks of one mixer or one FFN)")
    if cfg.ssm_groups != 1:
        pieces.append(f"ssm_groups={cfg.ssm_groups} (grouped B/C and "
                      f"gated norm)")
    if cfg.attn_chunk_remat:
        pieces.append("attn_chunk_remat (chunked attention's recompute)")
    if cfg.moe_router != "softmax":
        pieces.append(f"moe_router={cfg.moe_router!r} (the dropless "
                      f"held-expert dispatch)")
    if cfg.moe_shared_ff:
        pieces.append("moe_shared_ff (the shared expert)")
    if cfg.moe_experts_held:
        pieces.append("moe_experts_held (a share of the experts)")
    return pieces


def _models(tree):
    """The ``nn.Module``s with a ``cfg`` in ``tree``."""
    if isinstance(tree, nn.Module):
        if hasattr(tree, "cfg"):
            yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _models(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _models(v)


def place(tree: Tree, spec_tree: Tree, mesh: DeviceMesh) -> Tree:
    """``tree`` (tensors, ``nn.Module``s, dicts, lists, named tuples;
    ints and None pass) with every tensor a DTensor on ``mesh``'s process
    mesh under the mesh-axis tuples of ``spec_tree`` (:func:`to_shardings`'
    output).  A module's parameters are replaced in place (it is returned);
    nothing else is modified.  Raises where ``mesh`` has no process mesh:
    there is no unplaced fallback; and ``NotImplementedError`` for a model
    whose config has :func:`unplaced_pieces`."""
    for model in _models(tree):
        pieces = unplaced_pieces(model.cfg)
        if pieces:
            raise NotImplementedError(
                f"{model.cfg.name}: no placement for "
                + "; ".join(pieces))
    tmesh = mesh.torch_mesh
    if tmesh is None:
        raise RuntimeError(
            f"mesh {mesh.shape} has no process mesh: start a process group "
            f"of {mesh.size} ranks before building it")

    def walk(t, spec):
        if t is None or isinstance(t, (int, float, bool)):
            return t
        if isinstance(t, torch.Tensor):
            return _place_tensor(t, spec, tmesh)
        if isinstance(t, nn.Module):
            for name, p in list(t.named_parameters()):
                mod, _, leaf = name.rpartition(".")
                owner = t.get_submodule(mod) if mod else t
                setattr(owner, leaf, nn.Parameter(
                    _place_tensor(p, spec[name], tmesh),
                    requires_grad=p.requires_grad))
            return t
        if isinstance(t, dict):
            return {k: walk(v, spec[k]) for k, v in t.items()}
        if hasattr(t, "_fields"):
            return type(t)(*(walk(getattr(t, f), getattr(spec, f))
                             for f in t._fields))
        return type(t)(walk(v, spec[i]) for i, v in enumerate(t))

    return walk(tree, spec_tree)
