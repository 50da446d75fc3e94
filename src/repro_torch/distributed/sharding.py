"""Device meshes for the serving engines and the LM's logical-axis rules
(port of ``repro.distributed.sharding``).

A :class:`DeviceMesh` is a grid of ``torch.device``s with named axes.  The
serving engine shards its lane tile over the data axis and each layer's
output columns over the model axis.  The grid may name one device more
than once: on one card, ``make_2d_device_mesh(1, 4, devices=["cuda:0"] *
4)`` runs four model shards and their spike exchange on that card; where
the grid names several cards, the shards sit on them and the exchange is
a peer copy.  Nothing here starts a process group: every shard is driven
from the calling process.

The LM substrate annotates its activations with *logical* axis names
("batch", "heads", "kv_seq", ...).  :class:`ShardingRules` maps each name
to mesh axes, as in the JAX package, and :func:`use_rules` installs a table
for the code below it.  On one device there is nothing to place, so
:func:`shard` only checks the names it is given against the active table
and returns its tensor unchanged; placing LM tensors over a mesh of several
cards is later work (the model axis across processes).
"""

from __future__ import annotations

import contextlib
import math
import threading
from dataclasses import dataclass, field

import numpy as np
import torch

__all__ = ["DeviceMesh", "make_device_mesh", "make_2d_device_mesh",
           "ShardingRules", "make_rules", "use_rules", "current_rules",
           "logical_spec", "shard", "DEFAULT_RULES", "FSDP_RULES"]


@dataclass(frozen=True, eq=False)
class DeviceMesh:
    """Named axes over a grid of devices.

    ``devices`` is a numpy object array of ``torch.device`` whose shape
    is the mesh shape, one axis per name in ``axis_names``.
    """

    axis_names: tuple[str, ...]
    devices: np.ndarray

    @property
    def shape(self) -> dict[str, int]:
        """Axis name → axis width (as ``jax.sharding.Mesh.shape``)."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)


def _visible_cards() -> list[torch.device]:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass devices=[...] (e.g. "
            "[torch.device('cpu')] * n) to build a mesh without a card")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_device_mesh(shape: tuple, axis_names: tuple, *,
                     devices=None) -> DeviceMesh:
    """A mesh of ``shape`` over the first ``prod(shape)`` of ``devices``.

    ``devices=None`` is every visible card (raises without one); an
    explicit list may repeat a device.
    """
    shape = tuple(int(n) for n in shape)
    axis_names = tuple(axis_names)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} and axis names {axis_names} "
                         f"differ in length")
    if any(n < 1 for n in shape):
        raise ValueError(f"mesh shape {shape} has an axis narrower than 1")
    pool = _visible_cards() if devices is None else \
        [torch.device(d) for d in devices]
    need = math.prod(shape)
    if need > len(pool):
        raise ValueError(f"a {shape} mesh needs {need} devices but only "
                         f"{len(pool)} are given")
    grid = np.empty(need, dtype=object)
    grid[:] = pool[:need]
    return DeviceMesh(axis_names, grid.reshape(shape))


def make_2d_device_mesh(data_devices: int | None = None,
                        model_devices: int = 1, *,
                        axis_names: tuple[str, str] = ("data", "model"),
                        devices=None) -> DeviceMesh:
    """Validated 2-D (data × model) mesh for the serving engines.

    The data axis shards the lane (batch) tile; the model axis shards each
    layer's output-neuron dimension (weight columns) with a spike exchange
    at layer boundaries.  ``data_devices=None`` absorbs every device the
    ``model_devices``-way model axis leaves over.  ``devices=None`` is
    every visible card; an explicit list may repeat a device.
    """
    pool = _visible_cards() if devices is None else \
        [torch.device(d) for d in devices]
    if len(set(axis_names)) != 2:
        raise ValueError(f"axis_names must be two distinct names, got "
                         f"{axis_names!r}")
    model_devices = int(model_devices)
    if model_devices < 1:
        raise ValueError(f"model_devices={model_devices} must be >= 1")
    if data_devices is None:
        if len(pool) % model_devices:
            raise ValueError(
                f"{len(pool)} devices do not divide over a "
                f"{model_devices}-way model axis — pass data_devices "
                f"explicitly or change the model width")
        data_devices = len(pool) // model_devices
    data_devices = int(data_devices)
    if data_devices < 1:
        raise ValueError(f"data_devices={data_devices} must be >= 1")
    need = data_devices * model_devices
    if need > len(pool):
        raise ValueError(
            f"{data_devices}×{model_devices} (data × model) mesh needs "
            f"{need} devices but only {len(pool)} are visible")
    return make_device_mesh((data_devices, model_devices),
                            tuple(axis_names), devices=pool[:need])


@dataclass(frozen=True)
class ShardingRules:
    """Mapping logical axis name → mesh axis (str | tuple | None)."""

    rules: dict = field(default_factory=dict)
    axis_sizes: dict = field(default_factory=dict)  # mesh axis → size

    def spec(self, *logical_axes: str | None) -> tuple:
        """The mesh axes of each logical axis (a ``PartitionSpec``'s
        entries, as a tuple)."""
        return tuple(self.rules.get(a) if a is not None else None
                     for a in logical_axes)

    def ways(self, logical_axis: str | None) -> int:
        """How many shards the resolved mesh axes would create."""
        entry = self.rules.get(logical_axis) if logical_axis else None
        if entry is None:
            return 1
        axes = entry if isinstance(entry, tuple) else (entry,)
        n = 1
        for a in axes:
            n *= self.axis_sizes.get(a, 1)
        return n

    def spec_for_shape(self, shape: tuple, *logical_axes) -> tuple:
        """Like spec(), but drops axes that do not divide the dim."""
        entries = []
        for dim, a in zip(shape, logical_axes):
            w = self.ways(a)
            ok = w > 1 and dim % w == 0
            entries.append(self.rules.get(a) if (a and ok) else None)
        return tuple(entries)

    def with_overrides(self, **kw) -> "ShardingRules":
        new = dict(self.rules)
        new.update(kw)
        return ShardingRules(new, self.axis_sizes)


def make_rules(mesh: DeviceMesh | None, *, fsdp: bool = True,
               sequence_parallel: bool = False) -> ShardingRules:
    """The production table over ``mesh``'s axes ("pod", "data",
    "model"), as ``repro.distributed.sharding.make_rules`` builds it."""
    if mesh is None:
        return ShardingRules({})
    axes = mesh.axis_names
    data_axes = tuple(a for a in ("pod", "data") if a in axes) or None
    model = "model" if "model" in axes else None
    rules = {
        "batch": data_axes,
        "seq": model if sequence_parallel else None,
        "seq_act": model if sequence_parallel else None,
        "embed": None,
        "heads": model,
        "kv": None,            # kv heads replicated within a TP group
        "head_dim": None,
        "mlp": model,
        "vocab": model,
        "experts": model,
        "expert_cap": data_axes,   # token capacity dim rides the data axes
        "kv_seq": model,       # decode-time KV cache sequence sharding
        "layers": None,
        "conv": None,
        "state": None,
        # parameter-only axes (FSDP shards the non-TP dim of weights):
        "fsdp": ("data" if (fsdp and "data" in axes) else None),
    }
    return ShardingRules(rules, mesh.shape)


DEFAULT_RULES = ShardingRules({})
FSDP_RULES = DEFAULT_RULES  # alias; see make_rules(fsdp=True)

_ctx = threading.local()


@contextlib.contextmanager
def use_rules(rules: ShardingRules):
    prev = getattr(_ctx, "rules", None)
    _ctx.rules = rules
    try:
        yield rules
    finally:
        _ctx.rules = prev


def current_rules() -> ShardingRules | None:
    return getattr(_ctx, "rules", None)


def logical_spec(*logical_axes) -> tuple:
    rules = current_rules()
    if rules is None:
        return ()
    return rules.spec(*logical_axes)


def shard(x: torch.Tensor, *logical_axes) -> torch.Tensor:
    """Check a tensor's logical axis names against the active rules and
    return it unchanged.

    The JAX package turns the names into a sharding constraint.  On one
    device no placement exists, and placing over a mesh of several cards
    waits for the model axis across processes, so here the names are only
    checked: one a table does not know raises, as does a list of names
    that does not match the tensor's rank.
    """
    rules = current_rules()
    if rules is None or not rules.rules:
        return x
    if len(logical_axes) != x.dim():
        raise ValueError(f"{len(logical_axes)} logical axes {logical_axes} "
                         f"for a tensor of rank {x.dim()}")
    unknown = [a for a in logical_axes if a is not None
               and a not in rules.rules]
    if unknown:
        raise KeyError(f"logical axes {unknown} are not in the active "
                       f"sharding rules")
    return x
