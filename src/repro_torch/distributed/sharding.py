"""Device meshes for the serving engines and the LM's logical-axis rules
(port of ``repro.distributed.sharding``).

A :class:`DeviceMesh` is a grid of ``torch.device``s with named axes.  The
serving engine shards its lane tile over the data axis and each layer's
output columns over the model axis.  The grid may name one device more
than once: on one card, ``make_2d_device_mesh(1, 4, devices=["cuda:0"] *
4)`` runs four model shards and their spike exchange on that card; where
the grid names several cards, the shards sit on them and the exchange is
a peer copy.  The SNN engines drive every shard from the calling
process.

The LM substrate annotates its activations with *logical* axis names
("batch", "heads", "kv_seq", ...).  :class:`ShardingRules` maps each name
to mesh axes, as in the JAX package, and :func:`use_rules` installs a table
for the code below it.  The LM runs over a mesh one process per rank: when
a ``torch.distributed`` process group is up and the mesh has one device
per rank, :func:`make_device_mesh` also builds the matching
``torch.distributed`` ``DeviceMesh`` (``DeviceMesh.torch_mesh``), tensors
are placed on it as DTensors (``partition.place``), and :func:`shard`
redistributes a DTensor to the placements the rules give (GSPMD's
sharding constraint).  A plain tensor, or no process group, keeps the
one-process behaviour: the names are checked and the tensor returned.

:func:`run_local` is the port's ``shard_map``: a region that runs on local
shards (``torch.distributed.tensor.experimental.local_map``) with its
collectives written out (:func:`all_reduce`, :func:`all_gather`), where
DTensor has no rule or its rule would gather what GSPMD keeps sharded.
"""

from __future__ import annotations

import contextlib
import math
import threading
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["DeviceMesh", "make_device_mesh", "make_2d_device_mesh",
           "ShardingRules", "make_rules", "use_rules", "current_rules",
           "logical_spec", "shard", "DEFAULT_RULES", "FSDP_RULES",
           "placements", "is_placed", "run_local", "all_reduce",
           "all_gather", "mesh_rank", "mesh_ways", "logical_placements",
           "model_sharded", "partial_over_model", "partial_where_replicated"]


@dataclass(frozen=True, eq=False)
class DeviceMesh:
    """Named axes over a grid of devices.

    ``devices`` is a numpy object array of ``torch.device`` whose shape
    is the mesh shape, one axis per name in ``axis_names``.
    """

    axis_names: tuple[str, ...]
    devices: np.ndarray
    # the torch.distributed DeviceMesh of the same shape and axis names,
    # one rank per device (None without a process group of that size)
    torch_mesh: object = None

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
    return DeviceMesh(axis_names, grid.reshape(shape),
                      _process_mesh(shape, axis_names, pool[0]))


def _process_mesh(shape: tuple, axis_names: tuple, device: torch.device):
    """``init_device_mesh`` over the running process group when it has
    exactly one rank per mesh device; else None (one process drives
    the whole grid)."""
    if not (dist.is_available() and dist.is_initialized()) or \
            dist.get_world_size() != math.prod(shape):
        return None
    from torch.distributed.device_mesh import init_device_mesh

    kind = "cuda" if device.type == "cuda" else "cpu"
    return init_device_mesh(kind, shape, mesh_dim_names=axis_names)


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
    # mesh axes over which placed regions leave weight gradients
    # unreduced: the train step reduces over them itself (int8
    # error-feedback compression over "pod")
    deferred: tuple = ()

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
        return ShardingRules(new, self.axis_sizes, self.deferred)


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


def is_placed(x) -> bool:
    """Whether ``x`` is a DTensor (placed over a process mesh)."""
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def placements(entries: tuple, mesh_dim_names: tuple) -> tuple:
    """DTensor placements (one per mesh dim) of a mesh-axis tuple (one
    entry per tensor dim, each None, an axis name or a tuple of them: a
    ``to_shardings`` leaf): a mesh axis named for tensor dim *i* is
    ``Shard(i)`` on that mesh dim, every other mesh dim ``Replicate()``.
    A tuple entry shards its dim over its axes major to minor, which is
    DTensor's order when the axes follow the mesh's."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate()] * len(mesh_dim_names)
    last = -1
    for d, e in enumerate(entries):
        for a in (() if e is None else e if isinstance(e, tuple) else (e,)):
            i = mesh_dim_names.index(a)
            if isinstance(e, tuple) and i < last:
                raise ValueError(f"axes {e} do not follow the mesh order "
                                 f"{mesh_dim_names}")
            last = i
            out[i] = Shard(d)
        last = -1
    return tuple(out)


def _check(x, logical_axes, rules) -> None:
    if len(logical_axes) != x.dim():
        raise ValueError(f"{len(logical_axes)} logical axes {logical_axes} "
                         f"for a tensor of rank {x.dim()}")
    unknown = [a for a in logical_axes if a is not None
               and a not in rules.rules]
    if unknown:
        raise KeyError(f"logical axes {unknown} are not in the active "
                       f"sharding rules")


def shard(x: torch.Tensor, *logical_axes) -> torch.Tensor:
    """The JAX package's sharding constraint.

    A DTensor is redistributed to the placements the active rules give
    its shape (``rules.spec_for_shape``: axes that do not divide their dim
    are dropped); a ``Partial`` left by a region is reduced on the way.
    A plain tensor is returned unchanged.  Either way the names are
    checked: one a table does not know raises, as does a list of names
    that does not match the tensor's rank.
    """
    rules = current_rules()
    if rules is None or not rules.rules:
        return x
    _check(x, logical_axes, rules)
    if not is_placed(x):
        return x
    mesh = x.device_mesh
    want = placements(rules.spec_for_shape(tuple(x.shape), *logical_axes),
                      mesh.mesh_dim_names)
    return x if tuple(x.placements) == want else \
        x.redistribute(mesh, want)


def mesh_rank(mesh, name: str) -> int:
    """This process's coordinate on the torch mesh dim ``name`` (0 where
    the mesh has no such dim)."""
    names = mesh.mesh_dim_names or ()
    return mesh.get_local_rank(name) if name in names else 0


def mesh_ways(mesh, name: str) -> int:
    """The width of the torch mesh dim ``name`` (1 where it has none)."""
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(name)) if name in names else 1


def logical_placements(mesh, shape, *logical_axes) -> tuple:
    """The placements the active rules give a tensor of ``shape`` with
    these logical axes on the torch mesh ``mesh``."""
    if len(shape) != len(logical_axes):
        raise ValueError(f"{len(logical_axes)} logical axes {logical_axes} "
                         f"for a shape of rank {len(shape)}")
    rules = current_rules()
    return placements(rules.spec_for_shape(tuple(shape), *logical_axes),
                      mesh.mesh_dim_names)


def model_sharded(pl: tuple, mesh) -> bool:
    """Whether placements ``pl`` shard a dim over the "model" mesh dim."""
    from torch.distributed.tensor import Shard

    names = mesh.mesh_dim_names or ()
    return "model" in names and isinstance(pl[names.index("model")], Shard)


def partial_over_model(pl: tuple, mesh, partial: bool = True) -> tuple:
    """``pl`` with the "model" mesh dim a partial sum (when ``partial``):
    a region's output that each model shard computed a part of."""
    from torch.distributed.tensor import Partial

    names = mesh.mesh_dim_names or ()
    if not partial or "model" not in names:
        return tuple(pl)
    i = names.index("model")
    return tuple(pl[:i]) + (Partial(),) + tuple(pl[i + 1:])


def partial_where_replicated(pl: tuple, mesh, *,
                             summed: tuple = ()) -> tuple:
    """Gradient placements of a region input placed as ``pl``: a partial
    sum on every mesh dim it is replicated on, except the dims in
    ``summed`` (the region sums over them itself) and the active rules'
    ``deferred`` ones (the caller reduces over them), which stay
    replicated."""
    from torch.distributed.tensor import Partial, Replicate

    rules = current_rules()
    keep = set(summed) | set(rules.deferred if rules is not None else ())
    names = mesh.mesh_dim_names or ()
    return tuple(Partial() if isinstance(p, Replicate) and n not in keep
                 else p for n, p in zip(names, pl))



def run_local(fn, mesh, ins, out_placements):
    """Run ``fn`` on the local shards of ``ins`` (the port's
    ``shard_map``, through ``local_map``).

    ``ins`` is a sequence of ``(value, placements)`` or ``(value,
    placements, grad_placements)``: each DTensor is first redistributed
    to its placements, plain values (placements None) pass as they are.
    By default the gradient of a local input is a partial sum over every
    mesh dim it was replicated on (each rank computes a disjoint part of
    the region's outputs), so it is reduced on the way back: the FSDP
    gather's reduce-scatter, the model axis' all-reduce
    (:func:`partial_where_replicated`).
    ``out_placements`` as ``local_map`` takes them.
    """
    from torch.distributed.tensor import Placement
    from torch.distributed.tensor.experimental import local_map

    # local_map reads a list as one output's placements, a tuple as one
    # entry per output
    if all(isinstance(p, Placement) for p in out_placements):
        out_placements = list(out_placements)
    else:
        out_placements = tuple(None if p is None else list(p)
                               for p in out_placements)
    vals = [i[0] for i in ins]
    in_pl = tuple(None if i[1] is None else tuple(i[1]) for i in ins)
    grad_pl = tuple(
        tuple(i[2]) if len(i) > 2 else None if p is None else
        partial_where_replicated(p, mesh) for i, p in zip(ins, in_pl))
    return local_map(fn, out_placements=out_placements, in_placements=in_pl,
                     in_grad_placements=grad_pl, device_mesh=mesh,
                     redistribute_inputs=True)(*vals)


def _group(mesh, name: str):
    return (mesh, mesh.mesh_dim_names.index(name))


class _AllReduce(torch.autograd.Function):
    """All-reduce over one mesh dim.  Backward: the same all-reduce when
    each rank uses the result on its own shard (``grad="sum"``), the
    identity when every rank uses it alike (``grad="same"``)."""

    @staticmethod
    def forward(ctx, x, mesh, name, op, grad):
        import torch.distributed._functional_collectives as fc

        ctx.mesh, ctx.name, ctx.grad = mesh, name, grad
        return fc.wait_tensor(fc.all_reduce(x, op, _group(mesh, name)))

    @staticmethod
    def backward(ctx, g):
        import torch.distributed._functional_collectives as fc

        if ctx.grad == "sum":
            g = fc.wait_tensor(fc.all_reduce(g.contiguous(), "sum",
                                             _group(ctx.mesh, ctx.name)))
        return g, None, None, None, None


def all_reduce(x: torch.Tensor, mesh, name: str, op: str = "sum", *,
               grad: str = "same") -> torch.Tensor:
    """All-reduce a local tensor over the torch mesh dim ``name``
    (``op``: "sum" | "max"); ``grad`` as :class:`_AllReduce`."""
    if op != "sum" and torch.is_grad_enabled() and x.requires_grad:
        x = x.detach()             # a max is a constant of the backward
    return _AllReduce.apply(x.contiguous(), mesh, name, op, grad)


def all_gather(x: torch.Tensor, mesh, name: str, dim: int) -> torch.Tensor:
    """All-gather a local tensor over the torch mesh dim ``name`` along
    tensor dim ``dim`` (no gradient)."""
    import torch.distributed._functional_collectives as fc

    gather = getattr(fc, "all_gather_single", fc.all_gather_tensor)
    return fc.wait_tensor(gather(x.detach().contiguous(), dim,
                                 _group(mesh, name)))
