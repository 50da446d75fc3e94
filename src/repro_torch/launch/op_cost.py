"""Op-level cost counter over eager PyTorch (port of
``repro.launch.hlo_cost``).

A torch program has no HLO to parse: what it runs is the sequence of ops
eager PyTorch dispatches.  :class:`OpCounter` is a ``TorchDispatchMode``
that watches a real step run (on ``meta`` tensors for a dry-run: shapes
only, nothing allocated) and logs every dispatched op, below autograd and
after composite ops decompose, so the backward's products, the remat
recomputation and an ``einsum``'s ``bmm`` s are seen as they run.  From
the log it accumulates, with ``hlo_cost``'s conventions:

  * flops            — 2·R·K per matrix product (``mm``, ``bmm``,
                       ``addmm``, ``baddbmm``, ``mv``, ``dot``; R result
                       elements, K contracted elements); elementwise work
                       is not counted,
  * bytes            — operand + result bytes per dispatched op.  Every
                       eager op materialises its result, so this is larger
                       than XLA's count over fused computations and is not
                       comparable with it.  Views, ``detach`` and metadata
                       ops are free; an in-place or ``out=`` op whose
                       operand is its result counts that tensor once (the
                       accumulator credit of ``hlo_cost._io_bytes``),
  * collective bytes — per kind, for every c10d op that reaches the
                       dispatcher, max(result, operand) bytes with a 2×
                       ring multiplier for all-reduce,
  * peak_bytes       — the most bytes of device storage live at once:
                       each storage counted once however many views read
                       it, from when an op first returns or reads it until
                       its finalizer runs.  Storages are keyed by identity
                       (every ``data_ptr()`` is 0 on ``meta``); host
                       (CPU) storages are not device memory and are left
                       out.

There is nothing like ``hlo_cost._trip_count`` here: an eager loop runs
every iteration (microbatches, layers and query chunks alike), so every
op is logged as often as it runs and no count has to be recovered.

Each log entry is ``[op, module, args, results, live]``: the op's name,
the ``nn.Module`` path that issued it (`` (backward)`` when the autograd
engine ran it), its tensor arguments as ``[shape, dtype, written]``, its
tensor results as ``[shape, dtype, aliased]`` (aliased: the result's
storage is an argument's) and the live device bytes after it returned.
:func:`cost_log` recomputes an :class:`OpCost` from a log alone, which is
what ``launch.recost`` does with the archived logs.
"""

from __future__ import annotations

import functools
import weakref
from collections import defaultdict
from dataclasses import dataclass, field

import torch
from torch import nn
from torch.nn.modules.module import (register_module_forward_hook,
                                     register_module_forward_pre_hook)
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["OpCost", "OpCounter", "op_cost", "cost_log", "top_costs",
           "COLLECTIVES"]

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# matrix products: the index of the left operand among the tensor args
_MATMUL = {"mm": 0, "bmm": 0, "mv": 0, "dot": 0, "vdot": 0,
           "addmm": 1, "baddbmm": 1, "addmv": 1}
# allocation and metadata ops: no traffic
_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "detach", "alias", "lift_fresh",
         "record_stream", "wait_tensor", "_local_scalar_dense"}
# c10d ops: kind, and the positions of the arguments they write
_C10D = {
    "allreduce_": ("all-reduce", (0,)),
    "all_reduce": ("all-reduce", ()), "all_reduce_": ("all-reduce", (0,)),
    "allgather_": ("all-gather", (0,)),
    "_allgather_base_": ("all-gather", (0,)),
    "allgather_coalesced_": ("all-gather", (0,)),
    "allgather_into_tensor_coalesced_": ("all-gather", (0,)),
    "all_gather_into_tensor": ("all-gather", ()),
    "all_gather_into_tensor_out": ("all-gather", (0,)),
    "reduce_scatter_": ("reduce-scatter", (0,)),
    "_reduce_scatter_base_": ("reduce-scatter", (0,)),
    "reduce_scatter_tensor": ("reduce-scatter", ()),
    "alltoall_": ("all-to-all", (0,)),
    "alltoall_base_": ("all-to-all", (0,)),
    "all_to_all_single": ("all-to-all", ()),
    "send": ("collective-permute", ()),
    "recv_": ("collective-permute", (0,)),
    "broadcast_": ("broadcast", (0,)),
}
_COLL_NS = ("c10d", "_c10d_functional")

_DT = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16",
       torch.float64: "f64", torch.int8: "s8", torch.uint8: "u8",
       torch.int16: "s16", torch.int32: "s32", torch.int64: "s64",
       torch.bool: "pred", torch.uint32: "u32", torch.complex64: "c64"}
_BYTES = {"f32": 4, "bf16": 2, "f16": 2, "f64": 8, "s8": 1, "u8": 1,
          "s16": 2, "s32": 4, "s64": 8, "pred": 1, "u32": 4, "c64": 8}


@dataclass
class OpCost:
    flops: float = 0.0
    bytes: float = 0.0
    collectives: dict = field(
        default_factory=lambda: dict.fromkeys(COLLECTIVES, 0.0))
    peak_bytes: float = 0.0

    @property
    def collective_total(self) -> float:
        return sum(self.collectives.values())


def _tensors(x):
    """The tensors of one op argument (a tensor, or nested lists of them)."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)


def _walk(tree):
    """The tensors and modules reachable from a step's inputs through
    dicts, lists, tuples and named tuples."""
    if isinstance(tree, (torch.Tensor, nn.Module)):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _walk(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _walk(v)


def _leaves(tree):
    """Every tensor reachable from a step's inputs, a module's parameters
    and buffers included."""
    for x in _walk(tree):
        if isinstance(x, nn.Module):
            yield from x.parameters()
            yield from x.buffers()
        else:
            yield x


def _dtype(t: torch.Tensor) -> str:
    return _DT.get(t.dtype) or str(t.dtype).removeprefix("torch.")


def _nbytes(shape, dt: str) -> int:
    n = _BYTES.get(dt) or torch.empty(
        (), dtype=getattr(torch, dt)).element_size()
    for d in shape:
        n *= d
    return n


class _ModulePath:
    """The ``nn.Module`` path an op runs under.  Forward: the innermost
    module whose forward is running, named by its path in the input
    models.  Backward: the module that built the autograd node being run;
    a module's forward stamps the nodes it created (those between its
    inputs and its outputs) with its path.  Only names are kept: no hook
    holds a tensor, so the counted peak is the program's own."""

    def __init__(self, roots):
        self._names = {id(m): n or type(r).__name__
                       for r in roots for n, m in r.named_modules()}
        self._stack: list = []
        self._handles: list = []

    def __enter__(self):
        self._handles = [register_module_forward_pre_hook(self._pre),
                         register_module_forward_hook(self._post)]
        return self

    def __exit__(self, *exc):
        for h in self._handles:
            h.remove()

    @staticmethod
    def _backward() -> bool:
        return torch._C._current_graph_task_id() != -1

    def _pre(self, mod, args):
        # a checkpoint's recomputation in the backward may stop midway
        # (raising past its post-hooks): the backward reads node stamps
        if self._backward():
            return
        stop = {id(t.grad_fn) for t in _tensors(args)
                if t.grad_fn is not None}
        self._stack.append((self._names.get(id(mod), type(mod).__name__),
                            stop))

    def _post(self, mod, args, out):
        if self._backward():
            return
        name, stop = self._stack.pop()
        todo = [t.grad_fn for t in _tensors(out)]
        while todo:
            node = todo.pop()
            if node is None or id(node) in stop or "module" in node.metadata:
                continue
            node.metadata["module"] = name
            todo.extend(f for f, _ in node.next_functions)

    def current(self) -> str:
        if not self._backward():
            return self._stack[-1][0] if self._stack else ""
        node = torch._C._current_autograd_node()
        path = "" if node is None else node.metadata.get("module", "")
        return f"{path} (backward)".lstrip()


class OpCounter(TorchDispatchMode):
    """Log every op dispatched inside ``with OpCounter(*inputs) as c:``
    into ``c.log``; ``inputs`` (anything :func:`_walk` reaches) are live
    from the start, and their modules name the module paths."""

    def __init__(self, *inputs):
        super().__init__()
        self.log: list = []
        self.live = 0
        self._storages: dict = {}
        self._modules = _ModulePath(
            [m for m in _walk(inputs) if isinstance(m, nn.Module)])
        for t in _leaves(inputs):
            self._track(t)
        self.log.append(["<inputs>", "", [], [], self.live])

    def _release(self, key, _ref) -> None:
        n, _ = self._storages.pop(key, (0, None))
        self.live -= n

    def _track(self, t: torch.Tensor) -> None:
        if t.device.type == "cpu":
            return
        st = t.untyped_storage()
        key = id(st)
        if key in self._storages:
            return
        n = st.nbytes()
        self._storages[key] = (n, weakref.ref(
            st, functools.partial(self._release, key)))
        self.live += n

    def __enter__(self):
        self._modules.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._modules.__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        ns = func.namespace
        if ns in _COLL_NS:
            written = set(_C10D.get(name, (None, ()))[1])
        else:
            written = {i for i, a in enumerate(func._schema.arguments)
                       if a.alias_info is not None and a.alias_info.is_write}
        arg_rows, seen = [], set()
        pos = list(enumerate(args)) + [
            (i, kwargs[a.name]) for i, a in enumerate(func._schema.arguments)
            if i >= len(args) and a.name in kwargs]
        for i, a in pos:
            for t in _tensors(a):
                self._track(t)
                seen.add(id(t.untyped_storage()))
                arg_rows.append([list(t.shape), _dtype(t), int(i in written)])
        res_rows = []
        for t in _tensors(out if isinstance(out, (list, tuple)) else (out,)):
            aliased = id(t.untyped_storage()) in seen
            self._track(t)
            res_rows.append([list(t.shape), _dtype(t), int(aliased)])
        op = f"{ns}.{name}" + (":view" if func.is_view else "")
        self.log.append([op, self._modules.current(), arg_rows, res_rows,
                         self.live])
        return out


def _entry_cost(entry) -> tuple[float, float, str | None, float]:
    """(flops, bytes, collective kind or None, collective bytes) of one
    log entry."""
    op, _, args, res, _ = entry
    if op.startswith("<"):
        return 0.0, 0.0, None, 0.0
    ns, _, name = op.partition(".")
    name, view, _ = name.partition(":")
    read = sum(_nbytes(s, d) for s, d, w in args if not w)
    wrote = sum(_nbytes(s, d) for s, d, w in args if w)
    fresh = sum(_nbytes(s, d) for s, d, a in res if not a)
    if ns in _COLL_NS and name not in _FREE:
        kind = _C10D.get(name, (name, ()))[0]
        b = max(wrote + fresh, read)
        return 0.0, float(wrote + fresh + read), kind, \
            float(2 * b if kind == "all-reduce" else b)
    flops = 0.0
    if name in _MATMUL and res and len(args) > _MATMUL[name]:
        lhs = args[_MATMUL[name]][0]
        r = 1
        for d in res[0][0]:
            r *= d
        flops = 2.0 * r * (lhs[-1] if lhs else 1)
    if view or name in _FREE or not (args or res):
        return flops, 0.0, None, 0.0
    if res and all(a for _, _, a in res) and not wrote:
        return flops, 0.0, None, 0.0          # a pure alias (_unsafe_view)
    return flops, float(read + wrote + fresh), None, 0.0


def cost_log(log) -> OpCost:
    """The :class:`OpCost` of a log (:class:`OpCounter`'s, or one read
    back from an archive)."""
    out = OpCost()
    for entry in log:
        fl, by, kind, cb = _entry_cost(entry)
        out.flops += fl
        out.bytes += by
        if kind is not None:
            out.collectives[kind] = out.collectives.get(kind, 0.0) + cb
        out.peak_bytes = max(out.peak_bytes, float(entry[4]))
    return out


def op_cost(fn, *args, **kw) -> tuple[OpCost, list]:
    """Run ``fn(*args, **kw)`` under an :class:`OpCounter` (its inputs
    live from the start) and return ``(cost, log)``."""
    with OpCounter(args, kw) as ctr:
        fn(*args, **kw)
    return cost_log(ctr.log), ctr.log


def _shape_text(args) -> str:
    return ",".join(f"{d}{list(s)}" for s, d, _ in args)[:80]


def top_costs(log, k: int = 20) -> dict:
    """Profiling view of a log: the top ``k`` rows by bytes, by flops and
    by collective bytes, each an (op, module path, argument shapes) group
    with its multiplicity (the times it ran)."""
    groups: dict = defaultdict(lambda: [0.0, 0.0, 0.0, 0])
    for entry in log:
        fl, by, kind, cb = _entry_cost(entry)
        g = groups[(entry[0], entry[1], _shape_text(entry[2]))]
        g[0] += by
        g[1] += fl
        g[2] += cb
        g[3] += 1
    rows = [{"bytes": b, "flops": f, "collective_bytes": c, "mult": n,
             "op": op, "module": mod, "shape": shp}
            for (op, mod, shp), (b, f, c, n) in groups.items()]

    def top(key):
        return sorted((r for r in rows if r[key] > 0),
                      key=lambda r: -r[key])[:k]

    return {"by_bytes": top("bytes"), "by_flops": top("flops"),
            "by_collective": top("collective_bytes")}
