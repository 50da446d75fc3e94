"""Sharded, atomic, async checkpointing with elastic restore (port of
``repro.checkpoint.manager``, the same on-disk format).

Layout of one checkpoint (``<dir>/step_<N>/``):

    manifest.json          # leaves: shape, dtype, shard index ranges,
                           # crc32 per file; the tree's structure
    <leaf-id>.s<k>.npy     # one file per (leaf, shard)

  * **Leaf ids** are the JAX package's: dotted dict keys and namedtuple
    fields (``params.blocks.p0.attn.wq``, ``opt_state.mu...``, ``step``).
    A port ``train.TrainState`` is written in the JAX package's layout
    (``convert.train_state_to_jax``: layers stacked on a leading axis,
    ``step`` an int32 of shape ()) and read back from it, so either
    package restores the other's checkpoints.
  * **Atomic commit**: writes go to ``step_<N>.tmp``; the manifest is
    fsync'd and the directory renamed only after every file lands.  A
    crash mid-save leaves the previous checkpoint intact.
  * **Elastic restore**: shards record their logical index ranges, and a
    leaf is assembled from whichever files cover it, so a checkpoint
    written by several shards (the JAX package on a mesh, or the port's
    ranks) restores whole in one process; ``shardings=(mesh, specs)``
    then places it on another partition.  One process writes one shard
    per leaf; a placed state (DTensors over a process mesh) is written by
    every rank, each its own shards with their logical index ranges
    (replicated shards once), and rank 0 commits the manifest.
  * **Async**: ``save`` snapshots tensors to host memory synchronously and
    does file IO on one worker thread; ``wait()`` joins.  Integrity is
    checked on restore via crc32.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from ..distributed.sharding import is_placed

__all__ = ["CheckpointManager", "save_pytree", "restore_pytree",
           "latest_step"]


def _items(tree, path=()):
    """``(path, leaf)`` pairs: dict keys, namedtuple fields and sequence
    indices are nodes, None holds nothing, anything else is a leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _items(v, path + (k,))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for k in tree._fields
                for x in _items(getattr(tree, k), path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _items(v, path + (i,))]
    return [(path, tree)]


def _rebuild(tree, leaves):
    """``tree``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(getattr(tree, k), leaves)
                            for k in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves) for v in tree)
    return next(leaves)


def _leaf_id(path) -> str:
    return ".".join(str(p) for p in path) or "root"


def _host(x) -> np.ndarray:
    """``x`` on the host; a tensor is copied (the train step changes its
    parameters and state in place next)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().copy()
    return np.asarray(x)


def _is_train_state(tree) -> bool:
    from ..train.step import TrainState
    return isinstance(tree, TrainState)


def _jax_layout(tree):
    if _is_train_state(tree):
        from ..convert import train_state_to_jax
        return train_state_to_jax(tree, tree.params.cfg)
    return tree


class _Shard:
    """One rank's piece of a placed leaf: its local data, its logical
    index ranges and shard number, and whether this rank writes it (the
    first rank of each group that holds a replica)."""

    def __init__(self, ts: list, stacked: bool):
        from torch.distributed.tensor import Shard

        t = ts[0]
        mesh, pl = t.device_mesh, t.placements
        local = [x.to_local().detach().cpu().numpy() for x in ts]
        self.data = np.stack(local) if stacked else local[0].copy()
        glob = list(t.shape)
        idx, num, write = [], 0, True
        for d, n in enumerate(glob):
            lin, ways = 0, 1
            for i, p in enumerate(pl):
                if isinstance(p, Shard) and p.dim == d:
                    lin = lin * mesh.size(i) + mesh.get_local_rank(i)
                    ways *= mesh.size(i)
            size = n // ways
            idx.append([lin * size, (lin + 1) * size])
            num = num * ways + lin
        for i, p in enumerate(pl):
            if not isinstance(p, Shard) and mesh.get_local_rank(i) != 0:
                write = False
        if stacked:
            glob, idx = [len(ts)] + glob, [[0, len(ts)]] + idx
        self.shape, self.index, self.num, self.write = glob, idx, num, write

    @classmethod
    def whole(cls, a: np.ndarray, write: bool) -> "_Shard":
        """An unsharded leaf (the step counter), written by ``write``."""
        leaf = cls.__new__(cls)
        leaf.data, leaf.shape, leaf.num, leaf.write = a, list(a.shape), 0, \
            write
        leaf.index = [[0, n] for n in a.shape]
        return leaf


def _save_placed(state, directory: str) -> None:
    """Every rank writes its shards of a placed ``TrainState``; rank 0
    gathers their index ranges and checksums, writes the manifest and
    commits."""
    from ..convert import _train_state_tree

    rank = dist.get_rank()
    tmp = directory + ".tmp"
    if rank == 0:
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp, exist_ok=True)
    dist.barrier()
    tree = _train_state_tree(state, state.params.cfg, _Shard)
    meta, order = {}, []
    for path, leaf in _items(tree):
        lid = _leaf_id(path)
        order.append(lid)
        if not isinstance(leaf, _Shard):        # the step: rank 0 writes
            leaf = _Shard.whole(np.asarray(leaf), rank == 0)
        entry = {"shape": list(leaf.shape), "dtype": str(leaf.data.dtype),
                 "shards": []}
        if leaf.write:
            fname = f"{lid}.s{leaf.num}.npy"
            np.save(os.path.join(tmp, fname), leaf.data)
            with open(os.path.join(tmp, fname), "rb") as f:
                crc = zlib.crc32(f.read())
            entry["shards"].append({"file": fname, "index": leaf.index,
                                    "crc32": crc})
        meta[lid] = entry
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, meta)
    if rank == 0:
        leaves = {lid: dict(every[0][lid], shards=[
            sh for m in every for sh in m[lid]["shards"]]) for lid in order}
        manifest = {"leaves": leaves, "treedef": repr(order)}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(directory):
            shutil.rmtree(directory)
        os.rename(tmp, directory)
    dist.barrier()


def _placed_state(tree) -> bool:
    return _is_train_state(tree) and is_placed(tree.params.embed)


def save_pytree(tree, directory: str) -> None:
    """Synchronous save with atomic rename (every rank calls it for a
    placed ``TrainState``)."""
    if _placed_state(tree):
        return _save_placed(tree, directory)
    tree = _jax_layout(tree)
    tmp = directory + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)

    leaves_meta = {}
    for path, leaf in _items(tree):
        lid = _leaf_id(path)
        data = _host(leaf)
        fname = f"{lid}.s0.npy"
        fpath = os.path.join(tmp, fname)
        np.save(fpath, data)
        with open(fpath, "rb") as f:
            crc = zlib.crc32(f.read())
        leaves_meta[lid] = {
            "shape": list(data.shape), "dtype": str(data.dtype),
            "shards": [{"file": fname,
                        "index": [[0, s] for s in data.shape],
                        "crc32": crc}],
        }

    manifest = {"leaves": leaves_meta,
                "treedef": repr([_leaf_id(p) for p, _ in _items(tree)])}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())

    if os.path.exists(directory):
        shutil.rmtree(directory)
    os.rename(tmp, directory)


def _load_leaf(directory: str, meta: dict) -> np.ndarray:
    """The full logical array of one leaf, assembled from its shard files
    by their index ranges (crc checked)."""
    full = np.zeros(tuple(meta["shape"]), np.dtype(meta["dtype"]))
    for sh in meta["shards"]:
        fpath = os.path.join(directory, sh["file"])
        with open(fpath, "rb") as f:
            if zlib.crc32(f.read()) != sh["crc32"]:
                raise IOError(f"checksum mismatch in {fpath}")
        full[tuple(slice(a, b) for a, b in sh["index"])] = np.load(fpath)
    return full


def restore_pytree(tree_like, directory: str, shardings=None, *,
                   device=None):
    """Restore into the structure of ``tree_like``, each leaf a tensor on
    ``device`` (None = the CUDA card).  A port ``train.TrainState`` is
    read from the JAX package's layout into a new ``TrainState``.

    Every leaf is assembled whole from its shards' logical ranges, however
    many ranks wrote them.  ``shardings=(mesh, specs)`` (a
    ``distributed.sharding.DeviceMesh`` with its process mesh and the
    mesh-axis tuples of ``distributed.partition.to_shardings``) then
    places the result as DTensors on that partition; anything else (the
    reference's shardings) is accepted and means nothing in one process.
    """
    with open(os.path.join(directory, "manifest.json")) as f:
        leaves = json.load(f)["leaves"]
    dev = resolve_device(device)
    if _is_train_state(tree_like):
        from ..convert import _train_state_tree, train_state_from_jax
        # the JAX layout's paths, with no leaf copied to the host
        like = _train_state_tree(tree_like, tree_like.params.cfg,
                                 lambda ts, stacked: 0)
        host = _rebuild(like, iter([_load_leaf(directory, leaves[_leaf_id(p)])
                                    for p, _ in _items(like)]))
        out = train_state_from_jax(host, tree_like.params.cfg, device=dev)
    else:
        out = _rebuild(tree_like, iter([
            torch.from_numpy(_load_leaf(directory, leaves[_leaf_id(p)]))
            .to(dev) for p, _ in _items(tree_like)]))
    if isinstance(shardings, tuple) and len(shardings) == 2 and \
            hasattr(shardings[0], "torch_mesh"):
        from ..distributed.partition import place
        mesh, specs = shardings
        out = place(out, specs, mesh)
    return out


def latest_step(root: str) -> int | None:
    if not os.path.isdir(root):
        return None
    steps = [int(d.split("_", 1)[1]) for d in os.listdir(root)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


class CheckpointManager:
    """Async manager: snapshot to the host synchronously, write on a
    thread."""

    def __init__(self, root: str, *, max_to_keep: int = 3):
        self.root = root
        self.max_to_keep = max_to_keep
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="ckpt")
        self._pending: list[Future] = []
        self._lock = threading.Lock()
        os.makedirs(root, exist_ok=True)

    def _dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step}")

    def save(self, step: int, tree) -> Future:
        if _placed_state(tree):
            # every rank takes part in the commit: synchronous
            fut: Future = Future()
            save_pytree(tree, self._dir(step))
            if dist.get_rank() == 0:
                self._gc()
            fut.set_result(None)
            return fut
        tree = _jax_layout(tree)
        host_tree = _rebuild(tree, iter([_host(x) for _, x in _items(tree)]))

        def work():
            save_pytree(host_tree, self._dir(step))
            self._gc()

        fut = self._pool.submit(work)
        with self._lock:
            self._pending.append(fut)
        return fut

    def wait(self):
        with self._lock:
            pending, self._pending = self._pending, []
        for f in pending:
            f.result()

    def restore(self, tree_like, step: int | None = None, shardings=None,
                *, device=None):
        step = latest_step(self.root) if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        return restore_pytree(tree_like, self._dir(step), shardings,
                              device=device), step

    def _gc(self):
        steps = sorted(
            int(d.split("_", 1)[1]) for d in os.listdir(self.root)
            if d.startswith("step_") and not d.endswith(".tmp"))
        for s in steps[:-self.max_to_keep]:
            shutil.rmtree(self._dir(s), ignore_errors=True)
