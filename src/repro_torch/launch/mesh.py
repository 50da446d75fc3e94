"""Device meshes for the launchers and the dry-run (port of
``repro.launch.mesh``).

Defined as functions, never module-level constants, so importing this
module touches no device.

The production meshes are the JAX package's target hardware, TPU v5e
pods of 256 chips in a 16×16 torus:
  single-pod:  (16, 16)       axes ("data", "model")
  multi-pod:   (2, 16, 16)    axes ("pod", "data", "model")
They describe that target, not a layout of H100 cards.

``make_local_mesh`` is the launchers' mesh: under ``torchrun`` one rank
per card (``nccl``) or per CPU process (``gloo``), else the calling
process's devices with no process group.
"""

from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist

from ..distributed.sharding import DeviceMesh, _visible_cards, \
    make_device_mesh

__all__ = ["make_production_mesh", "make_local_mesh", "mesh_axis_sizes"]


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """The JAX package's production mesh over ``torch.device("meta")``
    repeated: its shape and axis names, and no card touched (the torch
    meaning of the JAX dry-run's fake host devices).  The dry-run reads
    its axis sizes; nothing is placed on it."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_device_mesh(shape, axes,
                            devices=[torch.device("meta")] * math.prod(shape))


def make_local_mesh(*, devices=None, device=None) -> DeviceMesh:
    """The launchers' ("data", "model") mesh.

    Under ``torchrun`` (``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` set),
    one rank per device: the process group is started if it is not up
    (``nccl`` on card ``LOCAL_RANK``, ``gloo`` when ``device`` is the CPU)
    and the mesh is 1×world with its process mesh, as JAX's is 1×N.
    Otherwise every visible card (or the given ``devices``) as a 1×N mesh
    with no process group; raises where there is no card and no list.
    """
    if all(k in os.environ for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK")):
        dev = torch.device(device) if device is not None else \
            torch.device("cuda")
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        world = int(os.environ["WORLD_SIZE"])
        if not dist.is_initialized():
            if dev.type == "cuda":
                torch.cuda.set_device(dev)
            dist.init_process_group(
                "nccl" if dev.type == "cuda" else "gloo",
                rank=int(os.environ["RANK"]), world_size=world,
                device_id=dev if dev.type == "cuda" else None)
        shape = (1, world)
        mesh = make_device_mesh(shape, ("data", "model"),
                                devices=[dev] * world)
        if mesh.torch_mesh is None:
            raise RuntimeError(f"a {shape} mesh over {world} ranks")
        return mesh
    pool = _visible_cards() if devices is None else list(devices)
    return make_device_mesh((1, len(pool)), ("data", "model"),
                            devices=pool)


def mesh_axis_sizes(mesh: DeviceMesh) -> dict:
    return dict(zip(mesh.axis_names, mesh.devices.shape))
