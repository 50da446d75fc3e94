"""Device meshes for the launchers and the dry-run (port of
``repro.launch.mesh``).

Defined as functions, never module-level constants, so importing this
module touches no device.

The production meshes are the JAX package's target hardware, TPU v5e
pods of 256 chips in a 16×16 torus:
  single-pod:  (16, 16)       axes ("data", "model")
  multi-pod:   (2, 16, 16)    axes ("pod", "data", "model")
They describe that target, not a layout of H100 cards.
"""

from __future__ import annotations

import math

import torch

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


def make_local_mesh(*, devices=None) -> DeviceMesh:
    """Every visible card (or the given ``devices``) as a 1×N
    ("data", "model") mesh; raises where there is no card and no list."""
    pool = _visible_cards() if devices is None else list(devices)
    return make_device_mesh((1, len(pool)), ("data", "model"), devices=pool)


def mesh_axis_sizes(mesh: DeviceMesh) -> dict:
    return dict(zip(mesh.axis_names, mesh.devices.shape))
