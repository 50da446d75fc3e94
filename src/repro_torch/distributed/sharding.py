"""Device meshes for the serving engines (port of ``repro.distributed.
sharding``' ``make_device_mesh`` and ``make_2d_device_mesh``).

A :class:`DeviceMesh` is a grid of ``torch.device``s with named axes.  The
serving engine shards its lane tile over the data axis and each layer's
output columns over the model axis.  The grid may name one device more
than once: on one card, ``make_2d_device_mesh(1, 4, devices=["cuda:0"] *
4)`` runs four model shards and their spike exchange on that card; where
the grid names several cards, the shards sit on them and the exchange is
a peer copy.  Nothing here starts a process group: every shard is driven
from the calling process.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["DeviceMesh", "make_device_mesh", "make_2d_device_mesh"]


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
