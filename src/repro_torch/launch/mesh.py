"""Local device meshes for the launchers (port of ``repro.launch.mesh``'s
``make_local_mesh`` and ``mesh_axis_sizes``).

Defined as functions, never module-level constants, so importing this
module touches no device.
"""

from __future__ import annotations

from ..distributed.sharding import DeviceMesh, _visible_cards, \
    make_device_mesh

__all__ = ["make_local_mesh", "mesh_axis_sizes"]


def make_local_mesh(*, devices=None) -> DeviceMesh:
    """Every visible card (or the given ``devices``) as a 1×N
    ("data", "model") mesh; raises where there is no card and no list."""
    pool = _visible_cards() if devices is None else list(devices)
    return make_device_mesh((1, len(pool)), ("data", "model"), devices=pool)


def mesh_axis_sizes(mesh: DeviceMesh) -> dict:
    return dict(zip(mesh.axis_names, mesh.devices.shape))
