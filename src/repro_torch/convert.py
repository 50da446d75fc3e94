"""Parameters of the reference package → parameters of the port.

``repro.core.snn.quantize_params`` returns
``{"layers": [{"w_q": int16 (n_in, n_out), "scale": float}]}``.  Handed
over as numpy arrays (``np.asarray`` of each leaf), the same codes become
the port's parameters, so both packages compute the same integers.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device

__all__ = ["params_from_jax"]


def params_from_jax(params_q: dict, *,
                    device: str | torch.device | None = None) -> dict:
    """``{"layers": [{"w_q", "scale"}]}`` of numpy leaves → the port's
    parameters: int16 weight codes on ``device`` (None = the CUDA card) and
    float scales."""
    dev = resolve_device(device)
    layers = []
    for layer in params_q["layers"]:
        w = np.asarray(layer["w_q"])
        if not np.issubdtype(w.dtype, np.integer):
            raise TypeError(f"w_q must hold integer codes, got {w.dtype}")
        layers.append({"w_q": torch.from_numpy(w.astype(np.int16)).to(dev),
                       "scale": float(np.asarray(layer["scale"]))})
    return {"layers": layers}
