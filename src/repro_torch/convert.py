"""Parameters of the reference package → parameters of the port.

``repro.core.snn.quantize_params`` returns
``{"layers": [{"w_q": int16 (n_in, n_out), "scale": float}]}``.  Handed
over as numpy arrays (``np.asarray`` of each leaf), the same codes become
the port's parameters, so both packages compute the same integers
(:func:`params_from_jax`).  Float params — the SNN's ``{"w"}`` and the
ANN's ``{"w", "b"}`` layers — cross the same way
(:func:`float_params_from_jax`).
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device

__all__ = ["params_from_jax", "float_params_from_jax"]


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


def float_params_from_jax(params: dict, *,
                          device: str | torch.device | None = None) -> dict:
    """``{"layers": [{"w"[, "b"]}]}`` of numpy leaves (float SNN or ANN
    params) → the same layers as float32 tensors on ``device`` (None = the
    CUDA card)."""
    dev = resolve_device(device)
    return {"layers": [
        {k: torch.from_numpy(np.array(v, dtype=np.float32)).to(dev)
         for k, v in layer.items()}
        for layer in params["layers"]]}
