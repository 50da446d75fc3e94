"""Parameters of the reference package → parameters of the port.

``repro.core.snn.quantize_params`` returns
``{"layers": [{"w_q": int16 (n_in, n_out), "scale": float}]}``.  Handed
over as numpy arrays (``np.asarray`` of each leaf), the same codes become
the port's parameters, so both packages compute the same integers
(:func:`params_from_jax`).  Float params — the SNN's ``{"w"}`` and the
ANN's ``{"w", "b"}`` layers — cross the same way
(:func:`float_params_from_jax`).

The LM's ``lm_init`` tree (numpy leaves; decoder layers stacked in blocks
on a leading axis, the whisper encoder's layers stacked likewise) becomes
the port's :class:`~repro_torch.models.Transformer`
(:func:`lm_params_from_jax`), and the port's per-layer cache goes back to
the JAX package's stacked layout for comparison
(:func:`lm_cache_to_jax_layout`).
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device

__all__ = ["params_from_jax", "float_params_from_jax", "lm_params_from_jax",
           "lm_cache_to_jax_layout"]


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


def _flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def lm_params_from_jax(params: dict, cfg, *,
                       device: str | torch.device | None = None):
    """The JAX package's ``lm_init(key, cfg)`` tree, as numpy leaves → the
    port's ``Transformer`` on ``device`` (None = the CUDA card).

    Layer ``b·bs + j`` takes ``blocks["p{j}"][...][b]`` (``bs`` the plan's
    block size); encoder layer ``i`` takes ``encoder["layers"][...][i]``;
    ``embed``, ``lm_head``, ``pos_embed`` and the final norms cross as they
    are.  Every parameter of the port must be given, and nothing more."""
    from .models.transformer import Transformer, block_size, layer_plan

    dev = resolve_device(device)
    bs = block_size(layer_plan(cfg))
    state = {}
    for key, leaf in _flatten({k: v for k, v in params.items()
                               if k not in ("blocks", "encoder")}).items():
        state[key] = leaf
    for j_key, block in params["blocks"].items():
        j = int(j_key[1:])
        for path, leaf in _flatten(block).items():
            for b in range(leaf.shape[0]):
                state[f"layers.{b * bs + j}.{path}"] = leaf[b]
    if "encoder" in params:
        enc = params["encoder"]
        for path, leaf in _flatten(enc["layers"]).items():
            for i in range(leaf.shape[0]):
                state[f"encoder.layers.{i}.{path}"] = leaf[i]
        for path, leaf in _flatten(enc["final_norm"]).items():
            state[f"encoder.final_norm.{path}"] = leaf
    with torch.device("meta"):
        model = Transformer(cfg, generator=None)
    model.load_state_dict(
        {k: torch.from_numpy(np.array(v, dtype=np.float32))
         for k, v in state.items()}, strict=True, assign=True)
    return model.to(dev)


def lm_cache_to_jax_layout(cache: list, cfg) -> dict:
    """The port's cache (one ``{"self"[, "cross"]}`` entry per layer) → the
    JAX package's layout, as numpy: ``{"p{j}": {"self": {field: leaf},
    ...}}`` with layer ``b·bs + j`` at index ``b`` of each leaf."""
    from .models.transformer import block_size, layer_plan

    bs = block_size(layer_plan(cfg))
    out = {}
    for j in range(bs):
        layers = cache[j::bs]
        out[f"p{j}"] = {
            part: {f: np.stack([_to_numpy(getattr(c[part], f))
                                for c in layers])
                   for f in layers[0][part]._fields}
            for part in layers[0]}
    return out


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy()
