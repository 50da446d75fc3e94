"""ANN→SNN conversion (the paper's implied offline training flow; port of
``repro.core.conversion``).

The RTL performs inference only; weights arrive trained.  The classic route
for rate-coded SNNs (Diehl et al. 2015): train a ReLU ANN, then reuse its
weights in the LIF network after *data-based normalisation* — each layer
rescaled so that its high-percentile pre-activation maps onto the firing
threshold, which makes LIF firing rates approximate ReLU activations.
The other route, surrogate-gradient BPTT, is ``core.snn``'s.
"""

from __future__ import annotations

import torch

from ..device import resolve_device

__all__ = ["ann_init", "ann_apply", "ann_loss", "convert_ann_to_snn"]


def ann_init(generator: torch.Generator, sizes: tuple[int, ...] = (784, 10),
             *, device: str | torch.device | None = None) -> dict:
    """He-normal weights drawn from ``generator`` on its own device, zero
    biases, all float32 on ``device`` (None = the card)."""
    dev = resolve_device(device)
    layers = []
    for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
        w = torch.randn((fan_in, fan_out), generator=generator,
                        dtype=torch.float32, device=generator.device)
        layers.append({"w": (w * (2.0 / fan_in) ** 0.5).to(dev),
                       "b": torch.zeros(fan_out, dtype=torch.float32,
                                        device=dev)})
    return {"layers": layers}


def ann_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    """ReLU MLP; returns logits.  ``x``: (batch, n_in) in [0, 1]."""
    h = x
    n = len(params["layers"])
    for i, layer in enumerate(params["layers"]):
        h = h @ layer["w"] + layer["b"]
        if i < n - 1:
            h = torch.relu(h)
    return h


def ann_loss(params: dict, x: torch.Tensor, labels: torch.Tensor):
    logits = ann_apply(params, x)
    logp = torch.log_softmax(logits, dim=-1)
    labels = labels.to(torch.int64)
    nll = -torch.gather(logp, -1, labels[:, None]).mean()
    acc = (torch.argmax(logits, -1) == labels).to(torch.float32).mean()
    return nll, {"loss": nll.detach(), "acc": acc}


@torch.no_grad()
def convert_ann_to_snn(params: dict, calib_x: torch.Tensor,
                       percentile: float = 99.9) -> dict:
    """Data-based weight normalisation (Diehl et al. 2015).

    Rescales each layer by the p-th percentile (linear interpolation, as
    ``jnp.percentile``) of its pre-activations on a calibration batch so
    that LIF rates (∈ [0, 1]) track ReLU activations.  Biases are dropped
    (the RTL has none): they are absorbed into the effective threshold by
    the normalisation.

    Returns float SNN params ``{"layers": [{"w": ...}]}`` for ``core.snn``
    (threshold 1.0 semantics), ready for ``quantize_params``.
    """
    h = calib_x
    out_layers = []
    prev_scale = 1.0
    n = len(params["layers"])
    for i, layer in enumerate(params["layers"]):
        pre = h @ layer["w"] + layer["b"]
        lam = torch.quantile(pre.flatten(), percentile / 100.0,
                             interpolation="linear")
        lam = torch.clamp(lam, min=1e-6)
        # inputs were scaled by 1/prev_scale; outputs must cross 1.0 when
        # the ANN pre-activation crosses lam
        out_layers.append({"w": layer["w"] * (prev_scale / lam)})
        if i < n - 1:
            h = torch.relu(pre)
        prev_scale = lam
    return {"layers": out_layers}
