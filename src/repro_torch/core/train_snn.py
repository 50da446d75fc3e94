"""Offline SNN training (port of ``repro.core.train_snn``).  The RTL only
infers; its weights arrive trained.  Two routes, both ending in 9-bit
fixed-point codes for the integer engine:

  * surrogate-gradient BPTT (direct SNN training, QAT through fake-quant);
  * ANN→SNN conversion (train a ReLU MLP, Diehl-normalise, quantize).

Every function runs on ``device`` (None = the CUDA card) and draws its
randomness from a ``torch.Generator`` seeded from ``seed``, never from the
global RNG; the batch order and the train-time augmentation come from
numpy generators seeded as the reference seeds them, so those equal the
reference's.  ``fit_or_load`` caches trained weights in the reference's
``.npz`` format (``w{i}`` per layer).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..data import digits
from ..data.pipeline import digit_batches
from ..device import resolve_device
from ..optim import optimizer as opt_mod
from . import conversion, prng, snn

__all__ = ["train_bptt", "train_converted", "fit_or_load", "int_accuracy"]


def _augment(pixels: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Light train-time corruption (random occlusion patches + noise):
    the standard recipe that buys the paper's Fig-8 robustness."""
    x = pixels.reshape(-1, 28, 28).copy()
    n = x.shape[0]
    occ = rng.random(n) < 0.35
    for i in np.where(occ)[0]:
        s = rng.integers(5, 10)
        r0, c0 = rng.integers(0, 28 - s, 2)
        x[i, r0:r0 + s, c0:c0 + s] = 0.0
    x += rng.normal(0, 0.08, x.shape) * (rng.random((n, 1, 1)) < 0.5)
    return np.clip(x, 0, 1).reshape(n, -1).astype(np.float32)


def _generator(seed: int, dev: torch.device) -> torch.Generator:
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return g


def _value_and_grad(loss_fn, params, *args):
    """``(loss, aux, grads)`` of ``loss_fn(params, *args)``, ``grads`` a
    tree shaped as ``params``."""
    p = opt_mod.tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss, aux = loss_fn(p, *args)
    grads = iter(torch.autograd.grad(loss, opt_mod.tree_leaves(p)))
    return loss, aux, opt_mod.tree_map(lambda _: next(grads), p)


def _batch(b: dict, px: np.ndarray, dev: torch.device):
    return (torch.from_numpy(px).to(dev),
            torch.from_numpy(b["labels"]).to(dev, torch.int64))


def train_bptt(cfg: snn.SNNConfig, ds: digits.DigitDataset, *,
               steps: int = 1500, batch: int = 128, lr: float = 2e-3,
               seed: int = 0, log_every: int = 0, augment: bool = True,
               device: str | torch.device | None = None):
    """Surrogate-gradient BPTT with QAT (AdamW on a cosine schedule,
    global-norm clip 1.0).  Returns float params on ``device``."""
    dev = resolve_device(device)
    gen = _generator(seed, dev)
    params = snn.snn_init(gen, cfg, device=dev)
    opt = opt_mod.adamw(opt_mod.cosine_schedule(lr, steps), weight_decay=1e-4)
    state = opt.init(params)
    aug_rng = np.random.default_rng(seed + 1)
    it = digit_batches(ds.x_train, ds.y_train, batch, seed=seed)
    for i in range(steps):
        b = next(it)
        px = _augment(b["pixels"], aug_rng) if augment else b["pixels"]
        _, aux, grads = _value_and_grad(snn.snn_loss, params,
                                        *_batch(b, px, dev), gen, cfg)
        with torch.no_grad():
            grads, _ = opt_mod.clip_by_global_norm(grads, 1.0)
            updates, state = opt.update(grads, state, params)
            params = opt_mod.apply_updates(params, updates)
        if log_every and (i + 1) % log_every == 0:
            print(f"  bptt step {i+1}: loss {float(aux['loss']):.4f} "
                  f"acc {float(aux['acc']):.3f}")
    return params


def train_converted(cfg: snn.SNNConfig, ds: digits.DigitDataset, *,
                    steps: int = 1500, batch: int = 128, lr: float = 2e-3,
                    seed: int = 0,
                    device: str | torch.device | None = None):
    """ANN→SNN route: ReLU MLP (AdamW, cosine schedule) + Diehl
    normalisation on the first 512 training images.  Returns float SNN
    params on ``device``."""
    dev = resolve_device(device)
    params = conversion.ann_init(_generator(seed, dev), cfg.layer_sizes,
                                 device=dev)
    opt = opt_mod.adamw(opt_mod.cosine_schedule(lr, steps), weight_decay=1e-4)
    state = opt.init(params)
    it = digit_batches(ds.x_train, ds.y_train, batch, seed=seed)
    for _ in range(steps):
        b = next(it)
        _, _, grads = _value_and_grad(conversion.ann_loss, params,
                                      *_batch(b, b["pixels"], dev))
        with torch.no_grad():
            updates, state = opt.update(grads, state, params)
            params = opt_mod.apply_updates(params, updates)
    calib = torch.from_numpy(ds.x_train[:512]).to(dev)
    return conversion.convert_ann_to_snn(params, calib)


def int_accuracy(params_q: dict, cfg: snn.SNNConfig, x: np.ndarray,
                 y: np.ndarray, *, num_steps: int | None = None,
                 seed: int = 1234, batch: int = 500,
                 device: str | torch.device | None = None):
    """Accuracy of the bit-exact integer engine (``snn_apply_int`` with the
    config's backend: on the card ``auto`` is the resident stack kernel)
    on ``device``, where ``params_q`` must lie.  Batch ``i`` is seeded with
    ``seed + i`` as in the reference.  Returns ``(acc, {"adds_per_img"})``.
    """
    dev = resolve_device(device)
    if num_steps is not None:
        cfg = dataclasses.replace(cfg, num_steps=num_steps)
    preds, adds = [], []
    for i in range(0, len(y), batch):
        px = torch.from_numpy((x[i:i + batch] * 255).astype(np.uint8)).to(dev)
        st = prng.seed_state(seed + i, tuple(px.shape), device=dev)
        out = snn.snn_apply_int(params_q, px, st, cfg)
        preds.append(out["pred"].cpu().numpy())
        adds.append(out["active_adds"].sum(0).cpu().numpy())
    pred = np.concatenate(preds)
    acc = float((pred == y[:len(pred)]).mean())
    return acc, {"adds_per_img": float(np.concatenate(adds).mean())}


def fit_or_load(cfg: snn.SNNConfig | None = None, *, route: str = "bptt",
                cache: str = "results/torch/snn_weights.npz",
                steps: int = 1500, seed: int = 0, force: bool = False,
                device: str | torch.device | None = None):
    """Train (or load cached) paper-topology weights on ``device``; returns
    ``(float_params, quantized_params, dataset)``.  The cache is the
    reference's format, so either package reads the other's."""
    from ..configs.snn_mnist import SNN_CONFIG
    cfg = cfg or SNN_CONFIG
    dev = resolve_device(device)
    ds = digits.make_dataset(seed=0)
    if os.path.exists(cache) and not force:
        z = np.load(cache)
        params = {"layers": [
            {"w": torch.from_numpy(z[f"w{i}"].astype(np.float32)).to(dev)}
            for i in range(len(z.files))]}
    else:
        if route == "convert":
            params = train_converted(cfg, ds, steps=steps, seed=seed,
                                     device=dev)
        else:
            params = train_bptt(cfg, ds, steps=steps, seed=seed, device=dev)
        os.makedirs(os.path.dirname(cache) or ".", exist_ok=True)
        np.savez(cache, **{f"w{i}": l["w"].cpu().numpy()
                           for i, l in enumerate(params["layers"])})
    return params, snn.quantize_params(params, cfg), ds
