"""Procedural 28×28 digit dataset — an offline MNIST stand-in.

This container has no network access and no bundled MNIST, so the paper's
static-image workload is reproduced with a procedural renderer: each digit
class 0–9 is a stroke skeleton (polylines + elliptical arcs in a unit box),
rasterised with a soft-brush distance field and randomly perturbed per
sample (affine jitter, stroke width, intensity, pixel noise).  The task is
the same 10-class 784-input classification problem at a comparable
difficulty, and the loader transparently prefers a real ``mnist.npz`` if one
is present (``REPRO_MNIST_PATH``), making real MNIST a drop-in.

Also provides the paper's Fig.-8 corruption suite: rotation, pixel shift,
Gaussian noise, occlusion.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass

import numpy as np

__all__ = [
    "DigitDataset", "make_dataset", "corrupt",
    "rotate_images", "shift_images", "noise_images", "occlude_images",
]

IMG = 28


def _arc(cx, cy, rx, ry, a0, a1, n=40):
    t = np.linspace(a0, a1, n)
    return np.stack([cx + rx * np.cos(t), cy + ry * np.sin(t)], axis=1)


def _line(x0, y0, x1, y1, n=24):
    t = np.linspace(0.0, 1.0, n)
    return np.stack([x0 + (x1 - x0) * t, y0 + (y1 - y0) * t], axis=1)


def _skeleton(digit: int) -> np.ndarray:
    """Stroke sample points for one digit, in [0,1]² (y down)."""
    P = []
    if digit == 0:
        P.append(_arc(0.5, 0.5, 0.26, 0.38, 0, 2 * math.pi, 80))
    elif digit == 1:
        P.append(_line(0.52, 0.12, 0.52, 0.88))
        P.append(_line(0.38, 0.26, 0.52, 0.12))
    elif digit == 2:
        P.append(_arc(0.5, 0.32, 0.25, 0.2, math.pi, 2.25 * math.pi, 40))
        P.append(_line(0.72, 0.42, 0.28, 0.85))
        P.append(_line(0.28, 0.85, 0.75, 0.85))
    elif digit == 3:
        P.append(_arc(0.47, 0.3, 0.24, 0.19, 0.75 * math.pi, 2.4 * math.pi, 40))
        P.append(_arc(0.47, 0.68, 0.26, 0.21, 1.6 * math.pi, 3.2 * math.pi, 40))
    elif digit == 4:
        P.append(_line(0.62, 0.1, 0.25, 0.62))
        P.append(_line(0.25, 0.62, 0.78, 0.62))
        P.append(_line(0.62, 0.1, 0.62, 0.9))
    elif digit == 5:
        P.append(_line(0.7, 0.12, 0.32, 0.12))
        P.append(_line(0.32, 0.12, 0.3, 0.45))
        P.append(_arc(0.48, 0.64, 0.24, 0.23, 1.25 * math.pi, 2.85 * math.pi, 48))
    elif digit == 6:
        P.append(_arc(0.52, 0.3, 0.3, 0.35, 0.9 * math.pi, 1.6 * math.pi, 30))
        P.append(_arc(0.5, 0.66, 0.22, 0.2, 0, 2 * math.pi, 56))
    elif digit == 7:
        P.append(_line(0.25, 0.13, 0.75, 0.13))
        P.append(_line(0.75, 0.13, 0.42, 0.88))
    elif digit == 8:
        P.append(_arc(0.5, 0.3, 0.2, 0.17, 0, 2 * math.pi, 48))
        P.append(_arc(0.5, 0.68, 0.24, 0.2, 0, 2 * math.pi, 56))
    elif digit == 9:
        P.append(_arc(0.5, 0.32, 0.22, 0.2, 0, 2 * math.pi, 56))
        P.append(_arc(0.45, 0.45, 0.28, 0.42, -0.15 * math.pi, 0.45 * math.pi, 28))
    else:
        raise ValueError(digit)
    return np.concatenate(P, axis=0)


_SKELETONS = [_skeleton(d) for d in range(10)]


def _render(points: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Rasterise jittered stroke points to a 28×28 float image in [0,1]."""
    # Random affine: rotation, anisotropic scale, shear, translation.
    # Jitter magnitudes tuned so a linear probe scores ≈92% (MNIST-like
    # difficulty), keeping accuracy numbers comparable to the paper's.
    ang = rng.uniform(-0.24, 0.24)
    sx, sy = rng.uniform(0.80, 1.15, 2)
    shear = rng.uniform(-0.22, 0.22)
    ca, sa = math.cos(ang), math.sin(ang)
    A = np.array([[ca * sx, -sa * sy + shear], [sa * sx, ca * sy]])
    c = points.mean(0)
    # Per-point wobble deforms the stroke itself (handwriting variation).
    wob = rng.normal(0, 0.005, points.shape).cumsum(0)
    wob -= wob.mean(0)
    pts = (points + wob - c) @ A.T + c + rng.uniform(-0.07, 0.07, 2)

    # Distance field to stroke samples.
    gy, gx = np.mgrid[0:IMG, 0:IMG]
    grid = np.stack([gx, gy], axis=-1).reshape(-1, 2) / (IMG - 1)
    d2 = ((grid[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    dmin = np.sqrt(d2.min(axis=1))
    width = rng.uniform(0.026, 0.055)
    img = np.clip(1.25 - dmin / width, 0.0, 1.0) ** 1.5
    img = img.reshape(IMG, IMG)
    img *= rng.uniform(0.7, 1.0)                        # intensity jitter
    img += rng.normal(0, 0.05, img.shape)               # sensor noise
    return np.clip(img, 0.0, 1.0).astype(np.float32)


@dataclass(frozen=True)
class DigitDataset:
    x_train: np.ndarray  # (n, 784) float32 in [0,1]
    y_train: np.ndarray  # (n,) int32
    x_test: np.ndarray
    y_test: np.ndarray

    @property
    def n_train(self) -> int:
        return self.x_train.shape[0]


def make_dataset(n_train: int = 6000, n_test: int = 1000,
                 seed: int = 0) -> DigitDataset:
    """Build the dataset (or load real MNIST from REPRO_MNIST_PATH if set)."""
    path = os.environ.get("REPRO_MNIST_PATH", "")
    if path and os.path.exists(path):
        z = np.load(path)
        return DigitDataset(
            x_train=z["x_train"].reshape(-1, IMG * IMG).astype(np.float32) / 255.0,
            y_train=z["y_train"].astype(np.int32),
            x_test=z["x_test"].reshape(-1, IMG * IMG).astype(np.float32) / 255.0,
            y_test=z["y_test"].astype(np.int32),
        )

    rng = np.random.default_rng(seed)
    n = n_train + n_test
    labels = rng.integers(0, 10, n).astype(np.int32)
    imgs = np.empty((n, IMG * IMG), np.float32)
    for i, lab in enumerate(labels):
        imgs[i] = _render(_SKELETONS[lab], rng).reshape(-1)
    return DigitDataset(
        x_train=imgs[:n_train], y_train=labels[:n_train],
        x_test=imgs[n_train:], y_test=labels[n_train:],
    )


# ---------------------------------------------------------------------------
# Fig.-8 corruption suite
# ---------------------------------------------------------------------------

def rotate_images(x: np.ndarray, degrees: float = 15.0) -> np.ndarray:
    """Nearest-neighbour rotation about the image centre."""
    ang = math.radians(degrees)
    ca, sa = math.cos(ang), math.sin(ang)
    imgs = x.reshape(-1, IMG, IMG)
    gy, gx = np.mgrid[0:IMG, 0:IMG]
    cy = cx = (IMG - 1) / 2.0
    sx = ca * (gx - cx) + sa * (gy - cy) + cx
    sy = -sa * (gx - cx) + ca * (gy - cy) + cy
    sxi = np.clip(np.round(sx).astype(int), 0, IMG - 1)
    syi = np.clip(np.round(sy).astype(int), 0, IMG - 1)
    valid = (sx >= 0) & (sx <= IMG - 1) & (sy >= 0) & (sy <= IMG - 1)
    out = imgs[:, syi, sxi] * valid[None]
    return out.reshape(x.shape).astype(np.float32)


def shift_images(x: np.ndarray, frac: float = 0.2) -> np.ndarray:
    """Shift right/down by frac of the image size (zero fill)."""
    s = int(round(IMG * frac))
    imgs = x.reshape(-1, IMG, IMG)
    out = np.zeros_like(imgs)
    if s < IMG:
        out[:, s:, s:] = imgs[:, : IMG - s, : IMG - s]
    return out.reshape(x.shape)


def noise_images(x: np.ndarray, sigma: float = 0.3, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.clip(x + rng.normal(0, sigma, x.shape), 0, 1).astype(np.float32)


def occlude_images(x: np.ndarray, size: int = 9, seed: int = 0) -> np.ndarray:
    """Black square patch at a random location per image."""
    rng = np.random.default_rng(seed)
    imgs = x.reshape(-1, IMG, IMG).copy()
    for i in range(imgs.shape[0]):
        r0 = rng.integers(0, IMG - size)
        c0 = rng.integers(0, IMG - size)
        imgs[i, r0:r0 + size, c0:c0 + size] = 0.0
    return imgs.reshape(x.shape)


def corrupt(x: np.ndarray, kind: str, seed: int = 0) -> np.ndarray:
    if kind == "rotation":
        return rotate_images(x, 15.0)
    if kind == "shift":
        return shift_images(x, 0.2)
    if kind == "noise":
        return noise_images(x, 0.3, seed)
    if kind == "occlusion":
        return occlude_images(x, 9, seed)
    if kind == "clean":
        return x
    raise ValueError(kind)
