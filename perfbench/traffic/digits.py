"""The benchmark's digit images: a frozen copy of the port's procedural
28×28 digit renderer (stroke skeletons, jittered and rasterised with a
soft brush), numpy only, and the pool of images a run draws requests from.

A run renders ``pool`` digits from its seed once, in set-up; request ``i``
of a run shows image ``i mod pool``.  Intensities become uint8 as the
port's training and scoring paths make them (``x · 255`` truncated).
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["render_pool"]

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


def render_pool(seed: int, n: int) -> np.ndarray:
    """``n`` uint8 digit images ``(n, 784)`` of random classes, from
    ``seed``."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, n)
    imgs = np.stack([_render(_SKELETONS[int(c)], rng).reshape(-1)
                     for c in labels])
    return (imgs * 255).astype(np.uint8)
