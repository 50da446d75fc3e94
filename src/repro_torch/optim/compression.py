"""Gradient compression for cross-pod reduction (port of
``repro.optim.compression``).

At multi-pod scale the pod-to-pod links are the scarcest bandwidth, so the
inter-pod gradient reduction is compressed while the intra-pod one stays
exact:

    q, s    = int8_quantize(g_pod + error_fb)      # one scale per leaf
    q_sum   = all_reduce(q widened to int32, SUM)  # over the pod group
    g_glob  = dequantize(q_sum) / n_pods
    error_fb = g_pod + error_fb - dequantize(q)    # error feedback

Error feedback keeps the quantisation unbiased over time: the residual of
step t is added to the gradient of step t+1.

The reference's ``axis_name`` is a ``torch.distributed`` process group
here: the shared scale is an all-reduce ``MAX`` of each member's
``max|g|``, the payload an all-reduce ``SUM`` of the int8 codes widened to
int32 (no overflow: |q| ≤ 127), and ``n`` the group's size.
``torch.round`` rounds half to even, as ``jnp.round`` does, so both
functions equal the reference bit for bit.

Used by ``train.step`` when ``TrainSettings.grad_compression="int8_ef"``
and the caller passes a pod group.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from .optimizer import tree_leaves, tree_map

__all__ = ["CompressionState", "init_state", "compress_decompress",
           "compressed_psum"]

Tree = Any


class CompressionState(NamedTuple):
    error: Tree  # per-leaf error-feedback residual (float32)


def init_state(grads_like: Tree) -> CompressionState:
    return CompressionState(error=tree_map(
        lambda g: torch.zeros_like(g, dtype=torch.float32), grads_like))


def _quant(g: torch.Tensor):
    amax = torch.max(torch.abs(g))
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def compress_decompress(g: torch.Tensor, err: torch.Tensor):
    """Single-leaf int8 round trip with error feedback. Returns (ĝ, new_err)."""
    g32 = g.to(torch.float32) + err
    q, scale = _quant(g32)
    deq = q.to(torch.float32) * scale
    return deq, g32 - deq


def compressed_psum(grads: Tree, state: CompressionState, group=None):
    """int8 error-feedback mean over the process ``group`` (None: the
    default group).

    Quantises locally with the scale every member shares (the all-reduced
    max), sums the codes widened to int32, dequantises and divides by the
    group's size, and keeps the local quantisation residual.
    """
    import torch.distributed as dist

    n = float(dist.get_world_size(group))

    def one(g, err):
        g32 = g.to(torch.float32) + err
        amax = torch.max(torch.abs(g32)).reshape(1)
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
        scale = torch.clamp(amax[0], min=1e-12) / 127.0
        q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
        deq_local = q.to(torch.float32) * scale
        q_sum = q.to(torch.int32)
        dist.all_reduce(q_sum, op=dist.ReduceOp.SUM, group=group)
        return q_sum.to(torch.float32) * scale / n, g32 - deq_local

    outs = [one(g, e) for g, e in zip(tree_leaves(grads),
                                      tree_leaves(state.error))]
    avg, err = iter([o[0] for o in outs]), iter([o[1] for o in outs])
    return (tree_map(lambda _: next(avg), grads),
            CompressionState(error=tree_map(lambda _: next(err), grads)))
