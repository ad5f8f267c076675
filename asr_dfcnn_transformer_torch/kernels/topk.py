"""``topk_last``: exact top-k over the last axis, with its twin.

Replaces ``ops/pallas/topk_kernel.py: topk_last``; the CUDA source is
``csrc/topk.cu``. k rounds of (max, first index attaining it, mask that
index to exactly -1e30): values descending, ties to the lower index, as
``lax.top_k`` orders them, and a row with fewer than k entries above -1e30
degrades as the JAX kernel does. The wrapper calls the custom op
``asr_port::topk_last``, which runs the twin (``topk_last_reference``) for a
CPU tensor and launches the kernel for a CUDA tensor; the wrapper raises for
anything else.
"""

from __future__ import annotations

from typing import Tuple

import torch

from asr_dfcnn_transformer_torch.kernels import _build

NEG_INF = -1e30


def _check(x: torch.Tensor, k: int) -> None:
    if x.dim() < 1 or k < 1:
        raise ValueError("topk_last needs x [..., V] and k >= 1")
    if k > x.shape[-1]:
        raise ValueError(f"k={k} exceeds the last-axis size {x.shape[-1]}")


def topk_last_reference(x: torch.Tensor, k: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain-PyTorch twin of ``topk_last`` (same contract): k rounds of
    (max, first argmax, mask the pick at -1e30). Never ``torch.topk``,
    whose order among ties is unspecified."""
    _check(x, k)
    xw = x.float().clone()
    v = xw.shape[-1]
    iota = torch.arange(v, device=xw.device)
    vals, ids = [], []
    for _ in range(k):
        m = torch.amax(xw, dim=-1, keepdim=True)
        # first index attaining the max
        a = torch.amin(torch.where(xw == m, iota, v), dim=-1, keepdim=True)
        vals.append(m)
        ids.append(a)
        xw = torch.where(iota == a, NEG_INF, xw)
    return (torch.cat(vals, -1).to(x.dtype),
            torch.cat(ids, -1).to(torch.int32))


def _topk_last_cpu(x: torch.Tensor, k: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The op under ``topk_last``: the twin for CPU tensors."""
    return topk_last_reference(x, k)


def _topk_last_cuda(x, k):
    """The op under ``topk_last``: the kernel (in f32) for CUDA tensors."""
    if not x.is_floating_point():
        raise ValueError(f"topk_last: x must be a float tensor, got {x.dtype}")
    dtype = x.dtype
    x = x.float().contiguous()
    dev = _build.require_cuda("topk_last", x)
    lead, v = x.shape[:-1], x.shape[-1]
    vals = torch.empty((*lead, k), dtype=torch.float32, device=dev)
    ids = torch.empty((*lead, k), dtype=torch.int32, device=dev)
    n = vals.numel() // k
    if n == 0:
        return vals.to(dtype), ids
    with torch.cuda.device(dev):
        rc = _build.library().asr_topk_last(
            x.data_ptr(), vals.data_ptr(), ids.data_ptr(), n, v, k,
            _build.stream_ptr(dev))
    _build.check("topk_last", rc, f"V {v}, k {k}")
    return vals.to(dtype), ids


def _topk_last_fake(x, k):
    shape = (*x.shape[:-1], k)
    return x.new_empty(shape), x.new_empty(shape, dtype=torch.int32)


_topk_last_op = _build.define_op("topk_last", _topk_last_cpu, _topk_last_cuda,
                                 _topk_last_fake)


def topk_last(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of ``x`` [..., V] (any float type) over the last axis -> (vals
    [..., k] in x's type, ids [..., k] int32), in ``lax.top_k``'s order.
    The kernel runs in f32: x is cast on the way in and the values back on
    the way out, as the JAX kernel does. ``k > V`` raises."""
    _check(x, k)
    _build.check_device("topk_last", x)
    return _topk_last_op(x, k)
