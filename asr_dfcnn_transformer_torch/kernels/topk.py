"""``topk_last``: exact top-k over the last axis, with its twin.

Replaces ``ops/pallas/topk_kernel.py: topk_last``; the CUDA source is
``csrc/topk.cu``. k rounds of (max, first index attaining it, mask that
index to exactly -1e30): values descending, ties to the lower index, as
``lax.top_k`` orders them, and a row with fewer than k entries above -1e30
degrades as the JAX kernel does. The wrapper runs the twin
(``topk_last_reference``) for a CPU tensor, launches the kernel for a CUDA
tensor, and raises for anything else.
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


def topk_last(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of ``x`` [..., V] f32 over the last axis -> (vals [..., k] f32,
    ids [..., k] int32), in ``lax.top_k``'s order. ``k > V`` raises."""
    _check(x, k)
    if x.device.type == "cpu":
        return topk_last_reference(x, k)
    dev = _build.require_cuda("topk_last", x)
    if x.dtype != torch.float32:
        raise ValueError(f"topk_last: x must be float32, got {x.dtype}")
    lead, v = x.shape[:-1], x.shape[-1]
    vals = torch.empty((*lead, k), dtype=torch.float32, device=dev)
    ids = torch.empty((*lead, k), dtype=torch.int32, device=dev)
    n = vals.numel() // k
    if n == 0:
        return vals, ids
    with torch.cuda.device(dev):
        rc = _build.library().asr_topk_last(
            x.data_ptr(), vals.data_ptr(), ids.data_ptr(), n, v, k,
            _build.stream_ptr(dev))
    _build.check("topk_last", rc, f"V {v}, k {k}")
    return vals, ids
