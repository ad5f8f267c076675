"""``dual_axis_attention``: the e2e pre-net's single-head attention per row.

Replaces ``ops/pallas/attn_kernel.py: dual_axis_attention`` (its forward,
``_fwd_kernel``); the CUDA source is ``csrc/dual_attention.cu``. The wrapper
runs the plain-PyTorch twin ``dual_axis_attention_reference`` for CPU
tensors, launches the kernel for CUDA tensors, and raises for anything
else. The backward is not ported yet, so the wrapper raises when an input
requires grad rather than return an output cut off from the graph.
"""

from __future__ import annotations

import torch

from asr_dfcnn_transformer_torch.kernels import _build

MAX_T = 160    # rows up to the pre-net's time axis (134 at bucket 1600)
MAX_C = 128


def _scale(c: int) -> float:
    return 1.0 / float(c) ** 0.5


def dual_axis_attention_reference(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor) -> torch.Tensor:
    """Plain-PyTorch twin of the kernel: f32 scores multiplied by
    1/sqrt(C), f32 softmax, probabilities rounded to q's dtype before P.V,
    f32 accumulation, output in q's dtype."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
        * _scale(q.shape[-1])
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.matmul(probs.float(), v.float()).to(q.dtype)


def dual_axis_attention(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(C)) v for each of R rows: q, k, v [R, T, C]
    (float32 or bfloat16, one dtype; 1 <= T <= 160, 1 <= C <= 128; no
    mask) -> [R, T, C] in q's dtype."""
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError("dual_axis_attention: q, k, v must share one "
                         f"[R, T, C] shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in _build.DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError("dual_axis_attention: q, k, v must share a "
                         "float32 or bfloat16 dtype")
    r, t, c = q.shape
    if not (1 <= t <= MAX_T and 1 <= c <= MAX_C):
        raise ValueError(f"dual_axis_attention: need 1 <= T <= {MAX_T} and "
                         f"1 <= C <= {MAX_C}, got T={t}, C={c}")
    _build.no_grad_inputs("dual_axis_attention", q, k, v)
    if all(x.device.type == "cpu" for x in (q, k, v)):
        return dual_axis_attention_reference(q, k, v)
    dev = _build.require_cuda("dual_axis_attention", q, k, v)
    out = torch.empty_like(q)
    if r == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(dev):
        rc = lib.asr_dual_attention(
            _build.DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), r, t, c, _scale(c),
            _build.stream_ptr(dev))
    _build.check("dual_axis_attention", rc, f"R={r}, T={t}, C={c}")
    return out
