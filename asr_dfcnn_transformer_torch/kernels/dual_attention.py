"""``dual_axis_attention``: the e2e pre-net's single-head attention per row.

Replaces ``ops/pallas/attn_kernel.py: dual_axis_attention``: its forward
(``_fwd_kernel``) and its recompute VJP (``_attn_packed_bwd``,
``_bwd_kernel``); the CUDA source is ``csrc/dual_attention.cu``.
``dual_axis_attention`` is the ``DualAxisAttention`` autograd Function: its
forward and its backward each run the plain-PyTorch twin
(``dual_axis_attention_reference`` / ``dual_axis_attention_bwd_reference``)
for CPU tensors, launch the kernel for CUDA tensors, and raise for anything
else, so the CPU tests run the same Function the card runs.

The backward kernels keep a row's Q, K, V, dO and its [T, T] tiles in
shared memory, which bounds (T, C) more tightly than the forward's
T <= 160, C <= 128 (bfloat16 runs on the tensor cores, float32 on scalar
FMAs, each with its own layout). ``bwd_smem_bytes`` mirrors the kernels'
layouts, so a forward whose inputs require grad refuses, on the CPU as on
the card, a size whose backward could not run, rather than fail in
``backward()``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from asr_dfcnn_transformer_torch.kernels import _build

MAX_T = 160    # rows up to the pre-net's time axis (134 at bucket 1600)
MAX_C = 128
MAX_SMEM = 232448          # bytes of shared memory a block may opt into
_BWD_WARPS = 8             # csrc/dual_attention.cu kBwdWarps


def _scale(c: int) -> float:
    return 1.0 / float(c) ** 0.5


def _r16(n: int) -> int:
    return (n + 15) // 16 * 16


def _row_stride(n: int, pad: bool) -> int:
    """csrc/dual_attention.cu ``row_stride``: n rounded up to 8, plus 8
    where that leaves an even count of 16-byte chunks."""
    n8 = (n + 7) // 8 * 8
    return n8 + (8 if pad and n8 // 8 % 2 == 0 else 0)


def _mma_bwd_bytes(t: int, c: int, pad: bool) -> int:
    return 16 + t * (4 * _row_stride(c, pad) + 2 * _row_stride(t, pad)) * 2


def bwd_smem_bytes(t: int, c: int, dtype: torch.dtype) -> int:
    """Shared memory of one backward block at [., T, C], as the kernel lays
    it out (``asr_dual_attention_bwd_smem`` gives the same). bfloat16, the
    tensor-core kernel (``mma_bwd_smem``): a 16-byte zero block, Q, dO, K
    and V [T][row_stride(C)] and the P and dS tiles [T][row_stride(T)],
    unpadded strides where the padded ones would exceed ``MAX_SMEM``.
    float32, the scalar kernel (``BwdLayout``): Q and dO rows of even(C), K
    and V rows padded by a 32-bit word, the P and dS tiles [T, T], and per
    warp four f32 rows."""
    if dtype == torch.bfloat16:
        padded = _mma_bwd_bytes(t, c, True)
        return padded if padded <= MAX_SMEM else _mma_bwd_bytes(t, c, False)
    ce = (c + 1) // 2 * 2
    ks = ce + 1
    return (2 * _r16(t * ce * 4) + 2 * _r16(t * ks * 4)
            + 2 * _r16(t * t * 4) + _r16(_BWD_WARPS * (2 * ce + 2 * t) * 4))


def supports(t: int, c: int, dtype: torch.dtype, grad: bool) -> bool:
    """Whether the kernels take [., T, C] rows of ``dtype``: the forward's
    limits, and with ``grad`` the backward's shared memory too."""
    if not (1 <= t <= MAX_T and 1 <= c <= MAX_C):
        return False
    return not grad or bwd_smem_bytes(t, c, dtype) <= MAX_SMEM


def dual_axis_attention_reference(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor) -> torch.Tensor:
    """Plain-PyTorch twin of the kernel: f32 scores multiplied by
    1/sqrt(C), f32 softmax, probabilities rounded to q's dtype before P.V,
    f32 accumulation, output in q's dtype."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
        * _scale(q.shape[-1])
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.matmul(probs.float(), v.float()).to(q.dtype)


def dual_axis_attention_bwd_reference(q: torch.Tensor, k: torch.Tensor,
                                      v: torch.Tensor, dout: torch.Tensor
                                      ) -> Tuple[torch.Tensor, ...]:
    """Plain-PyTorch twin of the backward kernel, ``_bwd_kernel``'s
    arithmetic: P = exp(s - max) / sum in f32; the cotangent rounded to q's
    dtype; dP = dO.V^T and dsum = sum(dP * P) over the unrounded f32 P;
    dS = P (dP - dsum) scale rounded to the dtype; dq = dS.K, dk = dS^T.Q,
    dv = P_dtype^T.dO accumulated in f32 -> (dq, dk, dv) in q's dtype."""
    scale = _scale(q.shape[-1])
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    probs = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    probs = probs / probs.sum(dim=-1, keepdim=True)
    dout = dout.to(q.dtype).float()
    dp = torch.matmul(dout, v.float().transpose(-1, -2))
    dsum = torch.sum(dp * probs, dim=-1, keepdim=True)
    ds = (probs * (dp - dsum) * scale).to(q.dtype).float()
    dq = torch.matmul(ds, k.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    dv = torch.matmul(probs.to(q.dtype).float().transpose(-1, -2), dout)
    return tuple(x.to(q.dtype) for x in (dq, dk, dv))


def _forward(q, k, v):
    if all(x.device.type == "cpu" for x in (q, k, v)):
        return dual_axis_attention_reference(q, k, v)
    dev = _build.require_cuda("dual_axis_attention", q, k, v)
    out = torch.empty_like(q)
    r, t, c = q.shape
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


def _backward(q, k, v, dout):
    if all(x.device.type == "cpu" for x in (q, k, v, dout)):
        return dual_axis_attention_bwd_reference(q, k, v, dout)
    dout = dout.to(q.dtype).contiguous()
    dev = _build.require_cuda("dual_axis_attention_bwd", q, k, v, dout)
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    r, t, c = q.shape
    if r == 0:
        return dq, dk, dv
    lib = _build.library()
    with torch.cuda.device(dev):
        rc = lib.asr_dual_attention_bwd(
            _build.DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
            v.data_ptr(), dout.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), r, t, c, _scale(c), _build.stream_ptr(dev))
    _build.check("dual_axis_attention_bwd", rc, f"R={r}, T={t}, C={c}")
    return dq, dk, dv


class DualAxisAttention(torch.autograd.Function):
    """Forward: the attention kernel (or its twin). Backward: the recompute
    backward kernel (or its twin). Saves q, k and v, not P."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return _forward(q, k, v)

    @staticmethod
    def backward(ctx, dout):
        return _backward(*ctx.saved_tensors, dout)


def dual_axis_attention(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(C)) v for each of R rows: q, k, v [R, T, C]
    (float32 or bfloat16, one dtype; 1 <= T <= 160, 1 <= C <= 128; no
    mask) -> [R, T, C] in q's dtype; differentiable in q, k and v, for a
    (T, C) whose backward fits the card's shared memory (``supports``)."""
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError("dual_axis_attention: q, k, v must share one "
                         f"[R, T, C] shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in _build.DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError("dual_axis_attention: q, k, v must share a "
                         "float32 or bfloat16 dtype")
    _, t, c = q.shape
    if not supports(t, c, q.dtype, grad=False):
        raise ValueError(f"dual_axis_attention: need 1 <= T <= {MAX_T} and "
                         f"1 <= C <= {MAX_C}, got T={t}, C={c}")
    grad = torch.is_grad_enabled() and any(x.requires_grad
                                           for x in (q, k, v))
    if grad and not supports(t, c, q.dtype, grad=True):
        raise ValueError(
            f"dual_axis_attention: the backward at T={t}, C={c}, {q.dtype} "
            f"needs {bwd_smem_bytes(t, c, q.dtype)} bytes of shared memory, "
            f"above {MAX_SMEM}")
    return DualAxisAttention.apply(q, k, v)
