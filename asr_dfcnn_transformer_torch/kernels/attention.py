"""``masked_attention``: the LM self-attention kernel, with its twin.

Replaces the forward of ``ops/pallas/attn_kernel.py: masked_flash_attention``
(no dropout); the CUDA source is ``csrc/attention.cu``. The wrapper runs the
plain-PyTorch twin (``masked_attention_reference``) for CPU tensors,
launches the kernel for CUDA tensors, and raises for anything else.
"""

from __future__ import annotations

from typing import Optional

import torch

from asr_dfcnn_transformer_torch.kernels import _build

BIG_NEG = -1e9
MAX_SMEM = 232448          # bytes of shared memory a block may opt into
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _scale(dh: int) -> float:
    return 1.0 / float(dh) ** 0.5


def masked_attention_reference(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, k_valid: torch.Tensor,
                               causal: bool = False) -> torch.Tensor:
    """Plain-PyTorch twin of the kernel: f32 scores scaled by 1/sqrt(Dh),
    additive -1e9 for invalid or (causal) future keys, f32 softmax,
    probabilities rounded to q's dtype before P.V, f32 accumulation."""
    tq, tk, dh = q.shape[2], k.shape[2], q.shape[3]
    ok = k_valid[:, None, None, :].to(q.device)
    if causal:
        ok = ok & torch.ones((tq, tk), dtype=torch.bool,
                             device=q.device).tril()
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * _scale(dh)
    scores = scores + torch.where(ok, 0.0, BIG_NEG)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.matmul(probs.float(), v.float()).to(q.dtype)


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     k_valid: Optional[torch.Tensor] = None, *,
                     causal: bool = False) -> torch.Tensor:
    """Multi-head attention with key-validity and causal masks.

    q [B, H, Tq, Dh]; k/v [B, H, Tk, Dh] (float32 or bfloat16, one dtype);
    k_valid [B, Tk] bool (True = attendable; None = all valid); ``causal``
    masks keys with col > row (jnp.tril semantics, Tq != Tk too). Returns
    [B, H, Tq, Dh] in q's dtype. Dh <= 128; Tk is bounded by shared memory.
    """
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("masked_attention: q, k, v must be [B, H, T, Dh]")
    b, h, tq, dh = q.shape
    tk = k.shape[2]
    if k.shape != (b, h, tk, dh) or v.shape != k.shape:
        raise ValueError(f"masked_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError("masked_attention: q, k, v must share a float32 or "
                         "bfloat16 dtype")
    if not 1 <= dh <= 128 or tk < 1:
        raise ValueError(f"masked_attention: need 1 <= Dh <= 128 and Tk >= 1, "
                         f"got Dh={dh}, Tk={tk}")
    if k_valid is None:
        k_valid = torch.ones((b, tk), dtype=torch.bool, device=q.device)
    if k_valid.shape != (b, tk) or k_valid.dtype != torch.bool:
        raise ValueError("masked_attention: k_valid must be [B, Tk] bool")
    tensors = (q, k, v, k_valid)
    if all(t.device.type == "cpu" for t in tensors):
        return masked_attention_reference(q, k, v, k_valid, causal)
    dev = _build.require_cuda("masked_attention", *tensors)
    if q.numel() == 0:
        return torch.empty_like(q)
    code = _DTYPE_CODES[q.dtype]
    lib = _build.library()
    smem = lib.asr_masked_attention_smem(code, tk, dh)
    if smem > MAX_SMEM:
        raise ValueError(f"masked_attention: Tk={tk}, Dh={dh} needs {smem} "
                         f"bytes of shared memory, above {MAX_SMEM}")
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        rc = lib.asr_masked_attention(
            code, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            k_valid.data_ptr(), out.data_ptr(), b, h, tq, tk, dh,
            _scale(dh), int(causal), _build.stream_ptr(dev))
    _build.check("masked_attention", rc)
    return out
