"""``masked_attention``: the LM self-attention kernels, with their twins.

Replaces ``ops/pallas/attn_kernel.py: masked_flash_attention``: the forward
with and without dropout (``_mflash_fwd_kernel``) and the recompute
backward (``_mflash_bwd_kernel``); the CUDA source is ``csrc/attention.cu``.
``masked_attention`` is the ``MaskedAttention`` autograd Function: its
forward and its backward each run the plain-PyTorch twin
(``masked_attention_reference`` / ``masked_attention_bwd_reference``) for
CPU tensors, launch the kernel for CUDA tensors, and raise for anything
else, so the CPU tests run the same Function the card runs.

Dropout is a keep mask [B, H, Tq, Tk] drawn by the caller, as in the JAX
package: the backward re-applies the same mask, so the VJP is exact.

The forward stages one (b, h)'s K and V in shared memory, which bounds Tk
(``asr_masked_attention_smem``). The backward walks keys and queries in
chunks, so its shared memory depends on Dh alone (``bwd_smem_bytes``
mirrors its layout) and it takes every shape the forward takes.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from asr_dfcnn_transformer_torch.kernels import _build

BIG_NEG = -1e9
MAX_SMEM = 232448          # bytes of shared memory a block may opt into
MAX_DH = 128
# csrc/attention.cu's backward tiling: warps a block; query rows a block and
# keys a chunk in its first launch; key rows a block and queries a chunk in
# its second
_BWD_WARPS, _BWD_QROWS, _KEY_CHUNK, _BWD_KROWS, _QUERY_CHUNK = 8, 16, 64, 16, 32


def _scale(dh: int) -> float:
    return 1.0 / float(dh) ** 0.5


def _scores(q, k, k_valid, causal):
    """f32 scores scaled by 1/sqrt(Dh) plus the additive -1e9 mask."""
    tq, tk, dh = q.shape[2], k.shape[2], q.shape[3]
    ok = k_valid[:, None, None, :].to(q.device)
    if causal:
        ok = ok & torch.ones((tq, tk), dtype=torch.bool,
                             device=q.device).tril()
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * _scale(dh)
    return scores + torch.where(ok, 0.0, BIG_NEG)


def _drop(probs: torch.Tensor, keep_mask: torch.Tensor,
          keep_prob: float) -> torch.Tensor:
    """flax Dropout on probabilities in their type: (p / keep) * mask."""
    keep = torch.tensor(keep_prob, dtype=probs.dtype)   # a scalar anywhere
    return (probs / keep) * keep_mask.to(probs.dtype)


def masked_attention_reference(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, k_valid: torch.Tensor,
                               causal: bool = False,
                               keep_mask: Optional[torch.Tensor] = None,
                               keep_prob: float = 1.0) -> torch.Tensor:
    """Plain-PyTorch twin of the forward kernel: f32 scores scaled by
    1/sqrt(Dh), additive -1e9 for invalid or (causal) future keys, f32
    softmax, probabilities rounded to q's dtype (then dropped with
    ``keep_mask``) before P.V, f32 accumulation."""
    probs = torch.softmax(_scores(q, k, k_valid, causal), dim=-1).to(q.dtype)
    if keep_mask is not None:
        probs = _drop(probs, keep_mask, keep_prob)
    return torch.matmul(probs.float(), v.float()).to(q.dtype)


def masked_attention_bwd_reference(q, k, v, k_valid, dout, causal=False,
                                   keep_mask=None, keep_prob=1.0
                                   ) -> Tuple[torch.Tensor, ...]:
    """Plain-PyTorch twin of the backward kernel: (dq, dk, dv) in q's dtype
    by recompute, with ``_mflash_bwd_kernel``'s arithmetic (exp / sum in
    f32, dsum over the undropped f32 P, dS rounded to the dtype)."""
    scale = _scale(q.shape[3])
    scores = _scores(q, k, k_valid, causal)
    probs = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    probs = probs / probs.sum(dim=-1, keepdim=True)
    dout = dout.to(q.dtype)
    dp = torch.matmul(dout.float(), v.float().transpose(-1, -2))
    if keep_mask is not None:
        dropped = _drop(probs.to(q.dtype), keep_mask, keep_prob)
        dp = dp * (keep_mask.float() / keep_prob)
    else:
        dropped = probs.to(q.dtype)
    dsum = torch.sum(dp * probs, dim=-1, keepdim=True)
    ds = (probs * (dp - dsum) * scale).to(q.dtype).float()
    dq = torch.matmul(ds, k.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    dv = torch.matmul(dropped.float().transpose(-1, -2), dout.float())
    return tuple(x.to(q.dtype) for x in (dq, dk, dv))


def _r16(n: int) -> int:
    return (n + 15) // 16 * 16


def bwd_smem_bytes(dh: int, dtype: torch.dtype) -> int:
    """Shared memory of the backward's larger launch at head width ``dh``,
    as the kernel lays it out (``RowsLayout`` / ``KeysLayout``;
    ``asr_masked_attention_bwd_smem`` gives the same): K and V chunks of 64
    keys and Q and dO chunks of 32 queries, rows padded by a 32-bit word,
    plus f32 rows, row statistics and per-warp columns. Independent of Tq
    and Tk."""
    size = 2 if dtype == torch.bfloat16 else 4
    ks = dh + 4 // size
    rows = (2 * _r16(_KEY_CHUNK * ks * size) + _r16(_BWD_QROWS * 2 * dh * 4)
            + _r16(_BWD_WARPS * _KEY_CHUNK * 4))
    keys = (2 * _r16(_QUERY_CHUNK * ks * size) + _r16(3 * _QUERY_CHUNK * 4)
            + _r16(_BWD_KROWS * 2 * dh * 4)
            + _r16(_BWD_WARPS * 2 * _QUERY_CHUNK * 4))
    return max(rows, keys)


def _on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors if t is not None)


def _check_smem(name: str, smem: int, tk: int, dh: int) -> None:
    if smem > MAX_SMEM:
        raise ValueError(f"{name}: Tk={tk}, Dh={dh} needs {smem} bytes of "
                         f"shared memory, above {MAX_SMEM}")


def _forward(q, k, v, k_valid, causal, keep_mask, keep_prob):
    if _on_cpu(q, k, v, k_valid, keep_mask):
        return masked_attention_reference(q, k, v, k_valid, causal,
                                          keep_mask, keep_prob)
    tensors = [t for t in (q, k, v, k_valid, keep_mask) if t is not None]
    dev = _build.require_cuda("masked_attention", *tensors)
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    b, h, tq, dh = q.shape
    tk = k.shape[2]
    code = _build.DTYPE_CODES[q.dtype]
    lib = _build.library()
    _check_smem("masked_attention", lib.asr_masked_attention_smem(code, tk, dh),
                tk, dh)
    name = "masked_attention" if keep_mask is None else "masked_attention_drop"
    with torch.cuda.device(dev):
        rc = lib.asr_masked_attention(
            code, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            k_valid.data_ptr(),
            None if keep_mask is None else keep_mask.data_ptr(),
            keep_prob, out.data_ptr(), b, h, tq, tk, dh, _scale(dh),
            int(causal), _build.stream_ptr(dev))
    _build.check(name, rc)
    return out


def _backward(q, k, v, k_valid, dout, causal, keep_mask, keep_prob):
    if _on_cpu(q, k, v, k_valid, dout, keep_mask):
        return masked_attention_bwd_reference(q, k, v, k_valid, dout, causal,
                                              keep_mask, keep_prob)
    dout = dout.to(q.dtype).contiguous()
    tensors = [t for t in (q, k, v, k_valid, dout, keep_mask)
               if t is not None]
    dev = _build.require_cuda("masked_attention_bwd", *tensors)
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    if q.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    b, h, tq, dh = q.shape
    tk = k.shape[2]
    code = _build.DTYPE_CODES[q.dtype]
    lib = _build.library()
    _check_smem("masked_attention_bwd",
                lib.asr_masked_attention_bwd_smem(code, dh), tk, dh)
    # each query row's max, sum and dsum, from the first launch to the second
    stats = torch.empty((3, b, h, tq), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.asr_masked_attention_bwd(
            code, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            k_valid.data_ptr(),
            None if keep_mask is None else keep_mask.data_ptr(),
            keep_prob, dout.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), stats.data_ptr(), b, h, tq, tk, dh, _scale(dh),
            int(causal), _build.stream_ptr(dev))
    _build.check("masked_attention_bwd", rc)
    return dq, dk, dv


class MaskedAttention(torch.autograd.Function):
    """Forward: the attention kernel (or its twin). Backward: the recompute
    backward kernel (or its twin). Saves q, k, v, k_valid and the keep
    mask, not P."""

    @staticmethod
    def forward(ctx, q, k, v, k_valid, keep_mask, keep_prob, causal):
        ctx.save_for_backward(q, k, v, k_valid, keep_mask)
        ctx.causal, ctx.keep_prob = causal, keep_prob
        return _forward(q, k, v, k_valid, causal, keep_mask, keep_prob)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, k_valid, keep_mask = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, k_valid, dout, ctx.causal, keep_mask,
                               ctx.keep_prob)
        return dq, dk, dv, None, None, None, None


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     k_valid: Optional[torch.Tensor] = None, *,
                     causal: bool = False,
                     keep_mask: Optional[torch.Tensor] = None,
                     keep_prob: float = 1.0) -> torch.Tensor:
    """Multi-head attention with key-validity and causal masks, and
    attention-probability dropout.

    q [B, H, Tq, Dh]; k/v [B, H, Tk, Dh] (float32 or bfloat16, one dtype);
    k_valid [B, Tk] bool (True = attendable; None = all valid); ``causal``
    masks keys with col > row (jnp.tril semantics, Tq != Tk too);
    ``keep_mask`` [B, H, Tq, Tk] bool (True = keep; None = no dropout) with
    ``keep_prob``. Returns [B, H, Tq, Dh] in q's dtype; differentiable in
    q, k and v. Dh <= 128; Tk is bounded by the forward's shared memory
    (the backward takes every shape the forward takes).
    """
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("masked_attention: q, k, v must be [B, H, T, Dh]")
    b, h, tq, dh = q.shape
    tk = k.shape[2]
    if k.shape != (b, h, tk, dh) or v.shape != k.shape:
        raise ValueError(f"masked_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if q.dtype not in _build.DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError("masked_attention: q, k, v must share a float32 or "
                         "bfloat16 dtype")
    if not 1 <= dh <= MAX_DH or tk < 1:
        raise ValueError(f"masked_attention: need 1 <= Dh <= {MAX_DH} and "
                         f"Tk >= 1, got Dh={dh}, Tk={tk}")
    if k_valid is None:
        k_valid = torch.ones((b, tk), dtype=torch.bool, device=q.device)
    if k_valid.shape != (b, tk) or k_valid.dtype != torch.bool:
        raise ValueError("masked_attention: k_valid must be [B, Tk] bool")
    if keep_mask is not None:
        if keep_mask.shape != (b, h, tq, tk) or keep_mask.dtype != torch.bool:
            raise ValueError("masked_attention: keep_mask must be "
                             "[B, H, Tq, Tk] bool")
        if not 0.0 < keep_prob <= 1.0:
            raise ValueError(f"masked_attention: keep_prob {keep_prob} is "
                             "not in (0, 1]")
    return MaskedAttention.apply(q, k, v, k_valid, keep_mask,
                                 float(keep_prob), bool(causal))
