"""``masked_attention``: the LM self-attention kernels, with their twins.

Replaces ``ops/pallas/attn_kernel.py: masked_flash_attention``: the forward
with and without dropout (``_mflash_fwd_kernel``) and the recompute
backward (``_mflash_bwd_kernel``); the CUDA source is ``csrc/attention.cu``.
``masked_attention`` is the ``MaskedAttention`` autograd Function where a
backward is to be recorded, else its forward alone. The forward is the
custom op ``asr_port::masked_attention`` (so ``torch.export`` traces it);
the forward and the backward each run the plain-PyTorch twin
(``masked_attention_reference`` / ``masked_attention_bwd_reference``) for
CPU tensors, launch the kernel for CUDA tensors, and raise for anything
else, so the CPU tests run the same code the card runs.

Dropout is a keep mask [B, H, Tq, Tk] drawn by the caller, as in the JAX
package: the backward re-applies the same mask, so the VJP is exact.

The forward has two paths, chosen by shape and type alone (``fwd_path``
mirrors ``asr_masked_attention_path``): in bf16 at Tk <= 160 and Dh <= 64,
any Tq (every forward shape of the LM and e2e paths, with and without a
keep mask), blocks of up to 64 query rows form the scores and P.V on the
tensor cores with each row's scores held in registers
(``mma_fwd_smem_bytes``: K and V staged once a block); elsewhere (f32,
longer keys, wider heads) a scalar kernel walks the keys in chunks of 64,
keeping the block's scores in shared memory up to Tk 512 and recomputing
them above, so its shared memory stops growing with Tk
(``fwd_smem_bytes`` mirrors ``asr_masked_attention_smem``) and it takes
every Tk. The
backward has two paths, chosen by shape and type alone (``bwd_path``
mirrors ``asr_masked_attention_bwd_path``):
in bf16 at Tq, Tk <= 160 and Dh <= 64 (every shape of the LM and e2e
training paths) one block per (b, h) runs all five products on the tensor
cores (``mma_bwd_smem_bytes``); elsewhere two launches walk keys and
queries in chunks, so their shared memory depends on Dh alone
(``bwd_smem_bytes`` mirrors its layout) and they take every shape the
forward takes.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from asr_dfcnn_transformer_torch.kernels import _build

BIG_NEG = -1e9
MAX_SMEM = 232448          # bytes of shared memory a block may opt into
MAX_DH = 128
# csrc/attention.cu's scalar forward tiling: warps a block, query rows a
# block, the longest Tk whose scores it keeps in shared memory
_FWD_WARPS, _FWD_ROWS, _FWD_MAX_KEPT_TK = 4, 16, 512
# csrc/attention.cu's backward tiling: warps a block; query rows a block and
# keys a chunk in its first launch; key rows a block and queries a chunk in
# its second
_BWD_WARPS, _BWD_QROWS, _KEY_CHUNK, _BWD_KROWS, _QUERY_CHUNK = 8, 16, 64, 16, 32
# the one-block tensor-core backward's limits: Tq and Tk, Dh
_MMA_MAX_T, _MMA_MAX_DH = 160, 64
# the tensor-core forward's limits: Tk, Dh (any Tq)
_FWD_MAX_TK, _FWD_MAX_DH = 160, 64


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


def fwd_smem_bytes(dh: int, dtype: torch.dtype, tk: int) -> int:
    """Shared memory of the scalar forward at head width ``dh`` and ``tk``
    keys, as the kernel lays it out (``FwdLayout``;
    ``asr_masked_attention_smem`` gives the same): a K chunk of 64 keys,
    rows padded by a 32-bit word, and a V chunk in the input type, the
    block's 16 query rows in f32, a 64-key P chunk a warp and, up to Tk
    512, the block's scores [16][Tk] in f32. Independent of Tq."""
    size = 2 if dtype == torch.bfloat16 else 4
    ks = dh + 4 // size
    kept = _r16(_FWD_ROWS * tk * 4) if tk <= _FWD_MAX_KEPT_TK else 0
    return (_r16(_KEY_CHUNK * ks * size) + _r16(_KEY_CHUNK * dh * size)
            + _r16(_FWD_ROWS * dh * 4) + _r16(_FWD_WARPS * _KEY_CHUNK * 4)
            + kept)


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


def _row_stride(n: int) -> int:
    """csrc/mma.cuh row_stride(n, true): n rounded up to 8, plus 8 where
    that leaves an even count of 16-byte chunks."""
    r8 = (n + 7) // 8 * 8
    return r8 + (8 if (r8 // 8) % 2 == 0 else 0)


def mma_bwd_smem_bytes(tq: int, tk: int, dh: int) -> int:
    """Shared memory of the one-block tensor-core backward
    (``asr_masked_attention_bwd_mma_smem``): a 16-byte zero block, Q and dO
    [Tq][stride(Dh)], K and V [Tk][stride(Dh)], the dropped-P and dS tiles
    [Tq][stride(Tk)], all bf16."""
    sc, st = _row_stride(dh), _row_stride(tk)
    return 16 + (2 * tq * sc + 2 * tk * sc + 2 * tq * st) * 2


def bwd_path(tq: int, tk: int, dh: int, dtype: torch.dtype) -> str:
    """Which backward the launcher runs at (Tq, Tk, Dh) in ``dtype``:
    ``"mma"`` (one block per (b, h) on the tensor cores) or ``"chunked"``
    (the two launches), as ``asr_masked_attention_bwd_path`` decides."""
    fits = tq <= _MMA_MAX_T and tk <= _MMA_MAX_T and dh <= _MMA_MAX_DH
    return "mma" if dtype == torch.bfloat16 and fits else "chunked"


def mma_fwd_smem_bytes(tk: int, dh: int) -> int:
    """Shared memory of the tensor-core forward
    (``asr_masked_attention_mma_smem``): a 16-byte zero block, K and V
    [Tk][stride(Dh)] in bf16, then each key's additive mask in f32 over
    the 16-key tiles; independent of Tq."""
    return 16 + 2 * tk * _row_stride(dh) * 2 + _r16(tk) * 4


def fwd_path(tq: int, tk: int, dh: int, dtype: torch.dtype) -> str:
    """Which forward the launcher runs at (Tq, Tk, Dh) in ``dtype``:
    ``"mma"`` (the tensor cores) or ``"scalar"``, as
    ``asr_masked_attention_path`` decides; any Tq."""
    del tq
    fits = tk <= _FWD_MAX_TK and dh <= _FWD_MAX_DH
    return "mma" if dtype == torch.bfloat16 and fits else "scalar"


def _on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors if t is not None)


def _check_smem(name: str, smem: int, mirror: int, shape: str) -> None:
    """Guard that the C query and its mirror agree and fit the card."""
    if smem != mirror or smem > MAX_SMEM:
        raise ValueError(f"{name}: {shape} needs {smem} bytes of shared "
                         f"memory (the mirror says {mirror}), limit "
                         f"{MAX_SMEM}")


@functools.lru_cache(maxsize=1024)
def _checked_fwd_smem(dtype: torch.dtype, dh: int, tk: int) -> None:
    """``_check_smem`` of the scalar forward, once per (dtype, Dh, Tk)."""
    _check_smem("masked_attention", _build.library().asr_masked_attention_smem(
        _build.DTYPE_CODES[dtype], dh, tk), fwd_smem_bytes(dh, dtype, tk),
        f"Dh={dh}, Tk={tk}")


@functools.lru_cache(maxsize=8)
def _checked_bwd_smem(dtype: torch.dtype, dh: int) -> None:
    """``_check_smem`` of the chunked backward, once per (dtype, Dh)."""
    _check_smem("masked_attention_bwd",
                _build.library().asr_masked_attention_bwd_smem(
                    _build.DTYPE_CODES[dtype], dh),
                bwd_smem_bytes(dh, dtype), f"Dh={dh}")


def _masked_attention_cpu(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          k_valid: torch.Tensor,
                          keep_mask: Optional[torch.Tensor], keep_prob: float,
                          causal: bool) -> torch.Tensor:
    """The forward's op: the twin for CPU tensors."""
    return masked_attention_reference(q, k, v, k_valid, causal, keep_mask,
                                      keep_prob)


def _masked_attention_cuda(q, k, v, k_valid, keep_mask, keep_prob, causal):
    """The forward's op: the kernel for CUDA tensors."""
    tensors = [t for t in (q, k, v, k_valid, keep_mask) if t is not None]
    dev = _build.require_cuda("masked_attention", *tensors)
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    b, h, tq, dh = q.shape
    tk = k.shape[2]
    code = _build.DTYPE_CODES[q.dtype]
    lib = _build.library()
    if fwd_path(tq, tk, dh, q.dtype) == "scalar":
        _checked_fwd_smem(q.dtype, dh, tk)
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


def _masked_attention_fake(q, k, v, k_valid, keep_mask, keep_prob, causal):
    return torch.empty_like(q)


_masked_attention_op = _build.define_op(
    "masked_attention", _masked_attention_cpu, _masked_attention_cuda,
    _masked_attention_fake)


def _forward(q, k, v, k_valid, causal, keep_mask, keep_prob):
    _build.check_device("masked_attention", q, k, v, k_valid, keep_mask)
    return _masked_attention_op(q, k, v, k_valid, keep_mask,
                                float(keep_prob), bool(causal))


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
    stats = None
    if bwd_path(tq, tk, dh, q.dtype) == "chunked":
        _checked_bwd_smem(q.dtype, dh)
        # each query row's max, sum and dsum, from the first launch to the
        # second
        stats = torch.empty((3, b, h, tq), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.asr_masked_attention_bwd(
            code, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            k_valid.data_ptr(),
            None if keep_mask is None else keep_mask.data_ptr(),
            keep_prob, dout.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), None if stats is None else stats.data_ptr(), b, h,
            tq, tk, dh, _scale(dh), int(causal), _build.stream_ptr(dev))
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
    q, k and v. Dh <= 128, any Tq and Tk.
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
        if keep_prob >= 1.0:
            # no dropout, as masked_flash_attention: the forward and the
            # VJP both ignore the mask
            keep_mask = None
    if not (torch.is_grad_enabled()
            and any(t.requires_grad for t in (q, k, v))):
        # no backward to record: the op alone, which torch.export traces
        return _forward(q, k, v, k_valid, causal, keep_mask, keep_prob)
    return MaskedAttention.apply(q, k, v, k_valid, keep_mask,
                                 float(keep_prob), bool(causal))
