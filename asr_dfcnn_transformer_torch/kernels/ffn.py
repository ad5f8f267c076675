"""``fused_ffn``: the position-wise FFN in one kernel, with its twins.

Replaces ``ops/pallas/ffn_kernel.py: fused_ffn`` (``_fused_ffn`` and its
body ``_ffn_kernel``); the CUDA source is ``csrc/ffn.cu``, which keeps the
[N, F] inner activation out of device memory. ``fused_ffn`` is the
``FusedFFN`` autograd Function: its forward runs the plain-PyTorch twin
``fused_ffn_reference`` for CPU tensors, launches the kernel for CUDA
tensors and raises for anything else; its backward is
``fused_ffn_bwd_reference``, plain PyTorch on both devices, as the JAX VJP
(``_fused_ffn_bwd``) is plain XLA.

Weights are in the port's Linear layout: W1 [F, D], W2 [D, F]. The kernel
takes D and F in multiples of 16; ``_padded`` zero-pads other widths up to
them, which is exact (zero columns of x and W1 add exact zeros to each sum,
a zero inner column is relu(0 + 0) = 0 and adds nothing, and the zero output
columns are sliced off), as the JAX wrapper pads N.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from asr_dfcnn_transformer_torch.kernels import _build

MULTIPLE = 16    # D and F in whole mma tiles (padded up to it)
MAX_WIDTH = 2**31 - MULTIPLE   # csrc/ffn.cu takes D and F as C ints


def supports(d: int, f: int) -> bool:
    """Whether the kernel takes model width ``d`` and inner width ``f``:
    any positive widths whose padded sizes fit the launcher's ints."""
    return 1 <= d <= MAX_WIDTH and 1 <= f <= MAX_WIDTH


def check_supported(d: int, f: int) -> None:
    if not supports(d, f):
        raise ValueError(
            f"fused_ffn: the kernel takes 1 <= D, F <= {MAX_WIDTH}; got "
            f"D={d}, F={f}")


def _round_up(n: int) -> int:
    return -(-n // MULTIPLE) * MULTIPLE


def _padded(x, w1, b1, w2, b2):
    """The operands zero-padded to D and F in multiples of 16 (no copy
    when they are already)."""
    d, f = x.shape[-1], w1.shape[0]
    pd, pf = _round_up(d) - d, _round_up(f) - f
    if pd == 0 and pf == 0:
        return x, w1, b1, w2, b2
    return (F.pad(x, (0, pd)), F.pad(w1, (0, pd, 0, pf)), F.pad(b1, (0, pf)),
            F.pad(w2, (0, pf, 0, pd)), F.pad(b2, (0, pd)))


def fused_ffn_reference(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                        w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Plain-PyTorch twin of the kernel, ``_ffn_kernel``'s arithmetic in x's
    dtype: each product accumulated in f32 and rounded to the dtype, the
    bias added in the dtype, ReLU between (the port's ``Dense`` ops)."""
    inner = torch.relu(F.linear(x, w1) + b1)
    return F.linear(inner, w2) + b2


def fused_ffn_bwd_reference(x, w1, b1, w2, b2, g) -> Tuple[torch.Tensor, ...]:
    """The VJP, ``_fused_ffn_bwd``'s arithmetic in the port's layouts: the
    inner activation recomputed; each product accumulated in f32 and
    rounded to its operand's dtype, the bias gradients summed in f32 ->
    (dx, dw1, db1, dw2, db2)."""
    pre = F.linear(x, w1) + b1
    inner = torch.relu(pre)
    g = g.to(x.dtype)
    db2 = g.float().sum(0).to(b2.dtype)
    dw2 = torch.matmul(g.t(), inner).to(w2.dtype)
    dinner = torch.matmul(g, w2)
    dinner = torch.where(pre > 0, dinner, torch.zeros((), dtype=x.dtype))
    db1 = dinner.float().sum(0).to(b1.dtype)
    dw1 = torch.matmul(dinner.t(), x).to(w1.dtype)
    dx = torch.matmul(dinner, w1)
    return dx, dw1, db1, dw2, db2


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` at a 16-byte-aligned address (the kernel's vector loads); a
    copy only when it is not."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _forward(x, w1, b1, w2, b2):
    if all(t.device.type == "cpu" for t in (x, w1, b1, w2, b2)):
        return fused_ffn_reference(x, w1, b1, w2, b2)
    x, w1, b1, w2, b2 = (t.contiguous() for t in (x, w1, b1, w2, b2))
    dev = _build.require_cuda("fused_ffn", x, w1, b1, w2, b2)
    n, d = x.shape
    x, w1, b1, w2, b2 = _padded(x, w1, b1, w2, b2)
    x, w1, w2 = (_aligned(t) for t in (x, w1, w2))
    dp, fp = x.shape[1], w1.shape[0]
    y = torch.empty_like(x)
    if n == 0:
        return y[:, :d]
    lib = _build.library()
    with torch.cuda.device(dev):
        rc = lib.asr_fused_ffn(_build.DTYPE_CODES[x.dtype], x.data_ptr(),
                               w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                               b2.data_ptr(), y.data_ptr(), n, dp, fp,
                               _build.stream_ptr(dev))
    _build.check("fused_ffn", rc, f"N={n}, D={dp}, F={fp}")
    return y if dp == d else y[:, :d].contiguous()


class FusedFFN(torch.autograd.Function):
    """Forward: the fused kernel (or its twin). Backward: the plain VJP.
    Saves x and the weights, not the inner activation."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        return _forward(x, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, g):
        return fused_ffn_bwd_reference(*ctx.saved_tensors, g)


def fused_ffn(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
              w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """relu(x W1^T + b1) W2^T + b2 with the inner activation kept on chip.

    x [..., D] (float32 or bfloat16; leading axes flattened); W1 [F, D],
    b1 [F], W2 [D, F], b2 [D], cast to x's dtype as the JAX ``fused_ffn``
    casts them. Returns x's shape in x's dtype; differentiable in every
    input. Any D and F within ``supports``."""
    if x.dtype not in _build.DTYPE_CODES:
        raise ValueError("fused_ffn: x must be float32 or bfloat16, got "
                         f"{x.dtype}")
    d = x.shape[-1]
    f = w1.shape[0]
    if (w1.shape != (f, d) or b1.shape != (f,) or w2.shape != (d, f)
            or b2.shape != (d,)):
        raise ValueError(f"fused_ffn: shapes x {tuple(x.shape)}, w1 "
                         f"{tuple(w1.shape)}, b1 {tuple(b1.shape)}, w2 "
                         f"{tuple(w2.shape)}, b2 {tuple(b2.shape)} disagree")
    check_supported(d, f)
    w1c, b1c, w2c, b2c = (a.to(x.dtype) for a in (w1, b1, w2, b2))
    y = FusedFFN.apply(x.reshape(-1, d), w1c, b1c, w2c, b2c)
    return y.reshape(x.shape)
