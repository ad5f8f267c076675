"""``interleave_epilogue``: the matmul inverse FFT's last relayout, with its
twin.

Replaces ``ops/pallas/fft_epilogue.py: interleave_epilogue``; the CUDA
source is ``csrc/fft_epilogue.cu``. From the DFT stages' output zr, zi
[..., n2, n1] (float32 or bfloat16) of ``ops/matfft.py`` it returns the
length-n real signal, n = 2 n1 n2, in float32:
x[..., 2 (m2 + n2 m1) + p] = f32(z_p[..., m2, m1]) / n. The wrapper runs
the twin (``interleave_epilogue_reference``, the relayout of
``irfft_matmul(epilogue="xla")``) for CPU tensors, launches the kernel for
CUDA tensors and raises for anything else.
"""

from __future__ import annotations

import math

import torch

from asr_dfcnn_transformer_torch.kernels import _build


def _check(zr: torch.Tensor, zi: torch.Tensor, n: int) -> None:
    if zr.dim() < 2 or zr.shape != zi.shape or zr.dtype != zi.dtype:
        raise ValueError("interleave_epilogue needs zr, zi [..., n2, n1] of "
                         f"one shape and type, got {tuple(zr.shape)} "
                         f"{zr.dtype} and {tuple(zi.shape)} {zi.dtype}")
    if zr.dtype not in _build.DTYPE_CODES:
        raise ValueError("interleave_epilogue: z must be float32 or "
                         f"bfloat16, got {zr.dtype}")
    n2, n1 = zr.shape[-2:]
    if 2 * n1 * n2 != n:
        raise ValueError(f"z is [..., {n2}, {n1}]; expected n1*n2 == {n}/2")


def interleave_epilogue_reference(zr: torch.Tensor, zi: torch.Tensor,
                                  n: int) -> torch.Tensor:
    """Plain-PyTorch twin: the [n2, n1] -> [n1, n2] swap, the (re, im)
    stack on a last axis, the upcast, then the exact 1/n."""
    _check(zr, zi, n)
    batch = zr.shape[:-2]
    x = torch.stack([zr.transpose(-1, -2), zi.transpose(-1, -2)], dim=-1)
    return x.reshape(*batch, n).float() * (1.0 / n)


def interleave_epilogue(zr: torch.Tensor, zi: torch.Tensor,
                        n: int) -> torch.Tensor:
    """zr, zi [..., n2, n1] -> x [..., n] float32 with
    x[..., 2 (m2 + n2 m1) + p] = z_p[..., m2, m1] / n, in one pass."""
    _check(zr, zi, n)
    if zr.device.type == "cpu" and zi.device.type == "cpu":
        return interleave_epilogue_reference(zr, zi, n)
    zr, zi = zr.contiguous(), zi.contiguous()
    dev = _build.require_cuda("interleave_epilogue", zr, zi)
    *batch, n2, n1 = zr.shape
    b = math.prod(batch)
    out = torch.empty((*batch, n), dtype=torch.float32, device=dev)
    if b == 0:
        return out
    with torch.cuda.device(dev):
        rc = _build.library().asr_interleave_epilogue(
            _build.DTYPE_CODES[zr.dtype], zr.data_ptr(), zi.data_ptr(),
            out.data_ptr(), b, n2, n1, 1.0 / n, _build.stream_ptr(dev))
    _build.check("interleave_epilogue", rc, f"B={b}, n2={n2}, n1={n1}")
    return out
