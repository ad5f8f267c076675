"""Inverse real FFT as two matrix products: the port of ``ops/matfft.py``.

The JAX package wrote it for the TPU, whose own FFT was slow: a
power-of-two inverse DFT of size N = N1 * N2 as two dense DFT products
and a twiddle multiply (two-stage Cooley-Tukey, decimation over
k = k1 + N1 k2, n = n2 + N2 n1):

    x[n2 + N2 n1] = sum_k1 E(n1 k1 / N1) T[n2, k1]
                    sum_k2 X[k2, k1] E(n2 k2 / N2),   E(q) = exp(2 i pi q)

with the twiddle T[n2, k1] = E(n2 k1 / N). A real N-point ``irfft`` packs
into one N/2-point complex transform (see ``irfft_matmul``). The port keeps
it whole because its last stage is the one way into the
``interleave_epilogue`` kernel (``kernels/fft_epilogue.py``); the noise
path keeps the JAX package's choice and runs it only on a TPU
(``audio/noise.py``), so on the card it takes ``torch.fft`` (cuFFT).

Numerics, as the JAX code:

- the DFT products contract axis -2 of x in place, so the result puts the
  free axis before the matrix's: x [..., K, M] with m [K, N] gives
  [..., M, N];
- each complex product forms ``xr mr - xi mi`` and ``xr mi + xi mr`` in
  f32 and rounds to the compute dtype once, after the subtraction and the
  addition (``preferred_element_type=jnp.float32``). The port upcasts the
  operands to f32 (a bf16 value is exact in f32, and so is the product of
  two) and runs f32 products: under bf16 compute that reads and writes the
  operands at twice the bytes of a bf16 product, for one rounding instead
  of three;
- the cos/sin matrices and the twiddles are made as the JAX code makes
  them, in numpy float64, then rounded to f32, then to the compute dtype
  (f32 trigonometry at angles of ~1,600 rad would be off by far more than
  an ulp), and cached per (size, dtype, device).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from asr_dfcnn_transformer_torch.kernels.fft_epilogue import (
    interleave_epilogue)

EPILOGUES = ("auto", "xla", "pallas")


def _split(n: int) -> Tuple[int, int]:
    """Balanced power-of-two factorisation n = n1 * n2."""
    if n & (n - 1) or n < 4:
        raise ValueError(f"matfft needs a power-of-two size >= 4, got {n}")
    log = n.bit_length() - 1
    n1 = 1 << (log - log // 2)
    return n1, n // n1


def _host_cos_sin(ang: np.ndarray, dtype: torch.dtype,
                  device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos and sin of float64 angles, rounded to f32, then to ``dtype``."""
    return tuple(torch.from_numpy(f(ang).astype(np.float32)).to(device, dtype)
                 for f in (np.cos, np.sin))


@functools.lru_cache(maxsize=32)
def _idft_mats(n: int, dtype: torch.dtype, device: torch.device):
    """cos/sin of the inverse-DFT matrix for size n ([n, n])."""
    k = np.arange(n)
    return _host_cos_sin(2.0 * np.pi / n * np.outer(k, k), dtype, device)


@functools.lru_cache(maxsize=32)
def _twiddles(n1: int, n2: int, dtype: torch.dtype, device: torch.device):
    """cos/sin of E(n2 k1 / N) on the [k1, n2] layout."""
    m = np.arange(n1)[:, None] * np.arange(n2)[None, :]
    return _host_cos_sin(2.0 * np.pi / (n1 * n2) * m, dtype, device)


@functools.lru_cache(maxsize=32)
def _pack_twiddles(n: int, device: torch.device):
    """cos/sin of E(k / n), k < n/2, in f32 (``irfft_matmul``'s packing)."""
    return _host_cos_sin(2.0 * np.pi * np.arange(n // 2) / n, torch.float32,
                         device)


def _cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def _cmatmul(xr, xi, mr, mi):
    """(x^T m) over the last two axes for complex operands held as real and
    imaginary parts: axis -2 of x [..., K, M] against axis 0 of m [K, N]
    gives [..., M, N]; products and their sum and difference in f32, one
    rounding to x's dtype."""
    dt = xr.dtype
    xr, xi = xr.float().transpose(-1, -2), xi.float().transpose(-1, -2)
    mr, mi = mr.float(), mi.float()
    out_r = torch.matmul(xr, mr) - torch.matmul(xi, mi)
    out_i = torch.matmul(xr, mi) + torch.matmul(xi, mr)
    return out_r.to(dt), out_i.to(dt)


def _ifft_stages(xr, xi, n: int, compute_dtype: torch.dtype):
    """Both DFT stages and the twiddle of the inverse DFT, without the last
    interleave relayout: (zr, zi) [..., n2, n1] in ``compute_dtype``, with
    y[n2_idx + N2 n1_idx] = z[n2_idx, n1_idx]."""
    n1, n2 = _split(n)
    batch = xr.shape[:-1]
    dev = xr.device
    # [k2, k1] layout: k = k1 + n1 k2
    xr = xr.reshape(*batch, n2, n1).to(compute_dtype)
    xi = xi.reshape(*batch, n2, n1).to(compute_dtype)
    c2, s2 = _idft_mats(n2, compute_dtype, dev)
    yr, yi = _cmatmul(xr, xi, c2, s2)               # [..., k1, n2]
    tc, ts = _twiddles(n1, n2, compute_dtype, dev)
    yr, yi = _cmul(yr, yi, tc, ts)
    c1, s1 = _idft_mats(n1, compute_dtype, dev)
    return _cmatmul(yr, yi, c1, s1)                 # [..., n2, n1]


def ifft_matmul(xr: torch.Tensor, xi: torch.Tensor, n: int,
                compute_dtype: torch.dtype = torch.float32):
    """Unnormalised inverse complex DFT over the last axis (length n):
    y[m] = sum_k x[k] exp(2 i pi k m / n), no 1/n. xr/xi [..., n] ->
    (yr, yi) [..., n] in ``compute_dtype``."""
    batch = xr.shape[:-1]
    zr, zi = _ifft_stages(xr, xi, n, compute_dtype)
    # output index n2 + N2 n1: the [n2, n1] -> [n1, n2] relayout, kept in
    # compute_dtype (half its bytes under bf16); callers upcast
    return (zr.transpose(-1, -2).reshape(*batch, n),
            zi.transpose(-1, -2).reshape(*batch, n))


def irfft_matmul(sr: torch.Tensor, si: torch.Tensor, n: int,
                 compute_dtype: torch.dtype = torch.float32,
                 epilogue: str = "auto") -> torch.Tensor:
    """``numpy.fft.irfft(s, n)`` for power-of-two n >= 8 through one
    n/2-point matmul ifft. sr/si [..., n/2 + 1] f32, the half-spectrum's
    real and imaginary parts -> [..., n] f32, with numpy's 1/n.

    ``epilogue`` selects the last relayout: "xla" (the plain relayout of
    the JAX package's XLA path), "pallas" (the ``interleave_epilogue``
    kernel, bit-identical) or "auto", which is "xla" as in the JAX package
    (no crossover is measured on the card).

    Packing: with S the half-spectrum, h = n/2 and Sc[k] = conj(S[h - k]),
    Z[k] = (S[k] + Sc[k]) + E(k/n) i (S[k] - Sc[k]), k < h, gives
    ifft_unnorm(Z, h)[m] = n (x[2m] + i x[2m + 1]): even and odd samples
    interleave from one half-size transform, with the exact scale 1/n."""
    h = n // 2
    # numpy.fft.irfft ignores the imaginary parts of the DC and Nyquist
    # bins (a real signal forces them to 0)
    edge = torch.ones(h + 1, dtype=si.dtype, device=si.device)
    edge[0] = edge[h] = 0
    si = si * edge
    rr, ri = sr.flip(-1), si.flip(-1)       # S[h], S[h-1], ..., S[0]
    ar, ai = sr[..., :h] + rr[..., :h], si[..., :h] - ri[..., :h]
    br, bi = sr[..., :h] - rr[..., :h], si[..., :h] + ri[..., :h]
    tc, ts = _pack_twiddles(n, sr.device)
    # Z = A + E(k/n) (i B), i B = (-bi, br)
    tr_, ti_ = _cmul(-bi, br, tc, ts)
    zr, zi = ar + tr_, ai + ti_
    if epilogue == "auto":
        epilogue = "xla"
    if epilogue == "pallas":
        wr, wi = _ifft_stages(zr, zi, h, compute_dtype)
        return interleave_epilogue(wr, wi, n)
    if epilogue != "xla":
        raise ValueError(f"epilogue must be auto|xla|pallas, got {epilogue}")
    yr, yi = ifft_matmul(zr, zi, h, compute_dtype=compute_dtype)
    # even/odd interleave in compute_dtype, then upcast and the exact 1/n
    x = torch.stack([yr, yi], dim=-1).reshape(*yr.shape[:-1], n)
    return x.float() * (1.0 / n)
