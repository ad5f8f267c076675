"""The port's matmul inverse FFT (``ops/matfft.py``) and the
``interleave_epilogue`` twin against the JAX package's, whose Pallas kernel
runs in interpret mode off the TPU, as tests/test_matfft.py runs it; inputs
come from numpy seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_dfcnn_transformer_tpu.ops import matfft as jax_matfft
from asr_dfcnn_transformer_tpu.ops.pallas.fft_epilogue import (
    interleave_epilogue as jax_interleave_epilogue,
)
from asr_dfcnn_transformer_torch.kernels import (interleave_epilogue,
                                                 interleave_epilogue_reference)
from asr_dfcnn_transformer_torch.ops import matfft
from tests._torch_cpu import use_two_threads

use_two_threads()

JAX_DTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _spectrum(seed, batch, n):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((*batch, n // 2 + 1)).astype(np.float32),
            rng.standard_normal((*batch, n // 2 + 1)).astype(np.float32))


def _peak_err(got, want):
    got, want = (np.asarray(a, np.complex128) for a in (got, want))
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("batch", [(), (3,), (2, 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [
    16, 4096, 16384,
    # [n2, n1] off matfft's power-of-two splits: n1 not a multiple of a
    # 16-byte load's elements, odd n1 n2 (rows off 16-byte boundaries)
    pytest.param((33, 36), id="33x36"), pytest.param((33, 35), id="33x35"),
    pytest.param((7, 5), id="7x5")])
def test_epilogue_twin_bit_equal_to_jax_kernel(n, dtype, batch):
    if isinstance(n, tuple):
        n2, n1 = n
        n = 2 * n1 * n2
    else:
        n1, n2 = jax_matfft._split(n // 2)
    rng = np.random.default_rng(n + len(batch))
    zr, zi = (torch.from_numpy(rng.standard_normal(
        (*batch, n2, n1)).astype(np.float32)).to(dtype) for _ in range(2))
    want = jax_interleave_epilogue(
        *(jnp.asarray(z.float().numpy(), JAX_DTYPE[dtype]) for z in (zr, zi)),
        n)
    got = interleave_epilogue(zr, zi, n)
    assert got.dtype == torch.float32 and got.shape == (*batch, n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(interleave_epilogue_reference(zr, zi, n), got)


@pytest.mark.parametrize("compute", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [16, 256, 16384])
def test_irfft_matmul_matches_jax_and_numpy(n, compute):
    """The port's "xla" and "pallas" epilogues are bit-equal; each is within
    1e-5 (f32 compute) or 2e-2 (bf16) of the peak of JAX's "xla" path, and
    within tests/test_matfft.py's bounds of ``numpy.fft.irfft`` (5e-6 and
    0.03 of the peak)."""
    sr, si = _spectrum(n, (2,), n)
    ref = np.fft.irfft(sr + 1j * si, n)
    want = jax_matfft.irfft_matmul(jnp.asarray(sr), jnp.asarray(si), n,
                                   compute_dtype=JAX_DTYPE[compute])
    args = (torch.from_numpy(sr), torch.from_numpy(si), n)
    xla = matfft.irfft_matmul(*args, compute_dtype=compute, epilogue="xla")
    pal = matfft.irfft_matmul(*args, compute_dtype=compute,
                              epilogue="pallas")
    auto = matfft.irfft_matmul(*args, compute_dtype=compute)
    assert xla.dtype == torch.float32 and xla.shape == (2, n)
    assert torch.equal(pal, xla) and torch.equal(auto, xla)
    f32 = compute == torch.float32
    assert _peak_err(xla.numpy(), want) < (1e-5 if f32 else 2e-2)
    assert _peak_err(xla.numpy(), ref) < (5e-6 if f32 else 0.03)


@pytest.mark.parametrize("compute", [torch.float32, torch.bfloat16])
def test_ifft_matmul_matches_jax_and_numpy(compute):
    rng = np.random.default_rng(7)
    n = 1024
    x = (rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n)))
    xr, xi = x.real.astype(np.float32), x.imag.astype(np.float32)
    ref = np.fft.ifft(x, n) * n
    jr, ji = jax_matfft.ifft_matmul(jnp.asarray(xr), jnp.asarray(xi), n,
                                    compute_dtype=JAX_DTYPE[compute])
    yr, yi = matfft.ifft_matmul(torch.from_numpy(xr), torch.from_numpy(xi),
                                n, compute_dtype=compute)
    assert yr.dtype == compute
    got = yr.float().numpy() + 1j * yi.float().numpy()
    want = np.asarray(jr, np.float32) + 1j * np.asarray(ji, np.float32)
    f32 = compute == torch.float32
    assert _peak_err(got, want) < (1e-5 if f32 else 2e-2)
    assert _peak_err(got, ref) < (5e-6 if f32 else 0.03)


def test_dc_and_nyquist_imaginary_parts_are_ignored():
    """numpy's rule: the imaginary parts of bins 0 and n/2 do not count."""
    n = 64
    sr, si = _spectrum(3, (2,), n)
    clean = si.copy()
    clean[:, 0] = clean[:, -1] = 0.0
    got = matfft.irfft_matmul(torch.from_numpy(sr), torch.from_numpy(si), n)
    want = matfft.irfft_matmul(torch.from_numpy(sr), torch.from_numpy(clean),
                               n)
    assert torch.equal(got, want)
    np.testing.assert_allclose(got.numpy(), np.fft.irfft(sr + 1j * si, n),
                               atol=1e-6)


def test_bad_sizes_and_epilogues_raise():
    x = torch.zeros(8), torch.zeros(8)
    with pytest.raises(ValueError, match="power-of-two size"):
        matfft.ifft_matmul(*x, 12)
    with pytest.raises(ValueError, match="power-of-two size"):
        matfft.ifft_matmul(*x, 2)
    s = torch.zeros(9), torch.zeros(9)
    with pytest.raises(ValueError,
                       match=r"epilogue must be auto\|xla\|pallas"):
        matfft.irfft_matmul(*s, 16, epilogue="nope")
    z = torch.zeros(2, 4)
    with pytest.raises(ValueError, match=r"expected n1\*n2 == 32/2"):
        interleave_epilogue(z, z, 32)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        interleave_epilogue(z.double(), z.double(), 16)


def test_epilogue_wrapper_raises_off_cpu_and_cuda():
    """A tensor on neither the CPU nor CUDA (the meta device) is refused,
    never run through the twin."""
    z = torch.empty((2, 4), device="meta")
    with pytest.raises(ValueError, match="expected CUDA or CPU tensors"):
        interleave_epilogue(z, z, 16)
