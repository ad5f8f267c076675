"""The port's front end (log_mel + cmvn twins) against the JAX batched_fbank.

The CUDA kernels themselves are held against these twins on the card by
chip_smoke.py (this directory's conftest imports jax, which the card's
machine lacks).
"""

import dataclasses

import numpy as np
import pytest
import torch

from asr_dfcnn_transformer_tpu.audio import fbank as jf
from asr_dfcnn_transformer_torch.audio import fbank as tf
from asr_dfcnn_transformer_torch.kernels import cmvn, log_mel
from tests._torch_cpu import use_two_threads

use_two_threads()


@pytest.fixture(scope="module")
def signals():
    """The signals of test_pallas_fbank.py plus one of <= 400 samples."""
    rng = np.random.default_rng(7)
    t = np.arange(40000) / 16000.0
    a = (0.4 * np.sin(2 * np.pi * 523 * t)
         + 0.05 * rng.standard_normal(t.shape)).astype(np.float32)
    b = np.zeros_like(a)
    b[:25000] = (0.3 * np.sin(2 * np.pi * 907 * t[:25000])
                 + 0.05 * rng.standard_normal(25000)).astype(np.float32)
    c = np.zeros_like(a)
    c[:300] = 0.2 * rng.standard_normal(300).astype(np.float32)
    return np.stack([a, b, c]), np.array([40000, 25000, 300], np.int32)


def _empty_filters():
    return np.flatnonzero(tf.mel_filterbank().sum(axis=0) == 0)


def test_tables_match_jax():
    np.testing.assert_array_equal(tf.mel_filterbank(), jf.mel_filterbank())
    for a, b in zip(tf._dft_bases_np(400, 512), jf._dft_bases_np(400, 512)):
        np.testing.assert_array_equal(a, b)
    for s in (1, 399, 400, 401, 560, 561, 40000):
        assert tf.num_frames(s) == jf.num_frames(s)
    assert len(_empty_filters()) > 0     # the case the CMVN must zero


def _fbank_f64(sigs, lens, out_frames):
    """Exact reference: batched_fbank in float64 numpy from the same f32
    pre-emphasised samples and f32 bases that both packages use."""
    cos_b, sin_b = (b.astype(np.float64) for b in tf._dft_bases_np(400, 512))
    mel = tf.mel_filterbank().astype(np.float64)
    out = np.zeros((len(sigs), out_frames, 200))
    for i, (x, n_s) in enumerate(zip(sigs, lens)):
        pe = np.concatenate([x[:1], x[1:] - np.float32(0.97) * x[:-1]])
        pe = np.where(np.arange(len(x)) < n_s, pe, 0).astype(np.float64)
        n = tf.num_frames(len(x))
        pe = np.pad(pe, (0, (n - 1) * 160 + 400 - len(x)))
        frames = np.stack([pe[f * 160:f * 160 + 400] for f in range(n)])
        power = ((frames @ cos_b) ** 2 + (frames @ sin_b) ** 2) / 512
        feat = np.log(np.maximum(power @ mel, np.finfo(np.float64).eps))
        v = tf.num_frames(int(n_s))
        mean = feat[:v].mean(0)
        std = feat[:v].std(0)
        std[std == 0] = 1.0
        norm = (feat - mean) / std
        norm = (norm - norm[:v].mean(0)) * (np.arange(n) < v)[:, None]
        m = min(n, out_frames)
        out[i, :m] = norm[:m]
    return out


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("out_frames", [100, 130, 256])
def test_batched_fbank_matches_jax(signals, backend, out_frames):
    """The port against the JAX path at rtol/atol 2e-4 wherever the JAX
    path's f32 DFT is itself within that of the exact value. A bin whose
    power is tiny next to its frame's energy (the DC-only low filters after
    pre-emphasis) cancels in f32, so f32 summation orders disagree there
    by ~1e-3; the port sums the DFT in f64 and must hold the exact value
    everywhere."""
    sigs, lens = signals
    cfg = dataclasses.replace(jf.FbankConfig(), backend=backend)
    want, want_valid = jf.batched_fbank(sigs, lens, cfg=cfg,
                                        out_frames=out_frames)
    want = np.asarray(want)
    got, got_valid = tf.batched_fbank(torch.from_numpy(sigs),
                                      torch.from_numpy(lens),
                                      out_frames=out_frames)
    assert got.shape == (3, out_frames, 200) and got.dtype == torch.float32
    got = got.numpy()
    np.testing.assert_array_equal(got_valid.numpy(), np.asarray(want_valid))
    exact = _fbank_f64(sigs, lens, out_frames)
    np.testing.assert_allclose(got, exact, rtol=2e-4, atol=2e-4)
    jax_ok = np.isclose(want, exact, rtol=2e-4, atol=2e-4)
    assert jax_ok.mean() > 0.999
    np.testing.assert_allclose(got[jax_ok], want[jax_ok], rtol=2e-4,
                               atol=2e-4)
    # empty mel filters: a constant log(eps) column normalises to exactly 0
    assert np.all(got[:, :, _empty_filters()] == 0.0)


def test_log_mel_twin_matches_exact(signals):
    """Un-normalised log-mel against float64 numpy and the JAX logfbank."""
    sigs, lens = signals
    n = jf.num_frames(int(lens[1]))
    x = sigs[1, :lens[1]]
    pe = np.concatenate([x[:1], x[1:] - np.float32(0.97) * x[:-1]])
    pe = np.pad(pe.astype(np.float64), (0, (n - 1) * 160 + 400 - len(x)))
    frames = np.stack([pe[f * 160:f * 160 + 400] for f in range(n)])
    spec = np.abs(np.fft.rfft(frames, 512)) ** 2 / 512
    exact = np.log(np.maximum(spec @ tf.mel_filterbank().astype(np.float64),
                              np.finfo(np.float64).eps))
    got = log_mel(torch.from_numpy(sigs[1:2]), torch.from_numpy(lens[1:2]),
                  n)[0].numpy()
    np.testing.assert_allclose(got, exact, rtol=1e-5, atol=1e-4)
    want = np.asarray(jf.logfbank(x))
    ok = np.isclose(want, exact, rtol=1e-4, atol=1e-3)
    assert ok.mean() > 0.999
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-4, atol=1e-3)


def test_cmvn_twin_matches_jax_cmvn():
    rng = np.random.default_rng(3)
    feat = rng.standard_normal((3, 40, 16)).astype(np.float32)
    feat[:, :, 5] = -36.04365                 # a constant column
    valid = np.array([40, 17, 0], np.int32)
    got = cmvn(torch.from_numpy(feat), torch.from_numpy(valid)).numpy()
    for i in range(3):
        want = np.asarray(jf.cmvn(feat[i], np.int32(valid[i])))
        np.testing.assert_allclose(got[i], want, rtol=1e-5, atol=1e-5)
    assert np.all(got[:, :, 5] == 0.0)
    assert np.all(got[1, 17:] == 0.0) and np.all(got[2] == 0.0)


def test_wrappers_reject_bad_inputs():
    sig = torch.zeros((2, 800))
    lens = torch.tensor([800, 400], dtype=torch.int32)
    with pytest.raises(ValueError, match="float32"):
        log_mel(sig.double(), lens, 4)
    with pytest.raises(ValueError, match="int32"):
        log_mel(sig, lens.long(), 4)
    with pytest.raises(ValueError, match="fixed"):
        log_mel(sig, lens, 4, cfg=tf.FbankConfig(hop=80))
    with pytest.raises(ValueError, match="int32"):
        cmvn(torch.zeros((2, 4, 8)), torch.ones(2))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        log_mel(sig.to("meta"), lens.to("meta"), 4)


def test_fft_twiddles_within_one_ulp():
    """The ``log_mel`` kernel's f64 twiddles: exp(-2 pi i m / 512) for
    m = 0..511 as (real, imaginary) pairs, each within one ulp."""
    from asr_dfcnn_transformer_torch.kernels import fbank as kf
    tw = kf.fft_twiddles_np()
    assert tw.shape == (512, 2) and tw.dtype == np.float64
    assert tw.flags.c_contiguous
    want = np.exp(-2j * np.pi * np.arange(512) / 512)
    for got, exact in ((tw[:, 0], want.real), (tw[:, 1], want.imag)):
        assert np.all(np.abs(got - exact) <= np.spacing(np.abs(exact)))


@pytest.mark.parametrize("nfilt,nnz,empty,widest", [
    (200, 353, 43, 6),     # the AM's front end
    (80, 425, 1, 16),      # the e2e front end's
])
def test_mel_spans_cover_the_bank(nfilt, nnz, empty, widest):
    """The kernel's sparse mel bank: each filter's span runs from its first
    to its last non-zero bin, so the spans cover every non-zero of
    ``mel_filterbank`` and nothing outside; here every span is contiguous
    (no zero inside), and the counts are the bank's."""
    from asr_dfcnn_transformer_torch.kernels import fbank as kf
    mel = tf.mel_filterbank(tf.FbankConfig(nfilt=nfilt))
    spans, weights = kf.mel_spans_np(mel)
    assert spans.shape == (nfilt, 3) and spans.dtype == np.int32
    assert weights.dtype == np.float32
    dense = np.zeros_like(mel)
    for j, (first, count, off) in enumerate(spans):
        dense[first:first + count, j] = weights[off:off + count]
        if count:
            assert mel[first, j] != 0 and mel[first + count - 1, j] != 0
    np.testing.assert_array_equal(dense, mel)      # bit for bit
    assert int(np.count_nonzero(weights)) == weights.size == nnz
    assert int((spans[:, 1] == 0).sum()) == empty
    assert int(spans[:, 1].max()) == widest
    assert list(spans[:, 2]) == list(np.cumsum(spans[:, 1]) - spans[:, 1])


def _fmaf(a, b, c):
    """f32 fmaf through f64: the product of two f32 is exact in f64."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


@pytest.mark.parametrize("nfilt", [200, 80])
def test_sparse_projection_equals_dense_bit_for_bit(nfilt):
    """The kernel's mel projection, a chain of fmaf over each span's bins in
    order, gives the dense chain's bits over all 257 bins: a zero weight
    leaves the sum as it is (fmaf(p, 0, acc) == acc for a finite p).
    Power rows of real frames, of silence and of tiny values."""
    from asr_dfcnn_transformer_torch.kernels import fbank as kf
    mel = tf.mel_filterbank(tf.FbankConfig(nfilt=nfilt)).astype(np.float32)
    spans, weights = kf.mel_spans_np(mel)
    rng = np.random.default_rng(nfilt)
    power = np.concatenate([
        (rng.standard_normal((40, 257)) ** 2 * 10.0 ** rng.uniform(
            -6, 3, (40, 1))).astype(np.float32),
        np.zeros((2, 257), np.float32),
        np.full((2, 257), 1e-30, np.float32)])
    dense = np.zeros((power.shape[0], nfilt), np.float32)
    for k in range(257):
        dense = _fmaf(power[:, k:k + 1], mel[k][None, :], dense)
    sparse = np.zeros_like(dense)
    for j, (first, count, off) in enumerate(spans):
        for i in range(count):
            sparse[:, j] = _fmaf(power[:, first + i], weights[off + i],
                                 sparse[:, j])
    np.testing.assert_array_equal(sparse.view(np.int32), dense.view(np.int32))


def _kernel_fft_mirror(frames):
    """The ``log_mel`` kernel's FFT in numpy, step by step: a real 512-point
    FFT of frames [F, 400] (zero-padded) as the 256-point complex FFT of
    z[n] = x[2n] + i x[2n + 1] in two radix-16 passes (each two radix-4
    passes with the W16 twiddles between), the W256^(n1 k2) twiddles and
    the exchange between them, then the post-processing to bins 0..256.
    Every twiddle comes from the kernel's table."""
    from asr_dfcnn_transformer_torch.kernels import fbank as kf
    tw = kf.fft_twiddles_np()
    w512 = tw[:, 0] + 1j * tw[:, 1]
    w16 = w512[32 * np.arange(10)]

    def dft4(a):
        t0, t1, t2 = a[0] + a[2], a[0] - a[2], a[1] + a[3]
        t3 = -1j * (a[1] - a[3])
        return [t0 + t2, t1 + t3, t0 - t2, t1 - t3]

    def dft16(y):           # y: 16 arrays, natural order in and out
        y = list(y)
        for nb in range(4):
            y[nb], y[4 + nb], y[8 + nb], y[12 + nb] = dft4(
                [y[nb], y[4 + nb], y[8 + nb], y[12 + nb]])
        for nb in range(1, 4):
            for ka in range(1, 4):
                m = nb * ka
                y[4 * ka + nb] = (-1j * y[4 * ka + nb] if m == 4
                                  else y[4 * ka + nb] * w16[m])
        for ka in range(4):
            y[4 * ka:4 * ka + 4] = dft4(y[4 * ka:4 * ka + 4])
        return [y[4 * (k % 4) + k // 4] for k in range(16)]

    x = np.zeros((frames.shape[0], 512))
    x[:, :400] = frames
    z = x[:, 0::2] + 1j * x[:, 1::2]                       # [F, 256]
    first = np.zeros((frames.shape[0], 16, 16), complex)  # [F, n1, k2]
    for n1 in range(16):
        y = dft16([z[:, n1 + 16 * n2] for n2 in range(16)])
        for k2 in range(16):
            first[:, n1, k2] = y[k2] * (w512[2 * n1 * k2] if k2 else 1)
    big_z = np.zeros((frames.shape[0], 256), complex)
    for k2 in range(16):
        y = dft16([first[:, n1, k2] for n1 in range(16)])
        for k1 in range(16):
            big_z[:, 16 * k1 + k2] = y[k1]
    k = np.arange(256)
    a, c = big_z, big_z[:, (256 - k) % 256]
    even = 0.5 * (a + np.conj(c))
    odd = 0.5 * (a.imag + c.imag) + 0.5j * (c.real - a.real)
    nyquist = (big_z[:, 0].real - big_z[:, 0].imag)[:, None]
    return np.concatenate([even + w512[k] * odd, nyquist], axis=1)


def test_kernel_fft_steps_give_the_real_fft(signals):
    """The index arithmetic of the kernel's FFT, mirrored in numpy, against
    ``np.fft.rfft`` in f64 (to 1e-12 of each frame's largest bin), and the
    log-mel it gives within phase 2's tolerance of the twin (rtol 1e-4,
    atol 1e-3)."""
    sigs, lens = signals
    n = 100
    x = sigs[0]
    pe = np.concatenate([x[:1], x[1:] - np.float32(0.97) * x[:-1]])
    frames = np.stack([pe[f * 160:f * 160 + 400] for f in range(n)]).astype(
        np.float64)
    got = _kernel_fft_mirror(frames)
    want = np.fft.rfft(frames, 512)
    scale = np.abs(want).max(axis=1, keepdims=True)
    assert np.all(np.abs(got - want) <= 1e-12 * scale)
    power = ((got.real ** 2 + got.imag ** 2) / 512).astype(np.float32)
    mel = tf.mel_filterbank().astype(np.float32)
    feat = np.log(np.maximum(power @ mel, np.float32(np.finfo(np.float64).eps)))
    twin = log_mel(torch.from_numpy(sigs[:1]), torch.from_numpy(lens[:1]),
                   n)[0].numpy()
    np.testing.assert_allclose(feat, twin, rtol=1e-4, atol=1e-3)


_PLAN_CASES = [(b, t, f) for b in (1, 8, 16) for t in (400, 800, 1200, 1600)
               for f in (200, 80)] + [(2, 6400, 200), (3, 37, 1030)]


@pytest.mark.parametrize("cluster", [16, 8])
@pytest.mark.parametrize("b, t, f", _PLAN_CASES)
def test_cmvn_plan_covers_every_frame_once(b, t, f, cluster):
    """``cmvn_plan``, the mirror of the kernel's tiling: the cluster's blocks
    own contiguous runs of frames that cover [0, T) exactly once, a block's
    shared memory stays within the card's 232,448 bytes, and the rows
    stream from device memory exactly when they do not fit beside the
    statistics' buffers: never at the served and trained buckets, always
    past them (6400 frames)."""
    from asr_dfcnn_transformer_torch.kernels import fbank as kf
    p = kf.cmvn_plan(t, f, cluster)
    owned = np.zeros(t, np.int64)
    for rank in range(cluster):
        r0 = min(rank * p["rows"], t)
        owned[r0:min(r0 + p["rows"], t)] += 1
    assert np.all(owned == 1)
    assert p["smem"] <= kf.SMEM_LIMIT
    assert p["chunk"] == min(f, kf.CMVN_CHUNK)
    assert p["groups"] * p["chunk"] <= max(kf.CMVN_THREADS, p["chunk"])
    tile = -(-4 * (p["rows"] * f + 3) // 16) * 16   # rows and lead
    fixed = p["smem"] - (0 if p["stream"] else tile)
    assert p["stream"] == int(fixed + tile > kf.SMEM_LIMIT)
    assert p["stream"] == (t == 6400)


def _pallas_cmvn(feat, valid):
    from asr_dfcnn_transformer_tpu.ops.pallas.fbank_kernel import pallas_cmvn
    return np.asarray(pallas_cmvn(feat, valid, interpret=True))


@pytest.mark.parametrize("cluster", [16, 8])
def test_cmvn_blocked_order_matches_pallas_cmvn(cluster):
    """The kernel's order of sums (``cmvn_blocked_np``: per block, per row
    group in four accumulators, the blocks in rank order) against the JAX
    package's ``pallas_cmvn`` in interpret mode, within atol 1e-5, with a
    constant column (an empty filter's log eps) exactly 0 wherever valid <=
    T, rows at and past valid exactly 0, and valid of 0 and above T."""
    from asr_dfcnn_transformer_torch.kernels import fbank as kf
    rng = np.random.default_rng(cluster)
    feat = (3 * rng.standard_normal((4, 61, 24)) - 10).astype(np.float32)
    feat[:, :, 5] = np.float32(np.log(np.finfo(np.float64).eps))
    valid = np.array([61, 17, 0, 80], np.int32)
    got = kf.cmvn_blocked_np(feat, valid, cluster)
    want = _pallas_cmvn(feat, valid)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert np.all(got[:3, :, 5] == 0.0)
    assert np.all(got[1, 17:] == 0.0) and np.all(got[2] == 0.0)
    twin = cmvn(torch.from_numpy(feat), torch.from_numpy(valid)).numpy()
    np.testing.assert_allclose(got, twin, rtol=0, atol=1e-5)


def test_cmvn_work_counts_only_the_rows_the_output_needs():
    """``bounds.cmvn_work`` reads min(valid, T) rows an utterance: rows at
    and past valid may hold anything without changing ``cmvn``'s output,
    so they are not counted; the output is written whole."""
    from asr_dfcnn_transformer_torch import bounds
    from asr_dfcnn_transformer_torch.check_inputs import cmvn_inputs
    feat, valid = (torch.from_numpy(a) for a in cmvn_inputs(
        np.random.default_rng(3), 4, 23, 6, const_cols=(5,)))
    out = cmvn(feat, valid)
    needed = torch.arange(23)[None, :] < valid[:, None].long()
    noisy = torch.where(needed[..., None], feat, 1e4 * torch.rand(feat.shape))
    assert torch.equal(cmvn(noisy, valid), out)
    n_bytes, ops = bounds.cmvn_work(feat, valid, out)
    assert n_bytes == 4 * (int(needed.sum()) * 6 + 4 + out.numel())
    assert ops == {"f32": 6 * int(needed.sum()) * 6}
