"""The port's native wav decoder (``data/native_loader.py``, a build of
``csrc/wavio.cc``) against the JAX package's native decoder and the port's
Python decoder: probe, batch decode, a bad file, truncation and a malformed
bit depth (tests/test_native_loader.py's cases), bit for bit (the Python
decoder aside on the 4-bit file, which it reads as 8-bit); the source is
the JAX package's ``native/wavio.cc``; a failed build raises."""

import os
import wave

import numpy as np
import pytest

from asr_dfcnn_transformer_tpu.data import native_loader as jax_native
from asr_dfcnn_transformer_torch.audio.wav import write_wav
from asr_dfcnn_transformer_torch.data import native_loader
from tests._torch_cpu import use_two_threads
from tests.test_native_loader import _wav_bytes_with_bits

use_two_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    d = tmp_path_factory.mktemp("wavs")
    rng = np.random.default_rng(0)
    paths = []
    for i in range(8):
        p = str(d / f"f{i}.wav")
        write_wav(p, (0.3 * rng.standard_normal(8000 + 500 * i)
                      ).astype(np.float32), 16000)
        paths.append(p)
    bad = str(d / "not_a_wav.wav")
    with open(bad, "wb") as f:
        f.write(b"garbage data that is not RIFF")
    odd = []
    for bits in (4, 24):
        odd.append(str(d / f"b{bits}.wav"))
        with open(odd[-1], "wb") as f:
            f.write(_wav_bytes_with_bits(bits))
    return dict(good=paths, bad=bad, odd=odd)


def test_source_is_the_jax_packages():
    with open(os.path.join(REPO, "native", "wavio.cc"), "rb") as f:
        assert native_loader.SOURCE.read_bytes() == f.read()


def test_probe_matches_python_and_jax(wavs):
    assert native_loader.available()
    for p in wavs["good"]:
        with wave.open(p, "rb") as w:
            want = (w.getnframes(), w.getframerate())
        assert native_loader.probe(p) == want == jax_native.probe(p)
    for p in [wavs["bad"]] + wavs["odd"]:
        with pytest.raises(IOError):
            native_loader.probe(p)


@pytest.mark.parametrize("max_samples", [16000, 1000])
def test_decode_batch_matches_python_and_jax(wavs, max_samples):
    """Every case in one batch: good files, a non-RIFF file, 4- and 24-bit
    headers (rejected, not a crash), and truncation at ``max_samples``."""
    paths = [wavs["good"][0], wavs["bad"]] + wavs["odd"] + wavs["good"][1:]
    out, lengths = native_loader.decode_batch(paths, max_samples)
    py_out, py_len = native_loader.decode_batch(paths, max_samples,
                                                decoder="python")
    jx_out, jx_len = jax_native.decode_batch(paths, max_samples)
    assert out.shape == (len(paths), max_samples) and out.dtype == np.float32
    np.testing.assert_array_equal(lengths, jx_len)
    np.testing.assert_array_equal(out, jx_out)
    assert list(lengths[1:4]) == [-1, -1, -1] and not out[1:4].any()
    # the Python decoder reads the 4-bit header as 8-bit PCM (``wave``
    # rounds the width up to a byte); every other row is the same
    assert py_len[2] == 64
    same = np.arange(len(paths)) != 2
    np.testing.assert_array_equal(lengths[same], py_len[same])
    np.testing.assert_array_equal(out[same], py_out[same])
    assert min(lengths[4:]) == min(8500, max_samples)


def test_decoder_choice_is_checked(wavs):
    with pytest.raises(ValueError, match="decoder"):
        native_loader.decode_batch(wavs["good"], 100, decoder="wave")


def test_build_failure_raises_with_the_compilers_output(tmp_path,
                                                       monkeypatch):
    """``CXX`` names the compiler, as native/Makefile reads it; a missing
    one fails the build (into an empty build directory) with a
    RuntimeError that carries the command."""
    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setattr(native_loader, "BUILD_ROOT", tmp_path)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="building the wav decoder.*"
                                           "no-such-compiler"):
        native_loader.decode_batch([], 10)
