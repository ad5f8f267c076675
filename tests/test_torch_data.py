"""The port's host data layer (``audio/wav.py``, ``data/manifest.py``,
``data/synthetic.py``, ``data/loader.py``) and offline noise corpus tool
(``audio/noise_corpus.py``) against the JAX package's: the same files for
the same seed, the same manifests, the same ``AMBatch`` / ``LMBatch``
arrays from the same corpus, byte-identical noisy wavs and
``noise_data.txt``, and the loader's ``noise_root`` fallback (mirroring
tests/test_noise_corpus.py)."""

import dataclasses
import filecmp
import os

import numpy as np
import pytest

from asr_dfcnn_transformer_tpu.audio import noise_corpus as jax_nc
from asr_dfcnn_transformer_tpu.audio import wav as jax_wav
from asr_dfcnn_transformer_tpu.core import vocab as jax_vocab
from asr_dfcnn_transformer_tpu.data import DataLoader as JaxDataLoader
from asr_dfcnn_transformer_tpu.data import manifest as jax_manifest
from asr_dfcnn_transformer_tpu.data import (
    make_synthetic_corpus as jax_synthetic_corpus,
)
from asr_dfcnn_transformer_torch.audio import noise_corpus, wav
from asr_dfcnn_transformer_torch.core import vocab
from asr_dfcnn_transformer_torch.data import (AMBatch, DataLoader, LMBatch,
                                              generate_hanzi_dict,
                                              load_manifests,
                                              make_synthetic_corpus, prefetch,
                                              read_manifest)

CORPUS = dict(num_utts=6, num_classes=3, seed=3)


def _same_tree(a, b):
    """Every file under a and b, by relative path: the same names and the
    same bytes."""
    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)
    assert files(a) == files(b)
    for rel in files(a):
        assert filecmp.cmp(os.path.join(a, rel), os.path.join(b, rel),
                           shallow=False), rel


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """The synthetic corpus written by each package at the same seed."""
    port = str(tmp_path_factory.mktemp("port"))
    jax = str(tmp_path_factory.mktemp("jax"))
    return (make_synthetic_corpus(port, **CORPUS),
            jax_synthetic_corpus(jax, **CORPUS), port, jax)


def test_wav_matches_jax(tmp_path):
    sig = (0.4 * np.sin(np.arange(5000) / 7.0)).astype(np.float32)
    sig[10] = 1.5                                     # clipped
    wav.write_wav(str(tmp_path / "p.wav"), sig, 8000)
    jax_wav.write_wav(str(tmp_path / "j.wav"), sig, 8000)
    assert filecmp.cmp(tmp_path / "p.wav", tmp_path / "j.wav", shallow=False)
    got, rate = wav.read_wav(str(tmp_path / "p.wav"))
    want, _ = jax_wav.read_wav(str(tmp_path / "p.wav"))
    assert rate == 8000 and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    data = (tmp_path / "p.wav").read_bytes()
    np.testing.assert_array_equal(wav.read_wav_bytes(data)[0], want)
    wav.synth_wav(str(tmp_path / "ps.wav"), 0.3, seed=4)
    jax_wav.synth_wav(str(tmp_path / "js.wav"), 0.3, seed=4)
    assert filecmp.cmp(tmp_path / "ps.wav", tmp_path / "js.wav",
                       shallow=False)


def test_synthetic_corpus_matches_jax(corpora):
    (p_data, p_wav, p_syl, p_han), (j_data, j_wav, j_syl, j_han), port, jax \
        = corpora
    assert (p_syl, p_han) == (j_syl, j_han)
    _same_tree(port, jax)


@pytest.mark.parametrize("kw", [dict(), dict(shuffle=True, seed=2),
                                dict(data_length=4, batch_size=3)])
def test_manifests_match_jax(corpora, kw, tmp_path):
    (p_data, *_), (j_data, *_), _, _ = corpora
    for mode in ("train", "dev", "test"):
        got = load_manifests(p_data, mode, corpora=("thchs",), **kw)
        want = jax_manifest.load_manifests(j_data, mode, corpora=("thchs",),
                                           **kw)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    path = os.path.join(p_data, "thchs_train.txt")
    assert dataclasses.asdict(read_manifest(path)) == dataclasses.asdict(
        jax_manifest.read_manifest(path))
    m = load_manifests(p_data, "train", corpora=("thchs",))
    n = generate_hanzi_dict(m, str(tmp_path / "p.txt"))
    assert n == jax_manifest.generate_hanzi_dict(m, str(tmp_path / "j.txt"))
    assert filecmp.cmp(tmp_path / "p.txt", tmp_path / "j.txt", shallow=False)


def _loaders(p_data, p_wav, j_data, j_wav, **kw):
    port = DataLoader(load_manifests(p_data, "train", corpora=("thchs",)),
                      vocab.acoustic_vocab(), vocab.language_vocab(),
                      speech_root=p_wav, **kw)
    jax = JaxDataLoader(
        jax_manifest.load_manifests(j_data, "train", corpora=("thchs",)),
        jax_vocab.acoustic_vocab(), jax_vocab.language_vocab(),
        speech_root=j_wav, **kw)
    return port, jax


def _assert_batches_equal(got, want, cls):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert isinstance(g, cls)
        for field in dataclasses.fields(cls):
            a, b = getattr(g, field.name), getattr(w, field.name)
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype, field.name
                np.testing.assert_array_equal(a, b, err_msg=field.name)
            else:
                assert a == b, field.name


@pytest.mark.parametrize("shuffle", [False, True])
def test_loader_batches_match_jax(corpora, shuffle):
    (p_data, p_wav, _, _), (j_data, j_wav, _, _), _, _ = corpora
    port, jax = _loaders(p_data, p_wav, j_data, j_wav,
                         bucket_bounds=(100, 256))
    _assert_batches_equal(
        list(port.am_batches(4, shuffle=shuffle, seed=1)),
        list(jax.am_batches(4, shuffle=shuffle, seed=1)), AMBatch)
    _assert_batches_equal(
        list(port.lm_batches(4, shuffle=shuffle, seed=1)),
        list(jax.lm_batches(4, shuffle=shuffle, seed=1)), LMBatch)
    sig, ids, han = port.load_utterance(0)
    want = jax.load_utterance(0)
    np.testing.assert_array_equal(sig, want[0])
    assert (ids, han) == (want[1], want[2])


def test_loader_drops_unreadable_rows(corpora, tmp_path):
    """A row whose wav is missing or cannot be parsed is dropped, as in the
    JAX loader."""
    (p_data, p_wav, _, _), _, _, _ = corpora
    m = load_manifests(p_data, "train", corpora=("thchs",))
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"not a wav")
    m.paths[0], m.paths[1] = str(bad), "missing.wav"
    loader = DataLoader(m, vocab.acoustic_vocab(), vocab.language_vocab(),
                        speech_root=p_wav, bucket_bounds=(256,))
    batches = list(loader.am_batches(4, shuffle=False))
    assert sum(int(b.weights.sum()) for b in batches) == len(m) - 2
    with pytest.raises(ValueError):
        loader.load_utterance(0)


def test_prefetch_yields_in_order_and_raises():
    assert list(prefetch(iter(range(7)), depth=2)) == list(range(7))

    def broken():
        yield 1
        raise RuntimeError("boom")
    with pytest.raises(RuntimeError, match="boom"):
        list(prefetch(broken()))


def test_noise_corpus_matches_jax_and_loader_finds_it(tmp_path):
    """The same noisy wavs and noise_data.txt, byte for byte, as the JAX
    tool for the same seed; the port's loader finds them through its
    noise_root fallback."""
    roots = {}
    for name, make, gen, load in (
            ("port", make_synthetic_corpus, noise_corpus,
             load_manifests),
            ("jax", jax_synthetic_corpus, jax_nc,
             jax_manifest.load_manifests)):
        root = str(tmp_path / name)
        data_dir, wav_root, _, _ = make(root, **CORPUS)
        m = load(data_dir, "train", corpora=("thchs",))
        out_root = os.path.join(root, "noisy")
        n = gen.generate_noise_corpus(m, wav_root, out_root, data_dir,
                                      rate=0.7, n_per_utt=2, seed=5)
        roots[name] = (data_dir, out_root, n)
    assert roots["port"][2] == roots["jax"][2] > 0
    _same_tree(roots["port"][1], roots["jax"][1])
    assert filecmp.cmp(os.path.join(roots["port"][0], "noise_data.txt"),
                       os.path.join(roots["jax"][0], "noise_data.txt"),
                       shallow=False)
    data_dir, out_root, n = roots["port"]
    nm = load_manifests(data_dir, "train", corpora=(), use_noise=True)
    assert len(nm) == n
    loader = DataLoader(nm, vocab.acoustic_vocab(), vocab.language_vocab(),
                        speech_root="/nonexistent", noise_root=out_root,
                        bucket_bounds=(256,))
    batches = list(loader.am_batches(batch_size=3, shuffle=False))
    assert sum(int(b.weights.sum()) for b in batches) == n


def test_add_noise_to_file_matches_jax(corpora):
    (_, p_wav, _, _), _, port, _ = corpora
    src = os.path.join(p_wav, "train", "utt_0.wav")
    got = noise_corpus.add_noise_to_file(src, np.random.default_rng(0))
    want = jax_nc.add_noise_to_file(src, np.random.default_rng(0))
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    clean, _ = wav.read_wav(src)
    noisy, sr, snr, alpha = noise_corpus.add_noise_to_file(
        src, np.random.default_rng(1), snr_db=8)
    assert sr == 16000 and snr == 8 and -1.0 <= alpha <= 1.0
    diff = noisy - clean[: len(noisy)]
    measured = 10 * np.log10(np.mean(clean ** 2) / np.mean(diff ** 2))
    assert 6.0 < measured < 10.0


def test_noise_corpus_cli(tmp_path, capsys):
    data_dir, wav_root, _, _ = make_synthetic_corpus(
        str(tmp_path), num_utts=4, num_classes=2, seed=5)
    noise_corpus.main(["--data-dir", data_dir, "--speech-root", wav_root,
                       "--out-root", str(tmp_path / "out"), "--rate", "1.0"])
    assert "wrote 4 noisy utterances" in capsys.readouterr().out
