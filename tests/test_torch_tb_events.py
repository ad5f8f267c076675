"""The port's TensorBoard event writer (``utils/tb_events.py``) against the
JAX package's: CRC32C known answers, the masked CRC and varints, PNG round
trips, files whose records equal the JAX writer's, read back through the
``tensorboard`` package's own loader and through the port's CRC-checking
``read_events``; the ``MetricWriter`` tee, the e2e trainer's attention
images, and the CLI's ``--tensorboard`` on the training commands."""

import glob
import io
import json
import os

import numpy as np
import pytest
import torch

from asr_dfcnn_transformer_tpu.utils import tb_events as jtb
from asr_dfcnn_transformer_torch.train import cli
from asr_dfcnn_transformer_torch.train.trainer import MetricWriter
from asr_dfcnn_transformer_torch.utils.tb_events import (TBEventWriter,
                                                         _crc32c,
                                                         _masked_crc,
                                                         _varint, png_encode)
from tests._torch_cpu import use_two_threads

use_two_threads()


def test_crc32c_known_answers():
    # RFC 3720 / Castagnoli test vectors
    assert _crc32c(b"") == 0x00000000
    assert _crc32c(b"123456789") == 0xE3069283
    assert _crc32c(bytes(32)) == 0x8A9136AA
    assert _crc32c(bytes([0xFF] * 32)) == 0x62A8AB43
    c = _crc32c(b"123456789")
    want = ((((c >> 15) | (c << 17)) & 0xFFFFFFFF) + 0xA282EAD8) & 0xFFFFFFFF
    assert _masked_crc(b"123456789") == want
    data = np.random.default_rng(0).bytes(1000)
    assert _crc32c(data) == jtb._crc32c(data)


@pytest.mark.parametrize("n", [0, 1, 127, 128, 300, 2 ** 35 + 7])
def test_varint_matches_jax(n):
    assert _varint(n) == jtb._varint(n)
    assert _varint(300) == b"\xac\x02"


def test_png_roundtrip_gray_rgb_and_float():
    pil = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(0)
    gray = rng.integers(0, 255, (33, 47), dtype=np.uint8)
    np.testing.assert_array_equal(
        np.array(pil.open(io.BytesIO(png_encode(gray)))), gray)
    rgb = rng.integers(0, 255, (16, 24, 3), dtype=np.uint8)
    np.testing.assert_array_equal(
        np.array(pil.open(io.BytesIO(png_encode(rgb)))), rgb)
    f = np.linspace(-1.0, 1.0, 64).reshape(8, 8)
    arr = np.array(pil.open(io.BytesIO(png_encode(f))))
    assert arr.min() == 0 and arr.max() == 255
    for img in (gray, rgb, f):
        assert png_encode(img) == jtb.png_encode(img)


def _load_events(path):
    """Raw events through tensorboard's own reader (its default loader
    would migrate the legacy summaries to tensors and hide a fault)."""
    tb_loader = pytest.importorskip(
        "tensorboard.backend.event_processing.event_file_loader")
    event_pb2 = pytest.importorskip("tensorboard.compat.proto.event_pb2")
    return [event_pb2.Event.FromString(r)
            for r in tb_loader.RawEventFileLoader(path).Load()]


def _records(path):
    """(step, tag, simple_value or None) of every summary value."""
    return [(e.step, v.tag, v.simple_value if v.HasField("simple_value")
             else None) for e in _load_events(path)[1:]
            for v in e.summary.value]


def test_scalars_and_images_roundtrip_and_match_jax(tmp_path):
    img = (np.arange(64 * 48).reshape(64, 48) % 251).astype(np.uint8)
    paths = []
    for mod, name in ((jtb, "jax"), (None, "port")):
        w = (mod.TBEventWriter if mod else TBEventWriter)(
            str(tmp_path / name))
        w.scalar("train/loss", 3.25, step=7)
        w.scalar("train/acc", 0.5, step=7)
        w.image("attn/enc0", img, step=9)
        w.close()
        paths.append(w.path)
    evs = _load_events(paths[1])
    assert evs[0].file_version == "brain.Event:2"
    scalars = {(s, t): v for s, t, v in _records(paths[1]) if v is not None}
    assert scalars == {(7, "train/loss"): 3.25, (7, "train/acc"): 0.5}
    im = [v.image for e in evs[1:] for v in e.summary.value
          if v.HasField("image")][0]
    assert (im.height, im.width, im.colorspace) == (64, 48, 1)
    assert im.encoded_image_string == png_encode(img)
    # the same records as the JAX writer's, wall times aside
    assert _records(paths[0]) == _records(paths[1])


def test_unused_writer_leaves_no_file(tmp_path):
    w = TBEventWriter(str(tmp_path / "tb"))
    w.close()
    assert not os.path.exists(tmp_path / "tb")


def test_metric_writer_tee_matches_jax(tmp_path):
    from asr_dfcnn_transformer_tpu.train.trainer import (
        MetricWriter as JaxMetricWriter)
    paths = []
    for cls, name in ((JaxMetricWriter, "jax"), (MetricWriter, "port")):
        mw = cls(str(tmp_path / name), "am")
        mw.write(1, epoch=0, split="train", loss=2.5, wer=0.9)
        mw.enable_tensorboard()
        mw.write(2, epoch=0, split="dev", loss=1.5, wer=0.7, note="text")
        mw.write(3, loss=float("nan"), acc=torch.tensor(0.25))
        with open(mw.path) as f:
            assert [json.loads(x)["step"] for x in f] == [1, 2, 3]
        paths.append(mw.tb.path)
        assert mw.tb.path.startswith(str(tmp_path / name / "tb" / "am"))
    got = _records(paths[1])
    assert got == [(2, "am/dev/loss", pytest.approx(1.5)),
                   (2, "am/dev/wer", pytest.approx(0.7)),
                   (3, "am/acc", 0.25)]
    assert got == _records(paths[0])


def test_e2e_trainer_writes_attention_images(tmp_path):
    from asr_dfcnn_transformer_torch.core import vocab
    from asr_dfcnn_transformer_torch.data import (DataLoader, load_manifests,
                                                  make_synthetic_corpus)
    from asr_dfcnn_transformer_torch.models import (SpeechTransformer,
                                                    SpeechTransformerConfig)
    from asr_dfcnn_transformer_torch.train import E2ETrainer
    data_dir, wav_root, _, _ = make_synthetic_corpus(
        str(tmp_path / "corpus"), num_utts=8, num_classes=4,
        syllables_per_utt=(2, 3), tone_ms=200, seed=1)
    ev = vocab.e2e_language_vocab()
    loader = DataLoader(load_manifests(data_dir, "train", corpora=("thchs",)),
                        vocab.acoustic_vocab(), ev, speech_root=wav_root,
                        bucket_bounds=(128,))
    model = SpeechTransformer(SpeechTransformerConfig(
        ev.size, d_model=32, num_heads=4, num_enc_blocks=1, num_dec_blocks=1,
        prenet_channels=8, dropout_rate=0.0, dtype=torch.float32),
        feature_dim=4 * 40, device="cpu")
    tr = E2ETrainer(model, str(tmp_path / "wd"), lr=1e-3, feature_dim=40)
    tr.enable_tensorboard()
    batches = lambda: loader.am_batches(batch_size=4, shuffle=False)  # noqa
    tr.fit(batches, epochs=1, dev_batches=batches)
    evs = _load_events(tr.metrics.tb.path)
    tags = [v.tag for e in evs[1:] for v in e.summary.value]
    assert any(t.startswith("e2e/train/") for t in tags)
    assert any(t.startswith("e2e/dev/") for t in tags)
    images = {v.tag: v.image for e in evs[1:] for v in e.summary.value
              if v.HasField("image")}
    assert images and all(t.startswith("e2e/attention/") for t in images)
    # one image a captured module: the decoder's self and cross attention
    assert any("dec" in t for t in images), sorted(images)


@pytest.mark.parametrize("cmd", ["am", "lm", "atten", "e2e", "joint"])
def test_cli_tensorboard_flag(tmp_path, cmd):
    wd = str(tmp_path / "wd")
    cli.main([cmd, "--workdir", wd, "--synthetic", "16", "--small",
              "--epochs", "1", "--batch-size", "8", "--lr", "1e-3",
              "--platform", "cpu", "--tensorboard"])
    files = glob.glob(os.path.join(wd, "tb", cmd, "events.out.tfevents.*"))
    assert len(files) == 1
    tags = [t for _, t, _ in _records(files[0])]
    assert any(t.startswith(f"{cmd}/train/") for t in tags), tags
    assert any(t.startswith(f"{cmd}/dev/") for t in tags), tags


def test_read_events_matches_tensorboard_and_checks_crcs(tmp_path):
    """``read_events`` (what the card's machine, which has no tensorboard
    package, reads back) gives tensorboard's own records and refuses a
    file with a flipped bit."""
    from asr_dfcnn_transformer_torch.utils.tb_events import read_events
    w = TBEventWriter(str(tmp_path))
    w.scalar("a/loss", 1.25, step=3)
    img = (np.arange(12 * 5).reshape(12, 5) % 7).astype(np.uint8)
    w.image("e2e/attention/x", img, step=4)
    w.scalar("a/acc", 0.5, step=5)
    w.close()
    evs = read_events(w.path)
    assert evs[0]["file_version"] == "brain.Event:2"
    got = [(e["step"], v["tag"], v.get("simple_value"))
           for e in evs[1:] for v in e["values"]]
    assert got == _records(w.path)
    im = [v["image"] for e in evs for v in e["values"] if "image" in v][0]
    assert (im["height"], im["width"], im["colorspace"]) == (12, 5, 1)
    assert im["png"] == png_encode(img)
    data = bytearray(open(w.path, "rb").read())
    data[len(data) // 2] ^= 0x10
    bad = tmp_path / "bad.tfevents"
    bad.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        read_events(str(bad))


def test_profile_steps_write_a_trace(tmp_path):
    """``profile_steps`` > 0 traces the first steps of ``AMTrainer.fit``
    with ``torch.profiler`` into ``<workdir>/profile/trace.json``, once."""
    from asr_dfcnn_transformer_torch.data import AMBatch
    from asr_dfcnn_transformer_torch.train import AMTrainer
    from tests.test_torch_train import _am_arrays, _tiny_am
    batches = [AMBatch(**_am_arrays(s)) for s in (0, 1, 2)]
    tr = AMTrainer(_tiny_am(), str(tmp_path), lr=1e-3)
    tr.profile_steps = 2
    tr.fit(lambda: iter(batches), lambda: iter(batches[:1]), epochs=1)
    path = tmp_path / "profile" / "trace.json"
    trace = json.loads(path.read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("conv" in n for n in names), sorted(names)[:20]
    assert tr.profile_steps == 0 and tr._profiler is None
