"""The port's serving artifacts (``infer/export_serving.py``): export ->
load -> the live ``Pipeline`` and the live ``E2EServing`` id for id
(padding, chunking, the no-LM artifact, the beam decodes), the JAX
package's artifacts of the same weights by the margin rule, the HTTP
server on an artifact backend, and a loader that imports no model code."""

import http.client
import json
import os
import subprocess
import sys
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_dfcnn_transformer_tpu import models as jm
from asr_dfcnn_transformer_tpu.core import vocab as jax_vocab
from asr_dfcnn_transformer_tpu.infer import Pipeline as JaxPipeline
from asr_dfcnn_transformer_tpu.infer import export_serving as jes
from asr_dfcnn_transformer_torch.convert import state_dict_to_flax
from asr_dfcnn_transformer_torch.core import vocab
from asr_dfcnn_transformer_torch.data import (DataLoader, load_manifests,
                                              make_synthetic_corpus)
from asr_dfcnn_transformer_torch.infer import (ArtifactE2EServing,
                                               E2EServing,
                                               HTTPRecognitionServer,
                                               Pipeline, ServingPipeline,
                                               export_e2e, export_pipeline,
                                               load_artifact)
from asr_dfcnn_transformer_torch.models import (SEDFCNN, SEDFCNNConfig,
                                                SpeechTransformer,
                                                SpeechTransformerConfig,
                                                TransformerLM,
                                                TransformerLMConfig)
from asr_dfcnn_transformer_torch.models import speech_transformer as st
from tests._torch_cpu import use_two_threads

use_two_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MARGIN = 1e-3
AM_KW = dict(stage_features=(4, 4, 8, 8, 8), se_ratio=(1, 2, 2, 2, 2),
             head_features=8, dropout_rate=0.0)
LM_KW = dict(d_model=32, num_heads=4, num_blocks=1, dropout_rate=0.0)
E2E_KW = dict(d_model=32, num_heads=4, num_enc_blocks=1, num_dec_blocks=1,
              prenet_channels=8, dropout_rate=0.0)
E2E_NFILT, E2E_MAX_LEN = 40, 8


def _flax(model, kind):
    """The port model's weights as JAX variables (convert.py's inverse
    bridge; tests/test_torch_*.py hold the forward bridge)."""
    return jax.tree.map(jnp.asarray, state_dict_to_flax(model.state_dict(),
                                                        kind))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A synthetic corpus batch, and a small SE-DFCNN + one-block LM in
    both packages on the same weights."""
    root = tmp_path_factory.mktemp("torchservcorpus")
    data_dir, wav_root, _, _ = make_synthetic_corpus(
        str(root), num_utts=8, num_classes=4, syllables_per_utt=(2, 3),
        tone_ms=200, seed=3)
    av, lv = vocab.acoustic_vocab(), vocab.language_vocab()
    m = load_manifests(data_dir, "test", corpora=("thchs",))
    dl = DataLoader(m, av, lv, speech_root=wav_root, bucket_bounds=(128,))
    batch = next(dl.am_batches(4, shuffle=False))
    gen = torch.Generator().manual_seed(0)
    am = SEDFCNN(SEDFCNNConfig(av.size, dtype=torch.float32, **AM_KW),
                 device="cpu", generator=gen)
    lm = TransformerLM(TransformerLMConfig(av.size, lv.size,
                                           dtype=torch.float32, **LM_KW),
                       device="cpu", generator=gen)
    pipe = Pipeline(am, lm, acoustic_vocab=av, language_vocab=lv)
    # the JAX models on the same weights, through the bridge's inverse
    jpipe = JaxPipeline(
        jm.SEDFCNN(vocab_size=av.size, dtype=jnp.float32, **AM_KW),
        _flax(am, "am"),
        jm.TransformerLM(av.size, lv.size, dtype=jnp.float32, **LM_KW),
        _flax(lm, "lm"), acoustic_vocab=jax_vocab.acoustic_vocab(),
        language_vocab=jax_vocab.language_vocab())
    return batch, pipe, jpipe


@pytest.fixture(scope="module")
def artifact(setup, tmp_path_factory):
    _, pipe, _ = setup
    path = str(tmp_path_factory.mktemp("torchartifact") / "pipeline.zip")
    meta = export_pipeline(pipe, path, batch_sizes=(2, 4), buckets=(128,))
    return path, meta, ServingPipeline.load(path)


def _margins_ok(pipe, batch):
    """[B] whether every valid frame of the port AM's logits has a top-2
    margin >= MARGIN (the card-vs-CPU rule of chip_smoke.py phases 4 and
    8: ids must agree there)."""
    from asr_dfcnn_transformer_torch.audio.fbank import batched_fbank
    from asr_dfcnn_transformer_torch.models import (frames_from_samples,
                                                    logit_lengths)
    with torch.no_grad():
        sig = torch.from_numpy(np.asarray(batch.signals, np.float32))
        lens = torch.from_numpy(np.asarray(batch.signal_lengths, np.int32))
        feats, _ = batched_fbank(sig, lens, out_frames=batch.bucket_frames)
        logits = pipe.am_model(feats[:, None])
        n = logit_lengths(frames_from_samples(lens), logits.shape[1])
    top2 = torch.topk(logits, 2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    valid = torch.arange(logits.shape[1])[None, :] < n[:, None]
    return ((margin >= MARGIN) | ~valid).all(dim=1).numpy()


def test_export_meta_and_roundtrip_exact(setup, artifact):
    batch, pipe, _ = setup
    path, meta, served = artifact
    assert meta["version"] == 1 and meta["has_lm"]
    assert meta["kind"] == "am_lm" and meta["device"] == "cpu"
    assert meta["platforms"] == ["cpu"]
    assert len(meta["programs"]) == 2            # 2 batch sizes x 1 bucket
    assert meta["acoustic_vocab"][-1] == "_"     # the blank is last
    assert set(meta["export_seconds"]) == {p["file"]
                                           for p in meta["programs"]}
    want = pipe.recognize_batch(batch.signals, batch.signal_lengths,
                                batch.bucket_frames)
    got = served.recognize_batch(batch.signals, batch.signal_lengths)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_artifact_holds_each_weight_once(artifact):
    """The weights are inputs of every program: no program holds a
    parameter as its state or as a constant."""
    path, meta, served = artifact
    n_params = sum(meta["param_groups"].values())
    ep = served.exported(4, 128)["file"]
    assert len(ep.state_dict) == 0
    assert sum(c.numel() for c in ep.constants.values()
               if isinstance(c, torch.Tensor)) < 1000
    assert len(ep.graph_signature.user_inputs) == n_params + 2
    with zipfile.ZipFile(path) as z:
        names = sorted(z.namelist())
    assert names == ["meta.json", "params.npz", "prog_b2_f128.pt2",
                     "prog_b4_f128.pt2"]


def test_serving_pads_small_batches(setup, artifact):
    batch, _, _ = setup
    served = artifact[2]
    full = served.recognize_batch(batch.signals, batch.signal_lengths)
    part = served.recognize_batch(batch.signals[:3], batch.signal_lengths[:3])
    assert part[0].shape[0] == 3
    for f, p in zip(full, part):
        np.testing.assert_array_equal(f[:3], p)


def test_serving_chunks_large_batches(setup, artifact):
    batch, _, _ = setup
    served = artifact[2]
    sig = np.concatenate([batch.signals, batch.signals])      # B 8 > max 4
    lens = np.concatenate([batch.signal_lengths, batch.signal_lengths])
    got = served.recognize_batch(sig, lens)
    assert got[0].shape[0] == 8
    for g in got:
        np.testing.assert_array_equal(g[:4], g[4:])
    with pytest.raises(ValueError, match="empty"):
        served.recognize_batch(sig[:0], lens[:0])


def test_serving_single_signal_decodes_strings(setup, artifact):
    batch, pipe, _ = setup
    served = artifact[2]
    n = int(batch.signal_lengths[0])
    assert served.recognize_signal(batch.signals[0][:n]) == \
        pipe.recognize_signal(batch.signals[0][:n], bucket_frames=128)


def test_port_artifact_agrees_with_jax_artifact(setup, artifact, tmp_path):
    """A JAX artifact and a port artifact of the same weights decode the
    same pinyin and hanzi wherever the AM's top-2 margin >= 1e-3."""
    batch, pipe, jpipe = setup
    jpath = str(tmp_path / "jax.asrx")
    jes.export_pipeline(jpipe, jpath, batch_sizes=(4,), buckets=(128,))
    want = jes.load_artifact(jpath).recognize_batch(batch.signals,
                                                    batch.signal_lengths)
    got = artifact[2].recognize_batch(batch.signals, batch.signal_lengths)
    ok = _margins_ok(pipe, batch)
    assert ok.sum() >= 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[ok], np.asarray(w)[ok])


def test_beam_artifact_equals_live(setup, tmp_path):
    batch, pipe, _ = setup
    beam = Pipeline(pipe.am_model, pipe.lm_model, acoustic_vocab=pipe.av,
                    language_vocab=pipe.lv, decode="beam", beam_width=4)
    path = str(tmp_path / "beam.zip")
    meta = export_pipeline(beam, path, batch_sizes=(4,), buckets=(128,))
    assert meta["decode"] == "beam" and meta["beam_width"] == 4
    got = load_artifact(path).recognize_batch(batch.signals,
                                              batch.signal_lengths)
    want = beam.recognize_batch(batch.signals, batch.signal_lengths, 128)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_serving_without_lm(setup, tmp_path):
    batch, pipe, _ = setup
    am_only = Pipeline(pipe.am_model, acoustic_vocab=pipe.av)
    path = str(tmp_path / "am_only.zip")
    meta = export_pipeline(am_only, path, batch_sizes=(2,), buckets=(128,))
    assert not meta["has_lm"] and meta["language_vocab"] is None
    assert list(meta["param_groups"]) == ["am"]
    served = load_artifact(path)
    got = served.recognize_batch(batch.signals[:2], batch.signal_lengths[:2])
    want = am_only.recognize_batch(batch.signals[:2],
                                   batch.signal_lengths[:2], 128)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] is None
    n = int(batch.signal_lengths[0])
    assert served.recognize_signal(batch.signals[0][:n])[1] == ""


def test_export_refusals(setup, artifact, tmp_path):
    """A platform other than the exporting device, a bfloat16 parameter,
    and loading on another device all raise with a message."""
    _, pipe, _ = setup
    with pytest.raises(ValueError, match="exported on"):
        export_pipeline(pipe, str(tmp_path / "x.zip"), batch_sizes=(1,),
                        buckets=(128,), platforms=("cuda",))
    with pytest.raises(ValueError, match="multiples of 8"):
        export_pipeline(pipe, str(tmp_path / "x.zip"), batch_sizes=(1,),
                        buckets=(100,))
    am16 = SEDFCNN(SEDFCNNConfig(pipe.av.size, dtype=torch.float32,
                                 **AM_KW), device="cpu").to(torch.bfloat16)
    with pytest.raises(ValueError, match="npz-portable"):
        export_pipeline(Pipeline(am16, acoustic_vocab=pipe.av),
                        str(tmp_path / "x.zip"), batch_sizes=(1,),
                        buckets=(128,))
    with pytest.raises(ValueError, match="runs on cpu"):
        load_artifact(artifact[0], device="cuda")
    with pytest.raises(ValueError, match="use load_artifact"):
        ArtifactE2EServing.load(artifact[0])


# ---- the e2e artifact --------------------------------------------------

@pytest.fixture(scope="module")
def e2e(setup):
    """A small SpeechTransformer in both packages on the same weights."""
    batch, _, _ = setup
    ev = vocab.e2e_language_vocab()
    model = SpeechTransformer(SpeechTransformerConfig(
        ev.size, dtype=torch.float32, **E2E_KW),
        feature_dim=4 * E2E_NFILT, device="cpu",
        generator=torch.Generator().manual_seed(1))
    jmodel = jm.SpeechTransformer(ev.size, dtype=jnp.float32,
                                  prenet_fused="einsum",
                                  fused_attention="einsum", **E2E_KW)
    variables = _flax(model, "e2e")
    return batch, ev, model, jmodel, variables


def _live_e2e(model, ev, decode, beam_width):
    return E2EServing(model, ev, feature_dim=E2E_NFILT, decode=decode,
                      beam_width=beam_width, max_len=E2E_MAX_LEN,
                      batch_sizes=(4,), buckets=(128,))


@pytest.fixture(scope="module")
def e2e_artifact(e2e, tmp_path_factory):
    """decode -> (meta, the loaded artifact) of the port's e2e artifact,
    each exported once."""
    _, ev, model, _, _ = e2e
    cache = {}

    def get(decode):
        if decode not in cache:
            path = str(tmp_path_factory.mktemp("e2e") / "e2e.zip")
            meta = export_e2e(model, path, vocab=ev, feature_dim=E2E_NFILT,
                              decode=decode, beam_width=2,
                              max_len=E2E_MAX_LEN, batch_sizes=(4,),
                              buckets=(128,))
            cache[decode] = meta, load_artifact(path)
        return cache[decode]
    return get


@pytest.mark.parametrize("decode", ["greedy", "beam"])
def test_e2e_artifact_equals_live(e2e, e2e_artifact, decode):
    batch, ev, model, _, _ = e2e
    meta, served = e2e_artifact(decode)
    assert meta["kind"] == "e2e" and meta["state_size"] == (
        5 if decode == "beam" else 4)
    assert set(meta["programs"][0]) >= {"file", "step", "finish"}
    assert isinstance(served, ArtifactE2EServing)
    live = _live_e2e(model, ev, decode, beam_width=2)
    got = served.recognize_batch(batch.signals, batch.signal_lengths)
    want = live.recognize_batch(batch.signals, batch.signal_lengths)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    n = int(batch.signal_lengths[0])
    assert served.recognize_signal(batch.signals[0][:n]) == \
        live.recognize_signal(batch.signals[0][:n])


def test_e2e_artifact_agrees_with_jax_artifact(e2e, e2e_artifact, tmp_path):
    """The JAX e2e artifact and the port's of the same weights give the
    same ids wherever each greedy step's top-2 margin >= 1e-3."""
    batch, ev, model, jmodel, variables = e2e
    _, served = e2e_artifact("greedy")
    jpath = str(tmp_path / "jax_e2e.asrx")
    jes.export_e2e(jmodel, variables, jpath,
                   vocab=jax_vocab.e2e_language_vocab(),
                   feature_dim=E2E_NFILT, max_len=E2E_MAX_LEN,
                   batch_sizes=(4,), buckets=(128,))
    want = jes.load_artifact(jpath).recognize_batch(batch.signals,
                                                    batch.signal_lengths)
    got = served.recognize_batch(batch.signals, batch.signal_lengths)
    from asr_dfcnn_transformer_torch.audio.fbank import (FbankConfig,
                                                         batched_fbank)
    from asr_dfcnn_transformer_torch.audio.lfr import batched_lfr
    margins = []
    with torch.no_grad():
        feats, valid = batched_fbank(
            torch.from_numpy(batch.signals),
            torch.from_numpy(batch.signal_lengths.astype(np.int32)),
            FbankConfig(nfilt=E2E_NFILT), out_frames=128)
        lfr, lfr_valid = batched_lfr(feats, valid, 4, 3)
        memory, mem_valid = model.encode(lfr[..., None], lfr_valid)
        st._greedy_cached(model, memory, mem_valid, E2E_MAX_LEN, margins)
    ok = (torch.stack(margins).min(dim=0).values >= MARGIN).numpy()
    assert ok.sum() >= 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[ok], np.asarray(w)[ok])


# ---- the HTTP server and the loader ------------------------------------

def _post(port, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    conn.request("POST", "/v1/recognize", body=body,
                 headers={"Content-Type": "application/octet-stream"})
    r = conn.getresponse()
    out = r.status, json.loads(r.read().decode())
    conn.close()
    return out


def test_http_artifact_backend(setup, artifact):
    """The HTTP server on a real artifact: results equal the live
    Pipeline's; streams stay refused."""
    batch, pipe, _ = setup
    served = artifact[2]
    with pytest.raises(ValueError, match="live Pipeline"):
        HTTPRecognitionServer(served, port=0, streams=1)
    with HTTPRecognitionServer(served, port=0) as srv:
        assert srv._backend.kind == "artifact"
        for i in range(2):
            sig = batch.signals[i][: int(batch.signal_lengths[i])]
            status, out = _post(srv.port, sig.astype("<f4").tobytes())
            assert status == 200
            assert (out["pinyin"], out["hanzi"]) == pipe.recognize_signal(
                sig, bucket_frames=128)


def test_load_artifact_imports_no_model_code(setup, artifact):
    """In a fresh process, load_artifact + recognize load no
    ``models`` / ``train`` module of the port, no JAX and nothing of the
    JAX package, and decode as the live pipeline."""
    batch, pipe, _ = setup
    n = int(batch.signal_lengths[0])
    sig_path = os.path.join(os.path.dirname(artifact[0]), "sig.npy")
    np.save(sig_path, batch.signals[0][:n])
    code = (
        "import json, sys, numpy as np\n"
        "from asr_dfcnn_transformer_torch.infer.export_serving import "
        "load_artifact\n"
        f"served = load_artifact({artifact[0]!r}, device='cpu')\n"
        f"out = served.recognize_signal(np.load({sig_path!r}))\n"
        "bad = sorted(m for m in sys.modules if m.startswith(("
        "'asr_dfcnn_transformer_torch.models', "
        "'asr_dfcnn_transformer_torch.train', "
        "'asr_dfcnn_transformer_tpu', 'jax', 'flax')))\n"
        "print(json.dumps({'bad': bad, 'out': out}))\n")
    r = subprocess.run([sys.executable, "-c", code],
                       env=dict(os.environ, PYTHONPATH=REPO),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    assert tuple(res["out"]) == pipe.recognize_signal(
        batch.signals[0][:n], bucket_frames=128)
