"""The port's HTTP front end (``infer/http_server.py``), case for case as
tests/test_http_server.py holds the JAX one: recognition equal to the
direct ``Pipeline`` path, both body encodings, error statuses, health and
stats, request coalescing, the artifact-backend dispatch, and the
``/v1/stream`` routes equal to the incremental engine. (An artifact
backend serving a real port artifact is in test_torch_export_serving.py.)
"""

import http.client
import io
import json
import threading
import wave

import numpy as np
import pytest
import torch

from asr_dfcnn_transformer_torch.core import vocab
from asr_dfcnn_transformer_torch.data import (DataLoader, load_manifests,
                                              make_synthetic_corpus)
from asr_dfcnn_transformer_torch.infer import HTTPRecognitionServer, Pipeline
from asr_dfcnn_transformer_torch.infer.streaming import IncrementalRecognizer
from asr_dfcnn_transformer_torch.models import (SEDFCNN, SEDFCNNConfig,
                                                TransformerLM,
                                                TransformerLMConfig)
from tests._torch_cpu import use_two_threads

use_two_threads()


def _wav_bytes(signal: np.ndarray, rate: int = 16000) -> bytes:
    buf = io.BytesIO()
    pcm = (np.clip(signal, -1, 1) * 32767.0).astype(np.int16)
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())
    return buf.getvalue()


def _request(method: str, port: int, path: str, body: bytes = None,
             ctype: str = "audio/wav"):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    headers = {"Content-Type": ctype} if body is not None else {}
    conn.request(method, path, body=body, headers=headers)
    r = conn.getresponse()
    out = r.status, json.loads(r.read().decode())
    conn.close()
    return out


def _post(port, path, body, ctype="audio/wav"):
    return _request("POST", port, path, body, ctype)


def _get(port, path):
    return _request("GET", port, path)


def _delete(port, path):
    return _request("DELETE", port, path)


def _f32(x: np.ndarray) -> bytes:
    return x.astype("<f4").tobytes()


def _quantized(sig: np.ndarray) -> np.ndarray:
    """The signal as the server reads it back from a 16-bit wav body."""
    return (np.clip(sig, -1, 1) * 32767.0).astype(np.int16).astype(
        np.float32) / 32768.0


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("torchhttpcorpus")
    data_dir, wav_root, _, _ = make_synthetic_corpus(
        str(root), num_utts=8, num_classes=4, syllables_per_utt=(2, 3),
        tone_ms=200, seed=3)
    av, lv = vocab.acoustic_vocab(), vocab.language_vocab()
    m = load_manifests(data_dir, "test", corpora=("thchs",))
    dl = DataLoader(m, av, lv, speech_root=wav_root, bucket_bounds=(128,))
    gen = torch.Generator().manual_seed(0)
    am = SEDFCNN(SEDFCNNConfig(av.size, stage_features=(4, 4, 8, 8, 8),
                               se_ratio=(1, 2, 2, 2, 2), head_features=8,
                               dropout_rate=0.0, dtype=torch.float32),
                 device="cpu", generator=gen)
    lm = TransformerLM(TransformerLMConfig(av.size, lv.size, d_model=32,
                                           num_heads=4, num_blocks=1,
                                           dropout_rate=0.0,
                                           dtype=torch.float32),
                       device="cpu", generator=gen)
    pipe = Pipeline(am, lm, acoustic_vocab=av, language_vocab=lv)
    batch = next(dl.am_batches(8, shuffle=False))
    signals = [np.asarray(batch.signals[i][: batch.signal_lengths[i]])
               for i in range(8) if batch.weights[i] > 0]
    srv = HTTPRecognitionServer(pipe, port=0, max_batch=4, max_wait_ms=30.0,
                                bucket_bounds=(128,))
    srv.start()
    yield pipe, signals, srv
    srv.close()


def test_http_recognize_matches_direct(setup):
    pipe, signals, srv = setup
    for sig in signals[:3]:
        status, out = _post(srv.port, "/v1/recognize", _wav_bytes(sig))
        assert status == 200
        want_p, want_h = pipe.recognize_signal(_quantized(sig),
                                               bucket_frames=128)
        assert out["pinyin"] == want_p and out["hanzi"] == want_h
        assert out["seconds"] == pytest.approx(len(sig) / 16000, abs=1e-3)


def test_http_raw_f32_body(setup):
    pipe, signals, srv = setup
    status, out = _post(srv.port, "/v1/recognize", _f32(signals[0]),
                        ctype="application/octet-stream")
    assert status == 200
    assert (out["pinyin"], out["hanzi"]) == pipe.recognize_signal(
        signals[0], bucket_frames=128)


def test_http_concurrent_requests_coalesce(setup):
    pipe, signals, srv = setup
    before = srv._backend.stats()
    results = [None] * len(signals)

    def worker(i):
        results[i] = _post(srv.port, "/v1/recognize", _f32(signals[i]),
                           ctype="application/octet-stream")

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(signals))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    for (status, out), sig in zip(results, signals):
        assert status == 200
        assert (out["pinyin"], out["hanzi"]) == pipe.recognize_signal(
            sig, bucket_frames=128)
    after = srv._backend.stats()
    n = len(signals)
    assert after["requests"] - before["requests"] == n
    assert after["batches"] - before["batches"] < n


def test_http_health_and_stats(setup):
    _, _, srv = setup
    status, out = _get(srv.port, "/healthz")
    assert status == 200 and out == {"status": "ok", "backend": "live",
                                     "streaming": False}
    status, out = _get(srv.port, "/v1/stats")
    assert status == 200 and out["requests"] >= 1
    assert 0 < out["mean_occupancy"] <= 1
    assert out["per_bucket"]["128"] >= 1


def test_http_error_statuses(setup):
    _, signals, srv = setup
    status, out = _post(srv.port, "/v1/recognize", b"not a wav at all")
    assert status == 400 and "error" in out
    status, out = _post(srv.port, "/v1/recognize",
                        _wav_bytes(signals[0], rate=8000))
    assert status == 400 and "8000" in out["error"]
    status, out = _post(srv.port, "/v1/recognize", b"")
    assert status == 400
    status, out = _post(srv.port, "/nope", _wav_bytes(signals[0]))
    assert status == 404
    status, out = _get(srv.port, "/nope")
    assert status == 404
    status, out = _delete(srv.port, "/v1/stream/x")
    assert status == 404


def test_http_artifact_backend_dispatch():
    """A stub artifact pins the HTTP-level dispatch: no BatchingServer,
    pinyin + hanzi JSON, request counting."""
    class StubServed:
        def recognize_signal(self, sig):
            return ["ni3", "hao3"], "你好"

    with HTTPRecognitionServer(StubServed(), port=0) as srv:
        assert srv._backend.kind == "artifact"
        status, out = _post(srv.port, "/v1/recognize",
                            _wav_bytes(np.zeros(1600, np.float32)))
        assert status == 200
        assert out["pinyin"] == ["ni3", "hao3"] and out["hanzi"] == "你好"
        assert _get(srv.port, "/healthz")[1]["backend"] == "artifact"
        assert _get(srv.port, "/v1/stats")[1] == {"requests": 1}
        assert srv.requests_served == 1


def test_cli_serve_requires_workdir_or_artifact():
    from asr_dfcnn_transformer_torch.train import cli
    with pytest.raises(SystemExit):
        cli.main(["serve", "--max-requests", "1", "--platform", "cpu"])
    with pytest.raises(SystemExit, match="streams"):
        cli.main(["serve", "--artifact", "a.zip", "--streams", "2",
                  "--platform", "cpu"])


def test_http_streaming_roundtrip(setup):
    """Open, push raw f32 chunks, finish: the final hypothesis equals the
    single-stream incremental engine's."""
    pipe, signals, _ = setup
    sig = signals[0]
    cut = len(sig) // 2
    chunks = [sig[:cut], sig[cut:]]
    rec = IncrementalRecognizer(pipe, cmvn="running")
    for c in chunks:
        rec.push(c)
    want = rec.finalize()
    with HTTPRecognitionServer(pipe, port=0, streams=2) as srv:
        status, out = _post(srv.port, "/v1/stream", b"",
                            ctype="application/octet-stream")
        assert status == 200 and "stream" in out
        tok = out["stream"]
        status, out = _post(srv.port, f"/v1/stream/{tok}?partial=0",
                            _f32(chunks[0]), ctype="application/octet-stream")
        assert status == 200 and out == {"ok": True}
        status, out = _post(srv.port, f"/v1/stream/{tok}", _f32(chunks[1]),
                            ctype="application/octet-stream")
        assert status == 200 and out["final"] is False
        assert isinstance(out["pinyin"], list)
        status, out = _post(srv.port, f"/v1/stream/{tok}/finish", b"",
                            ctype="application/octet-stream")
        assert status == 200 and out["final"] is True
        assert (out["pinyin"], out["hanzi"]) == want
        status, _ = _post(srv.port, f"/v1/stream/{tok}", _f32(chunks[0]),
                          ctype="application/octet-stream")
        assert status == 404
        assert _get(srv.port, "/v1/stats")[1]["streams"]["finished"] == 1
        assert _get(srv.port, "/healthz")[1]["streaming"] is True


def test_http_streaming_finish_with_tail_and_abort(setup):
    pipe, signals, _ = setup
    sig = signals[1]
    cut = len(sig) * 2 // 3
    oct_ = "application/octet-stream"
    with HTTPRecognitionServer(pipe, port=0, streams=2) as srv:
        tok = _post(srv.port, "/v1/stream", b"")[1]["stream"]
        _post(srv.port, f"/v1/stream/{tok}?partial=0", _f32(sig[:cut]), oct_)
        status, via_tail = _post(srv.port, f"/v1/stream/{tok}/finish",
                                 _f32(sig[cut:]), oct_)
        assert status == 200 and via_tail["final"] is True
        tok2 = _post(srv.port, "/v1/stream", b"")[1]["stream"]
        _post(srv.port, f"/v1/stream/{tok2}?partial=0", _f32(sig[:cut]),
              oct_)
        _post(srv.port, f"/v1/stream/{tok2}?partial=0", _f32(sig[cut:]),
              oct_)
        status, via_push = _post(srv.port, f"/v1/stream/{tok2}/finish", b"")
        assert status == 200
        assert (via_push["pinyin"], via_push["hanzi"]) == \
            (via_tail["pinyin"], via_tail["hanzi"])
        tok3 = _post(srv.port, "/v1/stream", b"")[1]["stream"]
        assert _delete(srv.port, f"/v1/stream/{tok3}") == (200, {"ok": True})
        assert _delete(srv.port, f"/v1/stream/{tok3}")[0] == 404


def test_http_streaming_errors(setup):
    pipe, _, srv0 = setup
    status, out = _post(srv0.port, "/v1/stream", b"")
    assert status == 404 and "disabled" in out["error"]
    with HTTPRecognitionServer(pipe, port=0, streams=1,
                               stream_kw={"max_stream_seconds": 0.05}) as srv:
        status, _ = _post(srv.port, "/v1/stream/unknowntoken",
                          _f32(np.zeros(100)), "application/octet-stream")
        assert status == 404
        tok = _post(srv.port, "/v1/stream", b"")[1]["stream"]
        status, _ = _post(srv.port, f"/v1/stream/{tok}", b"abc",
                          "application/octet-stream")
        assert status == 400                    # not float32 samples
        status, out = _post(srv.port, f"/v1/stream/{tok}",
                            _f32(np.zeros(1600)), "application/octet-stream")
        assert status == 400 and "max_stream_seconds" in out["error"]
        assert _post(srv.port, "/v1/stream", b"")[0] == 503   # slots busy
        assert _post(srv.port, "/v1/stream", b"\x00" * 8)[0] == 400
        status, _ = _post(srv.port, f"/v1/stream/{tok}/nope", b"")
        assert status == 404


def test_http_streaming_requires_live_backend():
    class StubServed:
        def recognize_signal(self, sig):
            return ["a1"], "a"

    with pytest.raises(ValueError, match="live Pipeline"):
        HTTPRecognitionServer(StubServed(), port=0, streams=2)
