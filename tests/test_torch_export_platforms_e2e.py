"""The e2e serving artifact exported on the CPU for both platforms
(``platforms=("cpu", "cuda")``), greedy and beam: the cases of
tests/test_torch_export_platforms.py for ``export_e2e``. The artifact
records both platforms and serves on the CPU the live ``E2EServing``'s ids
exactly; its start, step and finish programs pass the device-neutral
check; loading refuses a device it was not exported for and ``cuda``
where there is none."""

import copy

import numpy as np
import pytest
import torch

from asr_dfcnn_transformer_torch.core import vocab
from asr_dfcnn_transformer_torch.infer import (ArtifactE2EServing,
                                               export_e2e, load_artifact)
from asr_dfcnn_transformer_torch.infer import export_serving as es
from asr_dfcnn_transformer_torch.models import (SpeechTransformer,
                                                SpeechTransformerConfig)
from tests._torch_cpu import use_two_threads
from tests.test_torch_export_platforms import (BOTH, _check_device_neutral,
                                               _meta_trace, _programs)
from tests.test_torch_export_platforms import setup  # noqa: F401 (fixture)
from tests.test_torch_export_serving import (E2E_KW, E2E_MAX_LEN, E2E_NFILT,
                                             _live_e2e)

use_two_threads()


@pytest.fixture(scope="module")
def e2e(setup, tmp_path_factory):
    """decode -> (model, vocab, path, meta) of the small SpeechTransformer
    exported on the CPU for both platforms."""
    ev = vocab.e2e_language_vocab()
    model = SpeechTransformer(SpeechTransformerConfig(
        ev.size, dtype=torch.float32, **E2E_KW),
        feature_dim=4 * E2E_NFILT, device="cpu",
        generator=torch.Generator().manual_seed(1))
    out = {}
    for decode in ("greedy", "beam"):
        path = str(tmp_path_factory.mktemp("xplat_e2e") / f"{decode}.zip")
        out[decode] = model, ev, path, export_e2e(
            model, path, vocab=ev, **_e2e_kw(decode), platforms=BOTH)
    return out


def _e2e_kw(decode):
    return dict(feature_dim=E2E_NFILT, decode=decode, beam_width=2,
                max_len=E2E_MAX_LEN, batch_sizes=(4,), buckets=(128,))


@pytest.mark.parametrize("decode", ["greedy", "beam"])
def test_e2e_both_platforms_served_on_cpu_exactly(setup, e2e, decode):
    batch, _ = setup
    model, ev, path, meta = e2e[decode]
    assert meta["platforms"] == ["cpu", "cuda"] and meta["device"] == "cpu"
    served = load_artifact(path, device="cpu")
    assert isinstance(served, ArtifactE2EServing)
    live = _live_e2e(model, ev, decode, beam_width=2)
    got = served.recognize_batch(batch.signals, batch.signal_lengths)
    want = live.recognize_batch(batch.signals, batch.signal_lengths)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_e2e_cross_platform_artifact_agrees_with_jax_artifact(setup, e2e,
                                                             tmp_path):
    """The greedy artifact for both platforms, served on the CPU, and the
    JAX package's e2e artifact of the same weights, cross-lowered for the
    CPU and the TPU, give the same ids wherever each greedy step's top-2
    margin >= 1e-3."""
    import jax.numpy as jnp
    from asr_dfcnn_transformer_tpu import models as jm
    from asr_dfcnn_transformer_tpu.core import vocab as jax_vocab
    from asr_dfcnn_transformer_tpu.infer import export_serving as jes
    from asr_dfcnn_transformer_torch.audio.fbank import (FbankConfig,
                                                         batched_fbank)
    from asr_dfcnn_transformer_torch.audio.lfr import batched_lfr
    from asr_dfcnn_transformer_torch.models import speech_transformer as st
    from tests.test_torch_export_serving import MARGIN, _flax
    batch, _ = setup
    model, ev, path, _ = e2e["greedy"]
    jmodel = jm.SpeechTransformer(ev.size, dtype=jnp.float32,
                                  prenet_fused="einsum",
                                  fused_attention="einsum", **E2E_KW)
    jpath = str(tmp_path / "jax_e2e.asrx")
    jes.export_e2e(jmodel, _flax(model, "e2e"), jpath,
                   vocab=jax_vocab.e2e_language_vocab(),
                   feature_dim=E2E_NFILT, max_len=E2E_MAX_LEN,
                   batch_sizes=(4,), buckets=(128,),
                   platforms=("cpu", "tpu"))
    want = jes.load_artifact(jpath).recognize_batch(batch.signals,
                                                    batch.signal_lengths)
    got = load_artifact(path, device="cpu").recognize_batch(
        batch.signals, batch.signal_lengths)
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


@pytest.mark.parametrize("decode", ["greedy", "beam"])
def test_e2e_programs_are_device_neutral(e2e, decode):
    """Start, step and finish."""
    model, _, path, _ = e2e[decode]
    meta_model = copy.deepcopy(model).to("meta")
    _check_device_neutral(_programs(path), _meta_trace(
        lambda: es.e2e_programs(meta_model, **_e2e_kw(decode))))


def test_e2e_loading_refusals(setup, e2e, tmp_path, monkeypatch):
    model, ev, path, _ = e2e["greedy"]
    cpu_only = str(tmp_path / "e2e_cpu.zip")
    export_e2e(model, cpu_only, vocab=ev, **_e2e_kw("greedy"))
    with pytest.raises(ValueError, match="runs on cpu, the platforms"):
        load_artifact(cpu_only, device="cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ArtifactE2EServing.load(path, device)
