"""End-to-end speech Transformer recognition: the port of
``infer/export_serving.py``'s ``export_e2e`` program and ``E2EServing``.

The JAX package serves the e2e model from a ``jax.export`` artifact; here
``E2EServing`` is built from a port ``SpeechTransformer`` and the e2e vocab
and runs the same program per chunk, on the model's device: fbank (80 bins,
the ``log_mel`` and ``cmvn`` kernels) -> LFR stacking -> encoder (the
``dual_axis_attention`` and ``masked_attention`` kernels) -> KV-cached
greedy or beam decode. It keeps the artifact's defaults and its bucketing,
padding and chunking rules. Host-side callers hand in numpy arrays and get
numpy arrays back.
"""

from __future__ import annotations

import time
from typing import List, Sequence, Tuple

import numpy as np
import torch

from asr_dfcnn_transformer_torch.audio.fbank import (FbankConfig,
                                                     batched_fbank,
                                                     frames_for_samples,
                                                     samples_for_frames)
from asr_dfcnn_transformer_torch.audio.lfr import batched_lfr
from asr_dfcnn_transformer_torch.core.vocab import Vocab
from asr_dfcnn_transformer_torch.models.speech_transformer import (
    SpeechTransformer, beam_decode_cached, greedy_decode_cached)

DECODES = ("greedy", "beam")


def e2e_program(model: SpeechTransformer, signals: torch.Tensor,
                lengths: torch.Tensor, bucket_frames: int, *,
                fbank_cfg: FbankConfig, lfr_m: int, lfr_n: int, decode: str,
                beam_width: int, lp_alpha: float, max_len: int):
    """One padded batch (``export_e2e``'s ``fn_for_bucket``): signals
    [B, S] f32 and lengths [B] on the model's device -> (ids [B, max_len]
    int32, lengths [B] int32)."""
    feats, valid = batched_fbank(signals, lengths, cfg=fbank_cfg,
                                 out_frames=bucket_frames)
    lfr, lfr_valid = batched_lfr(feats, valid, lfr_m, lfr_n)
    if decode == "beam":
        ids, lens, _ = beam_decode_cached(model, lfr[..., None], lfr_valid,
                                          beam_size=beam_width,
                                          lp_alpha=lp_alpha, max_len=max_len)
        return ids, lens
    return greedy_decode_cached(model, lfr[..., None], lfr_valid,
                                max_len=max_len)


class E2EServing:
    """fbank -> LFR -> SpeechTransformer -> cached decode, served over
    fixed (batch, bucket) shapes as the JAX artifact serves them.

    A batch picks the smallest bucket that holds its longest signal (the
    last bucket truncates longer ones), is zero-padded to the smallest
    batch size that fits, and a batch above the largest size is served in
    chunks of it. ``chunk_ms`` holds the host wall time of each chunk of
    the last ``recognize_batch`` (ending in the device-to-host copy)."""

    def __init__(self, model: SpeechTransformer, vocab: Vocab, *,
                 feature_dim: int = 80, lfr_m: int = 4, lfr_n: int = 3,
                 decode: str = "greedy", beam_width: int = 3,
                 lp_alpha: float = 0.6, max_len: int = 64,
                 batch_sizes: Sequence[int] = (1, 8),
                 buckets: Sequence[int] = (128, 512, 1600)):
        if decode not in DECODES:
            raise ValueError(f"decode={decode!r}: expected one of {DECODES}")
        self.model = model.eval()
        self.language_vocab = vocab
        self.fbank_cfg = FbankConfig(nfilt=feature_dim)
        self.lfr_m, self.lfr_n = lfr_m, lfr_n
        self.decode = decode
        self.beam_width = beam_width
        self.lp_alpha = lp_alpha
        self.max_len = max_len
        self.batch_sizes = sorted(set(int(b) for b in batch_sizes))
        self.buckets = sorted(set(int(f) for f in buckets))
        self.device = next(model.parameters()).device
        self.chunk_ms: List[float] = []

    def _pick_bucket(self, frames: int) -> int:
        for f in self.buckets:
            if frames <= f:
                return f
        return self.buckets[-1]             # truncate overlong signals

    @torch.inference_mode()
    def _run_padded(self, signals: np.ndarray, lengths: np.ndarray):
        """One chunk (n <= the largest batch size): bucket, pad, run ->
        (ids [n, max_len], lengths [n]) numpy int32."""
        t0 = time.perf_counter()
        n = signals.shape[0]
        cfg = self.fbank_cfg
        bucket = self._pick_bucket(
            frames_for_samples(int(lengths.max()), cfg.win_len, cfg.hop))
        samples = samples_for_frames(bucket, cfg.win_len, cfg.hop)
        batch = next(b for b in self.batch_sizes if b >= n)
        buf = np.zeros((batch, samples), np.float32)
        m = min(signals.shape[1], samples)
        buf[:n, :m] = signals[:, :m]
        lens = np.zeros((batch,), np.int32)
        lens[:n] = np.minimum(lengths, samples)
        ids, out_len = e2e_program(
            self.model, torch.from_numpy(buf).to(self.device),
            torch.from_numpy(lens).to(self.device), bucket,
            fbank_cfg=cfg, lfr_m=self.lfr_m, lfr_n=self.lfr_n,
            decode=self.decode, beam_width=self.beam_width,
            lp_alpha=self.lp_alpha, max_len=self.max_len)
        out = ids[:n].cpu().numpy(), out_len[:n].cpu().numpy()
        self.chunk_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    def recognize_batch(self, signals: np.ndarray, lengths: np.ndarray
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """signals [B, S] float32 + lengths [B] -> (hanzi ids [B, max_len],
        lengths [B]), int32."""
        signals = np.asarray(signals, np.float32)
        lengths = np.asarray(lengths, np.int32)
        if signals.shape[0] == 0:
            raise ValueError("empty batch")
        self.chunk_ms = []
        step = self.batch_sizes[-1]
        outs = [self._run_padded(signals[i:i + step], lengths[i:i + step])
                for i in range(0, signals.shape[0], step)]
        return (np.concatenate([i for i, _ in outs]),
                np.concatenate([n for _, n in outs]))

    def recognize_signal(self, signal: np.ndarray) -> str:
        """One utterance -> hanzi string."""
        sig = np.asarray(signal, np.float32)[None, :]
        ids, lens = self.recognize_batch(
            sig, np.array([sig.shape[1]], np.int32))
        return "".join(self.language_vocab.decode(ids[0][:int(lens[0])]))
