"""Batched AM -> LM recognition: the port of ``infer/pipeline.py``.

One batch runs fbank (the ``log_mel`` and ``cmvn`` kernels) -> SE-DFCNN ->
CTC decode capped at the LM's positions (greedy, or the prefix beam search
on the ``topk_last`` and ``beam_search`` kernels) -> Transformer LM (the
``masked_attention`` kernel in every block) -> argmax, on the models'
device. Host-side callers hand in numpy arrays and get numpy arrays back.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from asr_dfcnn_transformer_torch.audio.fbank import (FbankConfig,
                                                     batched_fbank,
                                                     frames_for_samples,
                                                     samples_for_frames)
from asr_dfcnn_transformer_torch.core import constants
from asr_dfcnn_transformer_torch.core.vocab import Vocab
from asr_dfcnn_transformer_torch.models.dfcnn import (frames_from_samples,
                                                      logit_lengths)
from asr_dfcnn_transformer_torch.ops.ctc_decode import (ctc_beam_search_decode,
                                                        ctc_greedy_decode)

DECODES = ("greedy", "beam")


def pipeline_program(am_model, lm_model, signals: torch.Tensor,
                     signal_lengths: torch.Tensor, bucket_frames: int, *,
                     fbank_cfg: FbankConfig, decode: str, beam_width: int,
                     lm_max_len: int):
    """fbank -> AM -> CTC decode -> LM argmax on one padded batch.

    ``decode`` "greedy" or "beam" (W = K = ``beam_width``, blank last).

    signals [B, S] f32 and signal_lengths [B] on the models' device ->
    (pinyin ids [B, lm_max_len] int32, pinyin lengths [B] int32, hanzi ids
    [B, lm_max_len] int32 or None without an LM; zero past each length).
    """
    feats, _ = batched_fbank(signals, signal_lengths, cfg=fbank_cfg,
                             out_frames=bucket_frames)
    logits = am_model(feats[:, None])
    in_len = logit_lengths(frames_from_samples(signal_lengths),
                           logits.shape[1])
    if decode == "beam":
        pny_ids, pny_len, _ = ctc_beam_search_decode(
            logits, in_len, beam_width=beam_width, topk=beam_width,
            blank_id=-1, max_decode_len=lm_max_len)
    else:
        pny_ids, pny_len = ctc_greedy_decode(logits, in_len, blank_id=-1,
                                             max_output_len=lm_max_len)
    han_ids = None
    if lm_model is not None:
        # the decoded dense pinyin ids go straight into the LM; 0 = PAD
        lm_logits = lm_model(pny_ids.to(torch.int64))
        han_ids = torch.argmax(lm_logits, dim=-1).to(torch.int32)
        pos = torch.arange(han_ids.shape[1], device=han_ids.device)
        han_ids = torch.where(pos[None, :] < pny_len[:, None], han_ids, 0)
    return pny_ids, pny_len, han_ids


def infer_bucket_frames(frames: int) -> int:
    """The single-utterance bucket: frames ceil'd to 128, capped at
    FEATURE_MAX_LENGTH (shared with the JAX package's streaming finalize)."""
    return min(constants.FEATURE_MAX_LENGTH,
               ((max(frames, 1) + 127) // 128) * 128)


class Pipeline:
    """AM (fbank -> pinyin CTC) + LM (pinyin -> hanzi) inference.

    Args:
      am_model: the port's ``SEDFCNN`` (its device is the pipeline's).
      lm_model: the port's ``TransformerLM`` on the same device, or None
        (then only pinyin comes back).
      decode: "greedy" (``tf.nn.ctc_greedy_decoder`` parity) or "beam"
        (the prefix beam search, ``beam_width`` beams and extensions).
    """

    def __init__(self, am_model, lm_model=None, *, acoustic_vocab: Vocab,
                 language_vocab: Optional[Vocab] = None,
                 feature_dim: int = 200, decode: str = "greedy",
                 beam_width: int = 8, lm_max_len: Optional[int] = None):
        if decode not in DECODES:
            raise ValueError(f"decode={decode!r}: expected one of {DECODES}")
        self.am_model = am_model.eval()
        self.lm_model = lm_model.eval() if lm_model is not None else None
        self.av = acoustic_vocab
        self.lv = language_vocab
        self.fbank_cfg = FbankConfig(nfilt=feature_dim)
        self.decode = decode
        self.beam_width = beam_width
        if lm_max_len is None:
            # decode up to the LM's position cap (the reference feeds the
            # whole decoded sequence to the LM); the 64-label training cap
            # without an LM
            lm_max_len = (lm_model.position_max_length
                          if lm_model is not None
                          else constants.MAX_LABEL_LENGTH)
        self.lm_max_len = lm_max_len
        self.device = next(am_model.parameters()).device

    @torch.inference_mode()
    def recognize_batch(self, signals: np.ndarray, lengths: np.ndarray,
                        bucket_frames: int = constants.FEATURE_MAX_LENGTH):
        """signals [B, S] float32, lengths [B] -> (pinyin ids [B, L],
        pinyin lengths [B], hanzi ids [B, L] or None), numpy int32."""
        sig = torch.as_tensor(np.asarray(signals, np.float32),
                              device=self.device)
        lens = torch.as_tensor(np.asarray(lengths, np.int32),
                               device=self.device)
        out = pipeline_program(self.am_model, self.lm_model, sig, lens,
                               bucket_frames, fbank_cfg=self.fbank_cfg,
                               decode=self.decode,
                               beam_width=self.beam_width,
                               lm_max_len=self.lm_max_len)
        return tuple(None if o is None else o.cpu().numpy() for o in out)

    def recognize_signal(self, signal: np.ndarray,
                         bucket_frames: Optional[int] = None
                         ) -> Tuple[List[str], str]:
        """One utterance -> (pinyin syllables, hanzi string)."""
        n = len(signal)
        if bucket_frames is None:
            bucket_frames = infer_bucket_frames(frames_for_samples(n))
        s_max = samples_for_frames(bucket_frames)
        buf = np.zeros((1, s_max), np.float32)
        buf[0, : min(n, s_max)] = signal[: s_max]
        pny_ids, pny_len, han_ids = self.recognize_batch(
            buf, np.array([min(n, s_max)]), bucket_frames)
        k = int(pny_len[0])
        pinyin = self.av.decode(pny_ids[0][:k])
        hanzi = ""
        if han_ids is not None and self.lv is not None:
            hanzi = "".join(self.lv.decode(han_ids[0][:k]))
        return pinyin, hanzi
