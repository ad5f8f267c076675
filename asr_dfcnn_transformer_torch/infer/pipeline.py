"""Batched AM -> LM recognition: the port of ``infer/pipeline.py``.

One batch runs fbank (the ``log_mel`` and ``cmvn`` kernels) -> SE-DFCNN ->
CTC decode capped at the LM's positions (greedy, or the prefix beam search
on the ``topk_last`` and ``beam_search`` kernels) -> Transformer LM (the
``masked_attention`` kernel in every block) -> argmax, on the models'
device. Host-side callers hand in numpy arrays and get numpy arrays back.

Around it, the reference's evaluation protocol (``lm_and_am/test.py``):
per-utterance edit distance CLIPPED at the reference length, accuracy =
1 - sum(clipped distance) / sum(reference length) for pinyin and hanzi,
and a ``pred_log`` of original and predicted pinyin and hanzi, in the JAX
package's words (``Pipeline.evaluate`` / ``evaluate_lm``);
``Pipeline.from_checkpoints`` serves a training workdir's checkpoints after
checking their identity stamps.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterable, List, Optional, Tuple

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
from asr_dfcnn_transformer_torch.ops.edit_distance import (
    batched_edit_distance, edit_distance)

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


@dataclasses.dataclass
class EvalResult:
    pinyin_accuracy: float
    hanzi_accuracy: float
    num_utterances: int
    pred_log_path: Optional[str] = None


def _write_log(path: str, lines: List[str]) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")


class Pipeline:
    """AM (fbank -> pinyin CTC) + LM (pinyin -> hanzi) inference.

    Args:
      am_model: the port's ``SEDFCNN``, ``DFCNN`` or ``KerasDFCNN`` (its
        device is the pipeline's).
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

    @classmethod
    def from_checkpoints(cls, workdir: str, am_model, lm_model=None, *,
                         acoustic_vocab: Vocab,
                         language_vocab: Optional[Vocab] = None,
                         use_best: bool = True,
                         allow_model_mismatch: bool = False,
                         **kw) -> "Pipeline":
        """A pipeline over a training workdir's ``ckpt_am`` / ``ckpt_lm``
        (the metric-gated best copy when there is one and ``use_best``,
        else the latest). Each model is checked against its directory's
        identity stamp first (``train/identity.py``: a structural mismatch
        raises unless ``allow_model_mismatch``), then its ``"model"``
        state is loaded into it on its own device; no optimizer state is
        touched."""
        for model, name in ((am_model, "am"), (lm_model, "lm")):
            if model is None:
                continue
            state = cls._restore(workdir, name, use_best, model,
                                 allow_model_mismatch)
            if state is None:
                raise FileNotFoundError(
                    f"no {name.upper()} checkpoint under {workdir}")
            model.load_state_dict(state["model"])
        return cls(am_model, lm_model, acoustic_vocab=acoustic_vocab,
                   language_vocab=language_vocab, **kw)

    @staticmethod
    def _restore(workdir: str, name: str, use_best: bool, model=None,
                 allow_mismatch: bool = False):
        """The checkpoint state under ``<workdir>/ckpt_<name>`` (best, else
        latest), or None; with ``model``, its stamp is checked first."""
        from asr_dfcnn_transformer_torch.train import identity
        from asr_dfcnn_transformer_torch.train.checkpoint import (
            CheckpointManager)
        ckpt_dir = os.path.join(workdir, f"ckpt_{name}")
        if model is not None:
            identity.check_identity(ckpt_dir, model, override=allow_mismatch)
        ckpt = CheckpointManager(ckpt_dir)
        state = ckpt.restore_best() if use_best else None
        return state if state is not None else ckpt.restore_latest()

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

    def recognize_file(self, path: str) -> Tuple[List[str], str]:
        from asr_dfcnn_transformer_torch.audio.wav import read_wav
        sig, _ = read_wav(path)
        return self.recognize_signal(sig)

    # ------------------------------------------------------------------

    @torch.inference_mode()
    def evaluate_lm(self, batches: Iterable, *,
                    pred_log_path: Optional[str] = None) -> EvalResult:
        """LM-only protocol (test_lm.py): ground-truth pinyin in, hanzi
        accuracy out, the same clipped edit distance."""
        if self.lm_model is None or self.lv is None:
            raise ValueError("evaluate_lm needs an LM and its vocabulary")
        han_err = han_tot = 0
        n_utts = 0
        log_lines: List[str] = []
        for batch in batches:
            ids = torch.as_tensor(np.asarray(batch.pinyin, np.int64),
                                  device=self.device)
            preds = torch.argmax(self.lm_model(ids), dim=-1).to(
                torch.int32).cpu().numpy()
            for j in range(preds.shape[0]):
                if batch.weights[j] == 0:
                    continue
                n_utts += 1
                n = int(batch.lengths[j])
                gt = list(batch.hanzi[j][:n])
                pd = list(preds[j][:n])
                d = edit_distance(gt, pd)
                han_err += min(d, len(gt))
                han_tot += len(gt)
                if pred_log_path is not None:
                    log_lines.append("原文汉字结果: "
                                     + "".join(self.lv.decode(gt)))
                    log_lines.append("预测汉字结果: "
                                     + "".join(self.lv.decode(pd)))
        acc = 1.0 - han_err / max(han_tot, 1)
        if pred_log_path is not None:
            log_lines.append(
                f"*[Test Result] 汉字 word accuracy ratio: {acc * 100}%")
            _write_log(pred_log_path, log_lines)
        return EvalResult(float("nan"), acc, n_utts, pred_log_path)

    def _distances(self, ids: np.ndarray, ids_len: np.ndarray,
                   ref: np.ndarray, ref_len: np.ndarray) -> np.ndarray:
        """Each row's edit distance, on the pipeline's device."""
        dev = self.device
        return batched_edit_distance(
            torch.as_tensor(ids, device=dev),
            torch.as_tensor(ids_len, device=dev),
            torch.as_tensor(np.asarray(ref), device=dev),
            torch.as_tensor(np.asarray(ref_len), device=dev)).cpu().numpy()

    def evaluate(self, batches: Iterable, *,
                 pred_log_path: Optional[str] = None) -> EvalResult:
        """The test.py accuracy protocol over ``AMBatch`` iterables (ground
        truth pinyin and hanzi ids in each batch); rows of weight 0 (a
        partial batch's back-fill) are skipped. The distances of a batch
        come from one ``batched_edit_distance`` on the device; each is
        clipped at its reference length on the host."""
        py_err = py_tot = han_err = han_tot = 0
        n_utts = 0
        log_lines: List[str] = []
        for batch in batches:
            pny_ids, pny_len, han_np = self.recognize_batch(
                batch.signals, batch.signal_lengths, batch.bucket_frames)
            d_py = self._distances(pny_ids, pny_len, batch.pinyin,
                                   batch.pinyin_lengths)
            if han_np is not None:
                d_han = self._distances(han_np, pny_len, batch.hanzi,
                                        batch.hanzi_lengths)
            for j in range(pny_ids.shape[0]):
                if batch.weights[j] == 0:
                    continue
                n_utts += 1
                gt_py_n = int(batch.pinyin_lengths[j])
                py_err += min(int(d_py[j]), gt_py_n)
                py_tot += gt_py_n
                if han_np is not None:
                    gt_h_n = int(batch.hanzi_lengths[j])
                    han_err += min(int(d_han[j]), gt_h_n)
                    han_tot += gt_h_n
                if pred_log_path is None:
                    continue
                gt_py = list(batch.pinyin[j][: batch.pinyin_lengths[j]])
                pred_py = list(pny_ids[j][: pny_len[j]])
                log_lines.append("原文拼音结果: "
                                 + " ".join(self.av.decode(gt_py)))
                log_lines.append("预测拼音结果: "
                                 + " ".join(self.av.decode(pred_py)))
                if han_np is not None and self.lv is not None:
                    # predicted hanzi run to the pinyin length, as in the
                    # JAX package
                    gt_h = list(batch.hanzi[j][: batch.hanzi_lengths[j]])
                    pred_h = list(han_np[j][: pny_len[j]])
                    log_lines.append("原文汉字结果: "
                                     + "".join(self.lv.decode(gt_h)))
                    log_lines.append("预测汉字结果: "
                                     + "".join(self.lv.decode(pred_h)))
        py_acc = 1.0 - py_err / max(py_tot, 1)
        han_acc = 1.0 - han_err / max(han_tot, 1) if han_tot else float("nan")
        if pred_log_path is not None:
            log_lines.append(
                f"*[Test Result] 拼音 word accuracy ratio: {py_acc * 100}%")
            if han_tot:
                log_lines.append(
                    f"*[Test Result] 汉字 word accuracy ratio: {han_acc * 100}%")
            _write_log(pred_log_path, log_lines)
        return EvalResult(py_acc, han_acc, n_utts, pred_log_path)
