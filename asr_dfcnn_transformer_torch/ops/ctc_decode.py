"""CTC decoders: the port of ``ops/ctc_decode.py``.

The greedy decode is plain PyTorch on either device, as it was plain XLA.
The prefix beam search computes the f32 log-softmax as plain PyTorch, then
runs the ``topk_last`` and ``beam_search`` kernels (``kernels/topk.py``,
``kernels/beam.py``), which choose their twin or their CUDA kernel by the
tensors' device. The streaming form runs ``topk_last`` and then the scan
step (``kernels.beam.beam_step``) frame by frame on either device, as the
JAX package's stream step has no Pallas beam kernel either.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from asr_dfcnn_transformer_torch.core.device import default_device
from asr_dfcnn_transformer_torch.kernels.beam import (BeamState, beam_search,
                                                      beam_state_init,
                                                      beam_step)
from asr_dfcnn_transformer_torch.kernels.topk import topk_last


def ctc_greedy_decode(logits: torch.Tensor, logit_lengths: torch.Tensor,
                      blank_id: int = -1, merge_repeated: bool = True,
                      max_output_len: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Best-path decode (``tf.nn.ctc_greedy_decoder(merge_repeated=True)``).

    logits [B, T, V] (any monotone transform of probabilities), logit
    lengths [B] -> (ids [B, T or max_output_len] int32 left-aligned and
    zero-padded, lengths [B] int32, clipped to the cap when one is given).
    With a cap, compaction is the cumsum-match gather of the JAX package.
    """
    v = logits.shape[-1]
    blank = blank_id % v
    best = torch.argmax(logits, dim=-1).to(torch.int32)      # [B, T]
    b, t = best.shape
    pos = torch.arange(t, device=best.device)
    in_range = pos[None, :] < logit_lengths.to(best.device)[:, None]
    prev = torch.nn.functional.pad(best, (1, 0), value=-1)[:, :t]
    keep = (best != blank) & in_range
    if merge_repeated:
        keep &= best != prev
    if max_output_len is None:
        # stable sort on keep-order left-aligns the kept entries
        order = torch.where(keep, pos[None, :], t)
        perm = torch.argsort(order, dim=-1, stable=True)
        count = keep.sum(dim=-1, dtype=torch.int32)
        ids = torch.gather(best, 1, perm)
        ids = torch.where(pos[None, :] < count[:, None], ids, 0)
        return ids, count
    cum = torch.cumsum(keep.to(torch.int32), dim=-1)                 # [B, T]
    slots = torch.arange(1, max_output_len + 1, device=best.device,
                         dtype=torch.int32)                          # [L]
    match = keep[:, None, :] & (cum[:, None, :] == slots[None, :, None])
    t_idx = torch.argmax(match.to(torch.int32), dim=-1)              # [B, L]
    found = match.any(dim=-1)
    ids = torch.gather(best, 1, t_idx)
    ids = torch.where(found, ids, 0)
    lengths = torch.clamp(cum[:, -1], max=max_output_len)
    return ids, lengths.to(torch.int32)


def ctc_beam_search_decode(logits: torch.Tensor, logit_lengths: torch.Tensor,
                           beam_width: int = 8, topk: int = 8,
                           blank_id: int = -1, max_decode_len: int = 64,
                           return_all: bool = False):
    """Vectorized CTC prefix beam search (``ops/ctc_decode.py:146``).

    logits [B, T, V] raw (the log-softmax is taken here, in f32),
    logit_lengths [B] valid frames; W = ``beam_width`` beams, K =
    min(``topk``, V) extensions a frame, prefixes capped at
    ``max_decode_len``. Returns (ids [B, max_decode_len] of the best prefix,
    zero past its length, lengths [B] int32, neg_log_prob [B]); with
    ``return_all``, (prefixes [B, W, L], lengths [B, W], log-prob [B, W]).
    """
    v = logits.shape[-1]
    blank = blank_id % v
    k = min(topk, v)   # no more extensions than symbols
    lp = F.log_softmax(logits.float(), dim=-1).contiguous()
    top_lp, top_ids = topk_last(lp, k)
    lens = logit_lengths.to(device=lp.device, dtype=torch.int32).contiguous()
    prefixes, plen, pb, pnb = beam_search(
        lp, top_lp, top_ids, lens, beam_width=beam_width, topk=k,
        blank=blank, max_decode_len=max_decode_len)
    return _beam_finish(prefixes, plen, pb, pnb, return_all)


def ctc_beam_search_stream_init(batch: int, beam_width: int = 8,
                                max_decode_len: int = 64,
                                device=None) -> BeamState:
    """Fresh carry state for :func:`ctc_beam_search_stream_step`, on
    ``device`` (default ``cuda``; raises without CUDA)."""
    return beam_state_init(batch, beam_width, max_decode_len,
                           default_device(device))


def ctc_beam_search_stream_step(state: BeamState, log_probs: torch.Tensor,
                                beam_width: Optional[int] = None,
                                topk: int = 8, blank_id: int = -1,
                                frame_counts: Optional[torch.Tensor] = None
                                ) -> BeamState:
    """Advance the prefix beam search over a chunk of frames.

    log_probs [B, Tc, V]: already-normalised log-probs of the NEW frames.
    Feeding the same frames in any chunking gives exactly the offline
    result. ``beam_width`` is a cross-check of the W in the state (None
    uses it; a value that disagrees raises). ``frame_counts`` [B]: valid
    new frames per row, rows freeze past their count (None = all valid).
    """
    w = state[0].shape[1]
    if beam_width is not None and beam_width != w:
        raise ValueError(
            f"beam_width={beam_width} disagrees with the W={w} baked into "
            f"the stream state (set it in ctc_beam_search_stream_init)")
    v = log_probs.shape[-1]
    blank = blank_id % v
    lp = log_probs.float().contiguous()
    top_lp, top_ids = topk_last(lp, min(topk, v))
    if frame_counts is not None:
        frame_counts = frame_counts.to(lp.device)
    for t in range(lp.shape[1]):
        active = None if frame_counts is None else t < frame_counts
        state = beam_step(state, lp[:, t], top_lp[:, t], top_ids[:, t],
                          active, blank=blank)
    return state


def ctc_beam_search_stream_best(state: BeamState):
    """(ids [B, Lcap], lengths [B], neg_log_prob [B]) of the best beam."""
    prefixes, plen, _, _, pb, pnb = state
    return _beam_finish(prefixes, plen, pb, pnb, False)


def _beam_finish(prefixes, plen, pb, pnb, return_all: bool):
    total = torch.logaddexp(pb, pnb)
    if return_all:
        return prefixes, plen, total
    best = torch.argmax(total, dim=1)                  # first of equal maxima
    rows = torch.arange(prefixes.shape[0], device=prefixes.device)
    best_ids = prefixes[rows, best]
    best_len = plen[rows, best]
    best_nlp = -total[rows, best]
    pos = torch.arange(prefixes.shape[2], device=prefixes.device)
    best_ids = torch.where(pos[None, :] < best_len[:, None], best_ids, 0)
    return best_ids, best_len, best_nlp
