"""Greedy CTC decode: the port of ``ops/ctc_decode.py:43 ctc_greedy_decode``.

Plain PyTorch on either device; the TPU used no kernel here either.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


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
