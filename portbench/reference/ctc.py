"""The plain reference of the CTC parts: the greedy decode, the CTC loss, and
the gap by which a served pinyin sequence lies below the reference's best.

The blank is the last class. The greedy decode takes each valid frame's
best class, merges repeats, drops blanks and keeps at most ``cap`` labels
(``tf.nn.ctc_greedy_decoder``, capped at the LM's positions).

``served_gap``: a served sequence y came from some best path of the
program's own logits. Over every frame path that the greedy decode would
turn into y (blanks and repeats as CTC allows them; where y holds ``cap``
labels, any continuation after its last label, which the cap cuts off),
take the path whose worst frame lies least below the reference's best class
of that frame. That worst frame's gap, best - logit of the path's class, is
0 exactly when the reference's own greedy decode gives y.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F


def greedy(logits: torch.Tensor, lengths: torch.Tensor, cap: int):
    """logits [B, T, V] -> list of B id lists."""
    best = logits.argmax(-1).cpu().numpy()
    blank = logits.shape[-1] - 1
    out = []
    for row, n in zip(best, lengths.tolist()):
        seq, prev = [], -1
        for c in row[:n]:
            if c != prev and c != blank:
                seq.append(int(c))
            prev = c
        out.append(seq[:cap])
    return out


def served_gap(logits: np.ndarray, y: Sequence[int], cap: int) -> float:
    """logits [T, V] of one utterance's valid frames (float64 numpy), y the
    served labels -> the least worst-frame gap of a path decoding to y."""
    t_n, v = logits.shape
    blank = v - 1
    gap = logits.max(1, keepdims=True) - logits          # [T, V] >= 0
    ext = np.full(2 * len(y) + 1, blank)
    ext[1::2] = y
    s_n = len(ext)
    skip = np.zeros(s_n, bool)                           # s-2 -> s allowed
    skip[3::2] = ext[3::2] != ext[1:-2:2]
    cost = gap[:, ext]                                   # [T, S]
    inf = np.inf
    d = np.full(s_n, inf)
    d[0] = cost[0, 0]
    if s_n > 1:
        d[1] = cost[0, 1]
    free = len(y) >= cap and len(y) > 0
    best_end = inf
    for t in range(1, t_n + 1):
        if free:
            best_end = min(best_end, d[-2], d[-1])
        if t == t_n:
            break
        prev = d.copy()
        prev[1:] = np.minimum(prev[1:], d[:-1])
        prev[2:] = np.where(skip[2:], np.minimum(prev[2:], d[:-2]), prev[2:])
        d = np.maximum(prev, cost[t])
    end = min(d[-1], d[-2]) if s_n > 1 else d[-1]
    return float(min(end, best_end))


def ctc_losses(logits: torch.Tensor, lengths: torch.Tensor,
               labels: torch.Tensor, label_lengths: torch.Tensor):
    """Per-utterance CTC negative log likelihood [B] (f32 log-softmax)."""
    lp = torch.log_softmax(logits.float(), -1).transpose(0, 1)
    return F.ctc_loss(lp, labels.long(), lengths.long(),
                      label_lengths.long(), blank=logits.shape[-1] - 1,
                      reduction="none", zero_infinity=False)
