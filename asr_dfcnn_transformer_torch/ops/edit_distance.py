"""Edit distance: the port of ``ops/edit_distance.py``.

- :func:`edit_distance`: plain Python Levenshtein DP on sequences (host
  side, the eval protocol's golden path);
- :func:`batched_edit_distance`: the [B]-batched row DP of the JAX package
  in torch ops on either device, with the in-row insertion chain as a
  prefix minimum (``torch.cummin``); the AM trainer's label error rate;
- :func:`label_error_rate`: its mean over the label lengths, the
  reference's ``tf.reduce_mean(tf.edit_distance)`` metric.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def edit_distance(a: Sequence, b: Sequence) -> int:
    """Classic Levenshtein distance."""
    la, lb = len(a), len(b)
    if la == 0:
        return lb
    if lb == 0:
        return la
    prev = np.arange(lb + 1)
    for i in range(1, la + 1):
        cur = np.empty(lb + 1, dtype=np.int64)
        cur[0] = i
        ai = a[i - 1]
        for j in range(1, lb + 1):
            cost = 0 if ai == b[j - 1] else 1
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost)
        prev = cur
    return int(prev[lb])


def batched_edit_distance(a: torch.Tensor, a_len: torch.Tensor,
                          b: torch.Tensor, b_len: torch.Tensor
                          ) -> torch.Tensor:
    """Levenshtein distance of each row pair: a [B, La] / b [B, Lb] padded
    id sequences with true lengths a_len / b_len [B] -> [B] int32.

    Row recurrence: with ``m[j] = min(prev[j-1] + sub_cost_j, prev[j] + 1)``
    the insertion chain ``cur[j] = min(m[j], cur[j-1] + 1)`` equals
    ``min_{k<=j} (m[k] - k) + j``, a prefix minimum. Rows past ``a_len``
    freeze; the answer is read at column ``b_len``.
    """
    bsz, la = a.shape
    lb = b.shape[1]
    dev = a.device
    cols = torch.arange(lb + 1, device=dev, dtype=torch.int64)[None, :]
    a_len = a_len.to(dev, torch.int64)[:, None]
    prev = cols.expand(bsz, lb + 1)
    for i in range(1, la + 1):
        sub_cost = (a[:, i - 1:i] != b).to(torch.int64)          # [B, Lb]
        m = torch.minimum(prev[:, :-1] + sub_cost, prev[:, 1:] + 1)
        mj = torch.cat([torch.full((bsz, 1), i, device=dev,
                                   dtype=torch.int64), m], dim=1)
        cur = torch.cummin(mj - cols, dim=1).values + cols
        prev = torch.where(i <= a_len, cur, prev)
    dist = torch.gather(prev, 1, b_len.to(dev, torch.int64)[:, None])[:, 0]
    return torch.clamp_max(dist, la + lb + 1).to(torch.int32)


def label_error_rate(decoded: torch.Tensor, decoded_len: torch.Tensor,
                     labels: torch.Tensor, label_len: torch.Tensor
                     ) -> torch.Tensor:
    """Mean normalised edit distance (ops/edit_distance.py:91): each row's
    :func:`batched_edit_distance` over ``max(label_len, 1)``, averaged, as
    ``tf.edit_distance`` normalises by the reference length
    (acoustic_model.py:60-62) -> a 0-d f32 tensor."""
    d = batched_edit_distance(decoded, decoded_len, labels, label_len)
    n = torch.clamp_min(label_len.to(d.device, torch.float32), 1.0)
    return torch.mean(d.to(torch.float32) / n)
