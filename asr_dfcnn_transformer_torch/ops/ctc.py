"""CTC loss with the analytic gradient: the port of ``ops/ctc.py``.

Per-example negative log likelihood of dense padded labels under
``tf.nn.ctc_loss_v2`` semantics with the blank last by default (the JAX
package's ``ctc_loss`` with ``analytic_grad=True``). The time DPs are the
``ctc_alpha`` / ``ctc_beta_xi`` kernels (``kernels/ctc.py``: CUDA on the
card, their twins on the CPU); around them is plain PyTorch:

- the extended-label topology and the emission gather ``lp[b, t, ext[b,
  s]]`` (a ``torch.gather``, exact, where the JAX package runs a one-hot
  matmul at HIGHEST precision);
- the alpha_0 row, the log P readout with its zero-frame case, the beta
  init row;
- the backward: gamma by ``scatter_add`` over classes, then
  ``dlogits = exp(lp) * sum_s xi - gamma`` (or ``-gamma`` for log-prob
  inputs), scaled by the incoming gradient.

No lane padding: S = 2L + 1 as it is.
"""

from __future__ import annotations

import torch

from asr_dfcnn_transformer_torch.kernels.ctc import (NEG_INF, ctc_alpha,
                                                     ctc_beta_xi)


def _extended_labels(labels: torch.Tensor, label_lengths: torch.Tensor,
                     blank: int):
    """(ext [B, S], valid [B, S] bool, can_skip [B, S] bool), S = 2L + 1."""
    b, l = labels.shape
    s = 2 * l + 1
    ext = torch.full((b, s), blank, dtype=torch.int64, device=labels.device)
    ext[:, 1::2] = labels
    pos = torch.arange(s, device=labels.device)[None, :]
    valid = pos < (2 * label_lengths.to(torch.int64)[:, None] + 1)
    ext_m2 = torch.nn.functional.pad(ext, (2, 0), value=-1)[:, :s]
    can_skip = (pos >= 2) & (ext != blank) & (ext != ext_m2)
    return ext, valid, can_skip


def _in_vocab(ext: torch.Tensor, v: int):
    """(ext clamped into [0, V), in-range mask): an out-of-range id (label
    padding) reads and receives nothing, as the one-hot of the JAX package
    gives it."""
    return ext.clamp(0, v - 1), (ext >= 0) & (ext < v)


def _emissions(lp: torch.Tensor, ext: torch.Tensor) -> torch.Tensor:
    """emit [T, B, S] f32: lp[b, t, ext[b, s]]."""
    b, t, v = lp.shape
    idx, ok = _in_vocab(ext, v)
    emit = torch.gather(lp, 2, idx[:, None, :].expand(b, t, idx.shape[1]))
    emit = torch.where(ok[:, None, :], emit, 0.0)
    return emit.permute(1, 0, 2).contiguous()


def _alpha0(lp, emit, label_lengths, valid, blank):
    b, s = valid.shape
    alpha0 = torch.full((b, s), NEG_INF, dtype=torch.float32,
                        device=lp.device)
    alpha0[:, 0] = lp[:, 0, blank]
    if s > 1:
        alpha0[:, 1] = torch.where(label_lengths > 0, emit[0, :, 1], NEG_INF)
    return torch.where(valid, alpha0, NEG_INF)


def _total_from_alpha(alpha_last, label_lengths, logit_lengths):
    """log P from the final alpha row: alpha[2L] (+) alpha[2L-1]; for zero
    valid frames, 0 with an empty label and NEG_INF otherwise."""
    idx_last = (2 * label_lengths.to(torch.int64))[:, None]
    a_last = torch.gather(alpha_last, 1, idx_last)[:, 0]
    a_prev = torch.gather(alpha_last, 1, torch.clamp_min(idx_last - 1, 0))
    a_prev = torch.where(label_lengths > 0, a_prev[:, 0], NEG_INF)
    total = torch.logaddexp(a_last, a_prev)
    empty_ok = torch.where(label_lengths > 0, NEG_INF, 0.0)
    return torch.where(logit_lengths > 0, total, empty_ok)


def _beta_init(valid, label_lengths):
    s = valid.shape[1]
    pos = torch.arange(s, device=valid.device)[None, :]
    idx_last = 2 * label_lengths.to(torch.int64)[:, None]
    has_label = (label_lengths > 0)[:, None]
    end = (pos == idx_last) | (has_label & (pos == idx_last - 1))
    return torch.where(end & valid, 0.0, NEG_INF)


class CTCLoss(torch.autograd.Function):
    """Forward: the alpha DP kernel. Backward: the fused beta/xi kernel,
    then gamma by scatter over classes. Saves lp, the emissions, the
    alphas [T, B, S] f32 and the loss."""

    @staticmethod
    def forward(ctx, logits, logit_lengths, labels, label_lengths, blank,
                logits_are_log_probs):
        lp = logits if logits_are_log_probs \
            else torch.log_softmax(logits, dim=-1)
        lp = lp.float()
        logit_lengths = logit_lengths.to(torch.int32)
        label_lengths = label_lengths.to(torch.int32)
        ext, valid, can_skip = _extended_labels(labels, label_lengths, blank)
        emit = _emissions(lp, ext)
        init = _alpha0(lp, emit, label_lengths, valid, blank)
        alphas = ctc_alpha(emit, init, can_skip, valid, logit_lengths)
        loss = -_total_from_alpha(alphas[-1], label_lengths, logit_lengths)
        ctx.save_for_backward(lp, emit, alphas, loss, logit_lengths,
                              label_lengths, ext, valid, can_skip)
        ctx.logits_are_log_probs = logits_are_log_probs
        ctx.logits_dtype = logits.dtype
        return loss

    @staticmethod
    def backward(ctx, g):
        (lp, emit, alphas, loss, logit_lengths, label_lengths, ext, valid,
         can_skip) = ctx.saved_tensors
        skip_from = torch.nn.functional.pad(can_skip, (0, 2))[:, 2:]
        xi = ctc_beta_xi(emit, alphas, _beta_init(valid, label_lengths),
                         skip_from.contiguous(), valid, logit_lengths,
                         -loss)                                  # [T, B, S]
        xi_b = xi.permute(1, 0, 2)                               # [B, T, S]
        b, t, v = lp.shape
        idx, ok = _in_vocab(ext, v)
        gamma = torch.zeros_like(lp).scatter_add_(
            2, idx[:, None, :].expand(b, t, idx.shape[1]),
            torch.where(ok[:, None, :], xi_b, 0.0))              # [B, T, V]
        if ctx.logits_are_log_probs:
            dlp = -gamma
        else:
            # through log_softmax: sum_s xi_t(s) is 1 on valid frames, 0
            # past them, so the masking falls out of the actual sum
            dlp = torch.exp(lp) * xi_b.sum(-1, keepdim=True) - gamma
        dlogits = (g[:, None, None] * dlp).to(ctx.logits_dtype)
        return dlogits, None, None, None, None, None


def ctc_loss(logits: torch.Tensor, logit_lengths: torch.Tensor,
             labels: torch.Tensor, label_lengths: torch.Tensor,
             blank_id: int = -1,
             logits_are_log_probs: bool = False) -> torch.Tensor:
    """Per-example negative log likelihood [B].

    logits [B, T, V] raw logits (log_softmax applied inside), or log-probs
    if ``logits_are_log_probs``; logit_lengths [B] valid frames (<= T);
    labels [B, L] dense ids, any padding past ``label_lengths``;
    blank_id -1 means V - 1. The gradient is the analytic one.
    """
    if logits.dim() != 3 or labels.dim() != 2:
        raise ValueError("ctc_loss: logits must be [B, T, V] and labels "
                         "[B, L]")
    blank = blank_id % logits.shape[-1]
    return CTCLoss.apply(logits, logit_lengths, labels.to(torch.int64),
                         label_lengths, blank, logits_are_log_probs)
