"""Seeded kernel inputs and a library yardstick shared by ``chip_smoke.py``
and ``compare_kernels``.

``cmvn_inputs`` draws features and valid counts for ``cmvn``;
``ctc_problem`` draws CTC inputs at the AM's training shape and
``ctc_dp_inputs`` forms the DP kernels' inputs from them, as ``ops/ctc.py``
forms them; ``ctc_loss_device_us`` times ``F.ctc_loss``'s forward and
backward in device time (needs a CUDA device).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# log of f64's eps: the value of every bin of an empty mel filter
LOG_EPS = float(np.log(np.finfo(np.float64).eps))


def cmvn_inputs(rng, b: int, t: int, f: int, const_cols=(),
                ragged: bool = True):
    """([B, T, F] f32 features, [B] int32 valid counts) in numpy: normal
    features around -10 with ``const_cols`` set to ``LOG_EPS`` (an empty mel
    filter's column). Ragged counts are uniform in 1..T with the first T,
    the second above T (it counts, as in JAX) and the third 0; otherwise
    every count is T, as the AM training batch has them."""
    feat = (3 * rng.standard_normal((b, t, f)) - 10).astype(np.float32)
    feat[:, :, np.asarray(const_cols, dtype=np.int64)] = np.float32(LOG_EPS)
    if not ragged:
        return feat, np.full(b, t, np.int32)
    valid = rng.integers(1, t + 1, size=b).astype(np.int32)
    valid[0] = t
    if b > 1:
        valid[1] = t + t // 4 + 1
    if b > 2:
        valid[2] = 0
    return feat, valid


def ctc_problem(rng, b=16, t=200, lmax=64, v=1536):
    """Seeded CTC inputs at the AM's training shape: ragged logit lengths,
    label lengths up to ``lmax`` with an empty label and one unsatisfiable
    row (more labels than frames)."""
    logits = (2.0 * rng.standard_normal((b, t, v))).astype(np.float32)
    logit_len = rng.integers(t // 2, t + 1, size=b).astype(np.int32)
    label_len = rng.integers(1, lmax + 1, size=b).astype(np.int32)
    logit_len[0], label_len[0] = t, lmax
    label_len[1] = 0                                  # empty label
    logit_len[2], label_len[2] = lmax // 2, lmax      # unsatisfiable
    labels = rng.integers(0, v - 1, size=(b, lmax)).astype(np.int32)
    return logits, logit_len, labels, label_len


def ctc_dp_inputs(logits, logit_len, labels, label_len, dev) -> dict:
    """The CTC DP kernels' inputs on ``dev``, formed as ``ops/ctc.py``
    forms them (blank = V - 1): the log-probs ``lp``, ``lens`` and
    ``lab_len``, the extended labels' ``emit`` [T, B, S], ``init``,
    ``valid`` and ``can_skip``; the twin's ``alphas``, log P ``total``,
    beta's end rows ``binit`` and ``skip_from``; ``xi_args``, the
    ``ctc_beta_xi`` arguments in order."""
    from asr_dfcnn_transformer_torch.kernels import ctc as kctc
    from asr_dfcnn_transformer_torch.ops import ctc as ctc_ops
    v = logits.shape[-1]
    lp = torch.log_softmax(torch.from_numpy(logits).to(dev), -1)
    lens = torch.from_numpy(logit_len).to(dev)
    lab_len = torch.from_numpy(label_len).to(dev)
    ext, valid, can_skip = ctc_ops._extended_labels(
        torch.from_numpy(labels).long().to(dev), lab_len, v - 1)
    emit = ctc_ops._emissions(lp, ext)
    init = ctc_ops._alpha0(lp, emit, lab_len, valid, v - 1)
    alphas = kctc.alpha_stack_reference(emit, init, can_skip, valid, lens)
    total = ctc_ops._total_from_alpha(alphas[-1], lab_len, lens)
    binit = ctc_ops._beta_init(valid, lab_len)
    skip_from = F.pad(can_skip, (0, 2))[:, 2:].contiguous()
    return {"lp": lp, "lens": lens, "lab_len": lab_len, "emit": emit,
            "init": init, "valid": valid, "can_skip": can_skip,
            "alphas": alphas, "total": total, "binit": binit,
            "skip_from": skip_from,
            "xi_args": (emit, alphas, binit, skip_from, valid, lens, total)}


def ctc_loss_device_us(d: dict, labels, iters: int = 10):
    """(forward, backward) device us a call of ``F.ctc_loss`` (sum, zero
    infinity, blank V - 1) on ``ctc_dp_inputs``' log-probs and the numpy
    ``labels``, from the profiler: the forward alone, and the forward and
    backward less the forward."""
    from asr_dfcnn_transformer_torch.timing import device_us
    lp = d["lp"]
    x = lp.transpose(0, 1).contiguous().requires_grad_(True)
    tgt = torch.from_numpy(labels).long().to(lp.device)

    def loss():
        return F.ctc_loss(x, tgt, d["lens"].long(), d["lab_len"].long(),
                          blank=lp.shape[-1] - 1, reduction="sum",
                          zero_infinity=True)

    def forward():
        with torch.no_grad():
            loss()

    fwd = device_us(forward, None, iters)
    both = device_us(lambda: torch.autograd.grad(loss(), x), None, iters)
    return fwd, both - fwd
