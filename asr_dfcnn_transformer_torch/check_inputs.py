"""Seeded kernel inputs and a library yardstick shared by ``chip_smoke.py``
and ``compare_kernels``.

``cmvn_inputs`` draws features and valid counts for ``cmvn``;
``ctc_problem`` draws CTC inputs at the AM's training shape and
``ctc_dp_inputs`` forms the DP kernels' inputs from them, as ``ops/ctc.py``
forms them; ``alpha_inputs`` draws ``ctc_alpha``'s inputs directly at any
(T, B, S), and ``ALPHA_EDGES`` lists the shapes past the main one that the
card's checks hold it to; ``topk_cases`` draws ``topk_last``'s cases on
the card; ``EPILOGUE_CASES`` and ``epilogue_z`` give
``interleave_epilogue``'s; ``ctc_loss_device_us`` times ``F.ctc_loss``'s
forward and backward in device time (needs a CUDA device).
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


# (label, T, B, S): T 1 and 2; S 1, on both sides of the warp multiples
# 32, 64 and 160 (the block's last warp full or one state in it) and 1024
# (32 warps: one block of them); B 1, and B 64 and 200 at S 129 (more
# blocks than one an SM, 200 more than the card's 132 SMs: one block an
# utterance); every case with B > 2 has rows of length 0 and past T
ALPHA_EDGES = (("T1", 1, 16, 129), ("T2", 2, 16, 129), ("S1", 200, 16, 1),
               ("S32", 200, 16, 32), ("S33", 200, 16, 33),
               ("S64", 200, 16, 64), ("S65", 200, 16, 65),
               ("S160", 200, 16, 160), ("S161", 200, 16, 161),
               ("S1024", 200, 4, 1024), ("B1", 200, 1, 129),
               ("ragged", 37, 5, 65), ("B64", 40, 64, 129),
               ("B200", 200, 200, 129))

# (label, [B, n2, n1], z's type, z's storage offset in elements) at which
# the card's checks hold ``interleave_epilogue``: the noise transform's z
# at n 262,144 in bf16 and f32, the AM step's batch of 16, n 16, n1 not a
# multiple of a 16-byte load's elements with rows off 16-byte boundaries
# ([5, 33, 36]: every odd row), n1 n2 odd, and z a view one element into
# its storage
EPILOGUE_CASES = (
    ("noise_bf16", (128, 256, 512), torch.bfloat16, 0),
    ("noise_f32", (128, 256, 512), torch.float32, 0),
    ("am_step_bf16", (16, 256, 512), torch.bfloat16, 0),
    ("n16_bf16", (3, 2, 4), torch.bfloat16, 0),
    ("n16_f32", (3, 2, 4), torch.float32, 0),
    ("ragged_bf16", (5, 33, 36), torch.bfloat16, 0),
    ("misaligned_bf16", (5, 33, 35), torch.bfloat16, 1),
    ("misaligned_f32", (3, 7, 5), torch.float32, 1),
)


def epilogue_z(rng, shape, dtype, offset: int, dev) -> torch.Tensor:
    """A seeded normal z of ``shape`` in ``dtype`` on ``dev``: a contiguous
    view ``offset`` elements into its storage."""
    flat = rng.standard_normal(int(np.prod(shape)) + offset)
    return torch.from_numpy(flat.astype(np.float32)).to(dev, dtype)[
        offset:].view(shape)


def alpha_inputs(rng, t: int, b: int, s: int):
    """``ctc_alpha``'s inputs in numpy at any (T, B, S), S states not tied
    to labels: emissions -Exp(2), alpha_0 finite at the first two valid
    states, ragged valid state counts (the first row all S), skips allowed
    at random odd states from 3 on, and lengths in 1 .. T with the second
    row's 0 and the third's past T. Returns (emit [T, B, S] f32, init
    [B, S] f32, can_skip [B, S] bool, valid [B, S] bool, lens [B] int32)."""
    from asr_dfcnn_transformer_torch.kernels.ctc import NEG_INF
    emit = (-rng.exponential(2.0, (t, b, s))).astype(np.float32)
    states = rng.integers(1, s + 1, size=b)
    states[0] = s
    col = np.arange(s)
    valid = col[None] < states[:, None]
    can_skip = ((rng.uniform(size=(b, s)) < 0.7) & (col >= 3)
                & (col % 2 == 1) & valid)
    init = np.where(valid & (col < 2), -rng.exponential(1.0, (b, s)),
                    NEG_INF).astype(np.float32)
    lens = rng.integers(1, t + 1, size=b).astype(np.int32)
    lens[0] = t
    if b > 1:
        lens[1] = 0
    if b > 2:
        lens[2] = t + 3
    return emit, init, can_skip, valid, lens


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
    ``labels``, from the profiler (``timing.library_us``: CUDA events where
    the trace shows no device time): the forward alone, and the forward
    and backward less the forward."""
    from asr_dfcnn_transformer_torch.timing import library_us
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

    fwd, _ = library_us(forward, iters)
    both, _ = library_us(lambda: torch.autograd.grad(loss(), x), iters)
    return fwd, both - fwd


def topk_cases(rng, dev):
    """(label, x [N, V] f32 on ``dev``, k) at which the card's checks hold
    ``topk_last``: the beam path's log-softmax rows [1600, 1536] at k 8, 1
    and 32, a streamed chunk [8 x 16, 1536], N 1, V 1, 33 (ragged: 4-byte
    loads) and 2048, quantised ties with -0.0 and 0.0, and rows with -inf
    entries, with entries at -1e30 and with fewer than k above -1e30."""
    from asr_dfcnn_transformer_torch.kernels.topk import NEG_INF
    v = 1536                                 # the AM's vocabulary

    def log_probs(n, width):
        x = torch.from_numpy((2.0 * rng.standard_normal((n, width))).astype(
            np.float32)).to(dev)
        return torch.log_softmax(x, -1)

    path = log_probs(1600, v)
    ties = torch.round(torch.from_numpy(rng.standard_normal(
        (1600, v)).astype(np.float32)).to(dev) * 2) / 2
    sparse = log_probs(64, v)
    sparse[:32, 5:] = -float("inf")       # 5 finite entries, k 32
    sparse[32:, ::2] = NEG_INF            # entries already at the mask
    sparse[40:48] = -float("inf")         # rows of only -inf
    return (("path", path, 8), ("k1", path, 1), ("k32", path, 32),
            ("stream", log_probs(8 * 16, v), 8), ("n1", log_probs(1, v), 8),
            ("v1", log_probs(64, 1), 1), ("v33", log_probs(256, 33), 8),
            ("v2048", log_probs(256, 2048), 8), ("ties", ties, 8),
            ("sparse", sparse, 32))
