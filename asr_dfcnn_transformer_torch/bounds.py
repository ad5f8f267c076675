"""The least time one H100 could take for a kernel's work, shared by
``chip_smoke.py`` and ``compare_kernels``.

A bound is the larger of two times: the bytes the function must move (each
input read once, each output written once) over the memory rate, and its
operations over each type's peak rate. The ``*_work`` functions count both
for one call, from the call's own tensors, as ``(bytes, {type: count})``;
``bound`` turns such a count into milliseconds.
"""

from __future__ import annotations

# Peaks of one H100 SXM at 700 W (NVIDIA data sheet, dense): memory, and the
# best rate for each type of operation (f64 on the tensor cores, f32 outside
# them, bf16 on them).
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = {"f64": 67e12, "f32": 67e12, "bf16": 989e12}
# operations of one 512-point real FFT: the usual 5 N log2 N of a complex
# FFT, halved for a real input
RFFT_512_OPS = 5 * 512 * 9 // 2


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def bound(n_bytes: float, ops: dict):
    """(ms, "bytes" or "operations"): the larger of n_bytes over the memory
    rate and the operations ({type: count}) over each type's peak."""
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = sum(n / PEAK_OPS_S[kind] for kind, n in ops.items()) * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def log_mel_work(signals, lengths, spans, weights, out):
    """``log_mel``: per frame, pre-emphasis and the mask (3 x 400), a real
    512-point FFT and the power (3 x 257) in f64; a multiply-add for each
    non-zero of the sparse mel bank and a log per filter in f32. Bytes: the
    signal, the lengths, the sparse bank (its spans and weights) and the
    features."""
    b, t, nfilt = out.shape
    nnz = int((weights != 0).sum())
    return (nbytes(signals, lengths, spans, weights, out),
            {"f64": b * t * (3 * 400 + RFFT_512_OPS + 3 * 257),
             "f32": b * t * (2 * nnz + nfilt)})


def beam_search_work(frames: int, w: int, k: int, lengths, outputs):
    """``beam_search`` over ``frames`` valid frames: per frame W + 1
    log-probs and the K top-k pairs read; over the M = W (K + 1)
    candidates, 7 f32 operations per ordered pair (3 for the (h1, h2)
    equality, 1 for the first-occurrence test, 3 for the rank) and 16 per
    candidate (the two hash updates, 4; its score, 2; the two readouts' add
    and log, 4; a logaddexp, 6); the lengths read and the outputs written
    once. Nominal: the frames are a chain of dependent steps, which no such
    count sees."""
    m = w * (k + 1)
    return (frames * (w + 1 + 2 * k) * 4 + nbytes(lengths, *outputs),
            {"f32": frames * (7 * m * m + 16 * m)})


def _pairs(q, k, causal: bool) -> int:
    """Query-key pairs over the causal triangle (Tq <= Tk) or the
    rectangle."""
    b, h, tq, _ = q.shape
    return b * h * (tq * (tq + 1) // 2 if causal else tq * k.shape[2])


def _kind(q) -> str:
    return "f32" if q.element_size() == 4 else "bf16"


def masked_attention_work(q, k, v, k_valid, keep, out, causal: bool):
    """The masked attention forward: Q, K, V, the key mask, the keep mask
    (None for none) and the output; QK^T and P.V over the pairs."""
    return (nbytes(q, k, v, k_valid, keep, out),
            {_kind(q): 4 * _pairs(q, k, causal) * q.shape[3]})


def masked_attention_bwd_work(q, k, v, k_valid, dout, keep, grads,
                              causal: bool):
    """The masked attention backward: Q, K, V, dO, the key mask, the keep
    mask and the three gradients; S again, dP, dQ, dK and dV over the
    pairs."""
    return (nbytes(q, k, v, k_valid, dout, keep, *grads),
            {_kind(q): 10 * _pairs(q, k, causal) * q.shape[3]})


def cmvn_work(feat, valid, out):
    """``cmvn``: the rows each utterance counts (min(valid, T) of its T;
    the rest are written as 0 whatever they hold) read once, ``valid``
    read, the whole output written; three statistics and the normalising
    (6 f32 operations) per element read."""
    b, t, f = feat.shape
    rows = int(valid.long().clamp(0, t).sum())
    return (rows * f * feat.element_size() + nbytes(valid, out),
            {"f32": 6 * rows * f})


def _ctc_cells(valid, lens, t: int, first: int, rows=None):
    """Cells (frame, state) of the CTC DP that the data needs: the valid
    states of frames ``first`` .. min(len, T) - 1 of each utterance whose
    ``rows`` mask (None: every utterance) holds."""
    frames = (lens.long().clamp(0, t) - first).clamp(min=0)
    if rows is not None:
        frames = frames * rows.long()
    return int((frames * valid.long().sum(1)).sum())


def ctc_alpha_work(emit, init, can_skip, valid, lens, alphas):
    """``ctc_alpha``: the emissions of frames 1 .. len - 1 at each
    utterance's valid states (frame 0 is ``init``; past len alpha is
    frozen), ``init``, the masks and lengths read; the whole alpha stack
    written; ~14 f32 operations a needed cell."""
    cells = _ctc_cells(valid, lens, emit.shape[0], 1)
    return (cells * emit.element_size()
            + nbytes(init, can_skip, valid, lens, alphas),
            {"f32": 14 * cells})


def ctc_beta_xi_work(emit, alphas, binit, skip_from, valid, lens, total, xi):
    """``ctc_beta_xi``: for each utterance with a finite log P (the others'
    xi is 0 whatever they hold), the emissions of frames 1 .. len - 1 and
    the alphas of frames 0 .. len - 1 at its valid states; beta's end rows,
    the masks, lengths and log P read; the whole xi written; ~20 f32
    operations (beta, then xi) a needed cell."""
    from asr_dfcnn_transformer_torch.kernels.ctc import NEG_INF
    t = emit.shape[0]
    finite = total.float() > NEG_INF / 2
    e_cells = _ctc_cells(valid, lens, t, 1, finite)
    a_cells = _ctc_cells(valid, lens, t, 0, finite)
    return ((e_cells + a_cells) * emit.element_size()
            + nbytes(binit, skip_from, valid, lens, total, xi),
            {"f32": 20 * a_cells})


def topk_last_work(x, k: int):
    """``topk_last`` over x [..., V] (f32 on the card): each row read once
    and k values and k int32 ids written; k rounds of V compares a row."""
    v = x.shape[-1]
    n = x.numel() // v if v else 0
    return nbytes(x) + n * k * 8, {"f32": n * k * v}
