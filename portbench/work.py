"""The yardstick of the rooflines and MFU: the chip's peaks, and each op's
work from the cell's own shapes and lengths, never from the program.

A roofline share is the least time the chip could take for the work
(the larger of its bytes over the memory rate and its operations over each
type's peak) over the measured device time. The work counts each input
byte read once and each output byte written once, and only what the data
needs (valid frames, valid CTC states): a frozen copy of the counting of
``asr_dfcnn_transformer_torch/bounds.py``, over shapes instead of tensors.

MFU counts the model's multiply-adds (2 operations each) from the
configuration's widths at the shapes run.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

from portbench.traffic import frames_for

# One H100 SXM at 700 W (NVIDIA data sheet, dense rates).
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = {"f64": 67e12, "f32": 67e12, "bf16": 989e12}
RFFT_512_OPS = 5 * 512 * 9 // 2
WIN = 400

Work = Tuple[float, Dict[str, float]]


def add(*works: Work) -> Work:
    b, ops = 0.0, {}
    for wb, wo in works:
        b += wb
        for k, v in wo.items():
            ops[k] = ops.get(k, 0.0) + v
    return b, ops


def bound_s(work: Work) -> float:
    b, ops = work
    return max(b / PEAK_BYTES_S,
               sum(n / PEAK_OPS_S[k] for k, n in ops.items()))


def log_mel(lengths: Iterable[int], frames: int, nfilt: int,
            bank_nnz: int, bank_bytes: int) -> Work:
    """Per valid frame: pre-emphasis and the mask (3 x 400), a real
    512-point FFT and the power (3 x 257) in f64; a multiply-add per
    non-zero of the mel bank and a log per filter in f32. Bytes: the valid
    samples and the lengths read, the bank read, all B x T x nfilt features
    written."""
    lens = list(lengths)
    valid = sum(min(frames_for(n), frames) for n in lens)
    samples = sum(lens)
    return (4 * samples + 4 * len(lens) + bank_bytes
            + 4 * len(lens) * frames * nfilt,
            {"f64": valid * (3 * WIN + RFFT_512_OPS + 3 * 257),
             "f32": valid * (2 * bank_nnz + nfilt)})


def cmvn(lengths: Iterable[int], frames: int, nfilt: int) -> Work:
    """The valid rows read once, the counts read, the whole output
    written; 6 f32 operations per element read."""
    lens = list(lengths)
    rows = sum(min(frames_for(n), frames) for n in lens)
    return (4 * rows * nfilt + 4 * len(lens) + 4 * len(lens) * frames * nfilt,
            {"f32": 6 * rows * nfilt})


def causal_attention(b: int, h: int, t: int, dh: int, elem: int = 2) -> Work:
    """The masked causal forward: Q, K, V and the output, the key mask
    (a byte a key); QK^T and P.V over the causal pairs."""
    pairs = b * h * t * (t + 1) // 2
    kind = "bf16" if elem == 2 else "f32"
    return 4 * b * h * t * dh * elem + b * t, {kind: 4 * pairs * dh}


def ctc(logit_lengths: Iterable[int], label_lengths: Iterable[int],
        t: int) -> Work:
    """The alpha and beta-xi passes over the cells the data needs: frames
    below each length at its 2L + 1 states; alpha reads the emissions of
    frames 1.. and writes its cells (14 f32 operations a cell); beta-xi
    reads the emissions and alphas and writes xi (20 a cell)."""
    cells = sum(min(n, t) * (2 * l + 1) for n, l in zip(logit_lengths,
                                                        label_lengths))
    return 4 * (cells + cells) + 4 * (cells + cells + cells), \
        {"f32": 34 * cells}


# ---- model multiply-adds -------------------------------------------------

def _conv(cin: int, cout: int, t: int, f: int) -> float:
    return 2.0 * cin * cout * 9 * t * f


def am_flops(cfg: dict, frames: int) -> float:
    """Forward operations of one utterance through the acoustic model at
    ``frames`` input frames."""
    a = cfg["am"]
    t, f, cin, total = frames, a["feature_dim"], 1, 0.0
    if a["family"] == "se_dfcnn":
        for c, pool, ratio in zip(a["stage_features"], a["stage_pool"],
                                  a["se_ratio"]):
            total += _conv(cin, c, t, f)
            if pool:
                t, f = t // 2, f // 2
            total += _conv(c, c, t, f)
            total += 2.0 * 2 * c * max(c // ratio, 1)
            cin = c
        total += _conv(cin, a["head_features"], t, f)
        total += 2.0 * t * f * a["head_features"] * a["vocab_size"]
        return total
    for c, pool in zip(a["stage_features"], a["stage_pool"]):
        total += _conv(cin, c, t, f) + _conv(c, c, t, f)
        if pool:
            t, f = t // 2, f // 2
        cin = c
    total += 2.0 * t * f * cin * a["dense_units"]
    total += 2.0 * t * a["dense_units"] * a["vocab_size"]
    return total


def lm_flops(cfg: dict, positions: int) -> float:
    """Forward operations of one row of ``positions`` through the LM: four
    projections and the 4x FFN a position, the causal attention pairs, the
    logits head."""
    m = cfg["lm"]
    d, t = m["d_model"], positions
    per_pos = 2.0 * (4 * d * d + 8 * d * d)
    attn = 2.0 * 2 * d * t * (t + 1) / 2
    return m["num_blocks"] * (t * per_pos + attn) + \
        2.0 * t * d * m["output_vocab_size"]


def train_flops(cfg: dict, frames: int) -> float:
    """Forward and backward of the acoustic model for one utterance: the
    backward takes the weight and input gradients, twice the forward, less
    the first convolution's input gradient, which nothing needs."""
    first = _conv(1, cfg["am"]["stage_features"][0], frames,
                  cfg["am"]["feature_dim"])
    return 3.0 * am_flops(cfg, frames) - first
