"""Time this tree's kernels against another checkout's, in turns, on one card.

    python3 -m asr_dfcnn_transformer_torch.compare_kernels \\
        --kernel {beam_search,cmvn,ctc_alpha,ctc_beta_xi,dual_attention,
                  fused_ffn,interleave_epilogue,log_mel,masked_attention,
                  masked_attention_bwd,topk_last} \\
        --other DIR [--out PATH]

``DIR`` is the root of another checkout of the repository (for example
the parent commit, unpacked with ``git archive``). Both kernel libraries
are built from their own ``csrc/`` (each by its own ``kernels/_build.py``)
and loaded into this one process; each is called through its own C entry
point on the same seeded inputs at the main paths' shapes:

- ``beam_search``: the beam path's lattice, log-probs [8, 200, 1536] f32
  with lengths [200, 0, 150, 50, 100, 173, 200, 1], W = K = 8, L 100, and
  the same at batch 1; prefixes and lengths held equal to this tree's
  twin, pb / pnb within 1e-5, and the two libraries' outputs compared bit
  for bit. No library yardstick.

- ``cmvn``: [16, 1600, 200] with every valid count T (AM training, as
  its batch has them), then with ragged valid counts [8, 1600, 200] (the
  served batch), [16, 1600, 200], [8, 1600, 80] (the e2e front end), [8,
  400, 200], [1, 1600, 200] and [2, 6400, 200] (long enough that this
  tree's kernel streams its rows); ragged counts include 0 and one above
  T (``check_inputs.cmvn_inputs``), and each case has a constant column
  (an empty mel filter's log eps). Held to this tree's twin within atol
  1e-5, the constant column exactly 0 where valid <= T, and this tree's
  kernel launched twice with the same bits. No one PyTorch call computes
  it.
- ``ctc_alpha``: ``chip_smoke.py``'s CTC problem, [T 200, B 16, S 129]
  with an empty label and an unsatisfiable row, then
  ``check_inputs.ALPHA_EDGES`` (T 1 and 2, S 1 to 1024 on both sides of
  the warp multiples, B 1, 64 and 200, lengths of 0 and past T); both
  libraries' alphas equal to this tree's twin and to each other bit for
  bit; the yardstick is ``F.ctc_loss``'s forward in device time.
- ``ctc_beta_xi``: the same CTC problem; both libraries' xi equal to this
  tree's twin and to each other bit for bit, the unsatisfiable row all
  zero; the yardstick is ``F.ctc_loss``'s backward (the profiler's device
  time of its forward and backward less its forward), its forward beside
  it.
- ``dual_attention``: the forward and the backward at the e2e pre-net's
  frequency rows [1072, 80, 64] (batch 8, bucket 1600); the forward held
  to this tree's twin within one bf16 ulp, the backward within 2e-2 with
  at most one element in 1000 differing; the library yardstick
  ``scaled_dot_product_attention``, forward and backward.
- ``fused_ffn``: [N, 512] with inner 2048 at N 4096 (LM training), 1072
  (the e2e encoder), 800 (LM serving), 8 (a decode step), and the wide
  [4096, 1024] with inner 4096; held to the twin within 2e-2 with at most
  one element in 100 differing; the yardstick ``F.linear`` -> relu ->
  ``F.linear`` on cuBLAS.
- ``interleave_epilogue``: z [128, 256, 512] in bf16 and f32 (the noise
  transform at n 262,144), [16, 256, 512] bf16, [3, 2, 4] (n 16), and
  ragged shapes with rows off 16-byte boundaries ([5, 33, 36] bf16, [5,
  33, 35] bf16 and [3, 7, 5] f32, the last two a view one element into
  its storage); both libraries equal to this tree's twin and to each
  other bit for bit. No one PyTorch call computes it: the note is the
  device time and rate (bytes read and written) of ``copy_`` on a
  contiguous [128, 512, 512] f32 tensor, what a plain copy reaches.
- ``log_mel``: [8, 256,240] f32 signals with ragged lengths to 1600
  frames, with the AM's 200 filters and the e2e front end's 80; held to
  the twin within rtol 1e-4, atol 1e-3, with the count of elements more
  than 1e-5 off and the largest difference. No one PyTorch call computes
  it: the note ``rfft`` is ``torch.fft.rfft`` (cuFFT) of the [12,800, 512]
  f64 frame matrix, the FFT stage alone.
- ``masked_attention``: the forward at every main-path shape: the LM
  served [8, 8, 100, 64] causal and trained [64, 8, 64, 64] causal at keep
  0.5, the e2e encoder [8, 8, 134, 64] at keep 0.9 and without a keep
  mask, the pre-net's time rows [640, 1, 134, 64], the decoder's causal [8,
  8, 65, 64] and its cross-attention q 65 / kv 134, both at keep 0.9;
  ragged keys with a fully invalid row; held to the twin within 2e-2,
  with the count of differing elements; the yardstick, where there is no
  keep mask, ``scaled_dot_product_attention`` with the float additive
  mask; and on the scalar kernel, f32 at the e2e encoder's [8, 8, 134,
  64] and bf16 at an LM input of 400 ids [8, 8, 400, 64] causal, whose
  outputs must equal the other library's bit for bit.
- ``masked_attention_bwd``: the LM's [64, 8, 64, 64] causal at keep 0.5
  and at keep 1.0, the e2e encoder's [8, 8, 134, 64] at keep 0.9 and the
  pre-net's time rows [640, 1, 134, 64] without a keep mask, ragged keys
  with a fully invalid row; held to the twin within 2e-2; the yardstick,
  at keep 1.0 only (no PyTorch call takes a keep mask), the backward of
  ``scaled_dot_product_attention`` with the float additive mask.
- ``topk_last``: ``check_inputs.topk_cases``: the beam path's log-softmax
  rows [1600, 1536] at k 8, 1 and 32, a streamed chunk [128, 1536], N 1,
  V 1, 33 and 2048, quantised ties with -0.0, rows with -inf entries and
  with fewer than k entries above -1e30; both libraries' ids and values
  equal to this tree's twin; the yardstick is ``torch.topk``'s device
  time (all its kernels).

Each case reports CUDA-event ms in turns (other, this, this, other), the
profiler's device time per call, the bound (the bytes over 3.35 TB/s or the
operations over their type's peak, 989 TFLOP/s of bf16, 67 of f32 or f64,
whichever is larger; ``bounds.py``'s counts, which ``chip_smoke.py`` uses
too) and the yardstick's CUDA-event ms and device time. Prints the card's
name and power limit, then one JSON object, which ``--out`` also receives.
Needs one CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import functools
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from asr_dfcnn_transformer_torch import bounds
from asr_dfcnn_transformer_torch.check_inputs import (ALPHA_EDGES,
                                                      EPILOGUE_CASES,
                                                      alpha_inputs,
                                                      cmvn_inputs,
                                                      ctc_dp_inputs,
                                                      ctc_loss_device_us,
                                                      ctc_problem,
                                                      epilogue_z, topk_cases)
from asr_dfcnn_transformer_torch.audio.fbank import (FbankConfig,
                                                     samples_for_frames)
from asr_dfcnn_transformer_torch.kernels import _build
from asr_dfcnn_transformer_torch.kernels import attention as attn
from asr_dfcnn_transformer_torch.kernels import beam as kbeam
from asr_dfcnn_transformer_torch.kernels import fbank as kfbank
from asr_dfcnn_transformer_torch.kernels.topk import topk_last_reference
from asr_dfcnn_transformer_torch.kernels.dual_attention import (
    _scale, dual_axis_attention_bwd_reference, dual_axis_attention_reference)
from asr_dfcnn_transformer_torch.kernels.ffn import fused_ffn_reference
from asr_dfcnn_transformer_torch.timing import (additive_mask, cuda_ms,
                                                device_us)

DUAL_SHAPE = (1072, 80, 64)  # B 8 x T' 134 rows of F' 80, C 64
DUAL_KERNELS = {             # __global__ names by library, bf16
    "fwd": ("dual_attention_kernel", "dual_attention_mma_kernel"),
    "bwd": ("dual_attention_bwd_kernel", "dual_attention_bwd_mma_kernel"),
}
FFN_SHAPES = ((4096, 512, 2048), (1072, 512, 2048), (800, 512, 2048),
              (8, 512, 2048), (4096, 1024, 4096))
FWD_CASES = (   # label, (B, H, Tq, Tk, Dh), causal, keep probability
    ("lm_serving", (8, 8, 100, 100, 64), True, 1.0),
    ("lm_training", (64, 8, 64, 64, 64), True, 0.5),
    ("e2e_encoder_keep", (8, 8, 134, 134, 64), False, 0.9),
    ("e2e_encoder", (8, 8, 134, 134, 64), False, 1.0),
    ("e2e_time_rows", (640, 1, 134, 134, 64), False, 1.0),
    ("decoder_causal", (8, 8, 65, 65, 64), True, 0.9),
    ("decoder_cross", (8, 8, 65, 134, 64), False, 0.9),
)
SCALAR_CASES = (   # the scalar kernel, held to the other library's bits
    ("e2e_encoder_f32", (8, 8, 134, 134, 64), False, 1.0),
    ("lm_long_bf16", (8, 8, 400, 400, 64), True, 1.0),
)
BEAM_LENS = (200, 0, 150, 50, 100, 173, 200, 1)   # chip_smoke's path case
BEAM_W, BEAM_L, BEAM_V = 8, 100, 1536
LOG_MEL_FRAMES, LOG_MEL_NFILT = 1600, (200, 80)
CMVN_CASES = (   # (B, T, F), valid counts ragged (else all T)
    ((16, 1600, 200), False), ((8, 1600, 200), True), ((16, 1600, 200), True),
    ((8, 1600, 80), True), ((8, 400, 200), True), ((1, 1600, 200), True),
    ((2, 6400, 200), True))
COPY_SHAPE = (128, 512, 512)   # f32, the noise case's output bytes
BWD_CASES = (   # label, (B, H, T, Dh), causal, keep probability
    ("lm", (64, 8, 64, 64), True, 0.5),
    ("lm_keep1", (64, 8, 64, 64), True, 1.0),
    ("e2e_encoder", (8, 8, 134, 64), False, 0.9),
    ("e2e_time_rows", (640, 1, 134, 64), False, 1.0),
)


def _other_library(root: Path):
    """The other checkout's kernel library, built by its own _build."""
    path = root / "asr_dfcnn_transformer_torch" / "kernels" / "_build.py"
    spec = importlib.util.spec_from_file_location("other_build", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.library()


# CUDA-event ms over 50 calls, profiler device us over 20
_ms = functools.partial(cuda_ms, iters=50)
_us = functools.partial(device_us, iters=20)


def _in_turns(other, this):
    o1, t1, t2, o2 = (_ms(f) for f in (other, this, this, other))
    return (o1 + o2) / 2, (t1 + t2) / 2


def _bound_ms(n_bytes: float, bf16_ops: float) -> float:
    return bounds.bound(n_bytes, {"bf16": bf16_ops})[0]


def _share(bound_ms: float, device_us):
    """The bound's share of the kernel's device time (None where the trace
    showed none)."""
    return None if device_us is None else bound_ms / (device_us / 1e3)


def _bf16(rng, shape, dev, scale=1.0, dtype=torch.bfloat16):
    return torch.from_numpy((scale * rng.standard_normal(shape)).astype(
        np.float32)).to(dev, dtype)


def _masks(rng, b, h, tq, tk, kp, dev):
    """Ragged key validity [b, tk] with one fully invalid row, and a keep
    mask [b, h, tq, tk] at ``kp`` (None at 1.0)."""
    k_valid = torch.from_numpy(rng.uniform(size=(b, tk)) > 0.3).to(dev)
    k_valid[:, 0] = True
    k_valid[0] = False                           # one fully invalid row
    keep = (None if kp == 1.0 else torch.from_numpy(
        rng.uniform(size=(b, h, tq, tk)) < kp).to(dev))
    return k_valid, keep


def _differing(got, want, tol: float, most: float) -> int:
    """The count of elements that differ from the twin; exits where one is
    farther than tol + tol |want| or more than a share ``most`` differ."""
    n = 0
    for a, b in zip(got, want):
        d = (a.float() - b.float()).abs()
        if not bool((d <= tol + tol * b.float().abs()).all()):
            raise SystemExit(f"disagrees with the twin beyond {tol}")
        n = max(n, int((a != b).sum()))
        if n > a.numel() * most:
            raise SystemExit(f"{n} elements differ from the twin")
    return n


def _fwd_ulp(got, want) -> int:
    diff = (got.float() - want.float()).abs()
    _, e = torch.frexp(want.float())
    ulp = torch.where(want == 0, 2.0 ** -133,
                      torch.ldexp(torch.ones_like(diff), e - 8))
    if not bool((diff <= ulp).all()):
        raise SystemExit("forward disagrees with the twin by more than one "
                         "bf16 ulp")
    return int((got != want).sum())


def compare_dual_attention(libs, dev, rng) -> dict:
    q, k, v, g = (_bf16(rng, DUAL_SHAPE, dev) for _ in range(4))
    r, t, c = DUAL_SHAPE
    scale = _scale(c)
    stream = _build.stream_ptr(dev)
    out = {n: torch.empty_like(q) for n in libs}
    grads = {n: tuple(torch.empty_like(q) for _ in range(3)) for n in libs}

    def fwd(n):
        def run():
            rc = libs[n].asr_dual_attention(
                1, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                out[n].data_ptr(), r, t, c, scale, stream)
            if rc:
                raise SystemExit(f"{n} forward launch failed: {rc}")
        return run

    def bwd(n):
        def run():
            rc = libs[n].asr_dual_attention_bwd(
                1, q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                *(x.data_ptr() for x in grads[n]), r, t, c, scale, stream)
            if rc:
                raise SystemExit(f"{n} backward launch failed: {rc}")
        return run

    want = dual_axis_attention_reference(q, k, v)
    want_b = dual_axis_attention_bwd_reference(q, k, v, g)
    res = {"shape": list(DUAL_SHAPE), "dtype": "bfloat16"}
    for n in libs:
        fwd(n)()
        bwd(n)()
    torch.cuda.synchronize()
    for i, n in enumerate(libs):
        res[f"fwd_{n}_differing"] = _fwd_ulp(out[n], want)
        res[f"bwd_{n}_differing"] = _differing(grads[n], want_b, 2e-2, 1e-3)
        res[f"fwd_{n}_device_us"] = _us(fwd(n), DUAL_KERNELS["fwd"][i])
        res[f"bwd_{n}_device_us"] = _us(bwd(n), DUAL_KERNELS["bwd"][i])
    res["fwd_other_ms"], res["fwd_this_ms"] = _in_turns(fwd("other"),
                                                        fwd("this"))
    res["bwd_other_ms"], res["bwd_this_ms"] = _in_turns(bwd("other"),
                                                        bwd("this"))
    n_bytes = 2 * r * t * c
    res["fwd_bound_ms"] = _bound_ms(4 * n_bytes, 4 * r * t * t * c)
    res["bwd_bound_ms"] = _bound_ms(7 * n_bytes, 10 * r * t * t * c)

    q4, k4, v4 = (x[:, None].detach().requires_grad_(True) for x in (q, k, v))
    sdpa = F.scaled_dot_product_attention(q4, k4, v4)
    g4 = g[:, None]

    def sdpa_fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(q4, k4, v4)

    def sdpa_bwd():
        torch.autograd.grad(sdpa, (q4, k4, v4), g4, retain_graph=True)

    res["sdpa_fwd_ms"] = _ms(sdpa_fwd)
    res["sdpa_fwd_device_us"] = _us(sdpa_fwd, None)
    res["sdpa_bwd_ms"] = _ms(sdpa_bwd)
    res["sdpa_bwd_device_us"] = _us(sdpa_bwd, None)
    for n in ("fwd", "bwd"):
        for side in ("other", "this"):
            res[f"{n}_{side}_share_of_bound"] = (
                res[f"{n}_bound_ms"] / (res[f"{n}_{side}_device_us"] / 1e3))
    return res


def compare_fused_ffn(libs, dev, rng) -> dict:
    stream = _build.stream_ptr(dev)
    res = {"dtype": "bfloat16"}
    for n, d, f in FFN_SHAPES:
        x = _bf16(rng, (n, d), dev)
        w1, w2 = _bf16(rng, (f, d), dev, d ** -0.5), _bf16(rng, (d, f), dev,
                                                           f ** -0.5)
        b1, b2 = _bf16(rng, (f,), dev, 0.1), _bf16(rng, (d,), dev, 0.1)
        ws = torch.empty(libs["this"].asr_fused_ffn_plan(1, n, d, f, 6) // 4
                         + 1, dtype=torch.float32, device=dev)
        out = {side: torch.empty_like(x) for side in libs}

        def call(side):
            lib = libs[side]
            ptrs = [x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                    b2.data_ptr(), out[side].data_ptr()]
            if hasattr(lib, "asr_fused_ffn_plan"):   # takes a workspace
                ptrs.append(ws.data_ptr())

            def run():
                rc = lib.asr_fused_ffn(1, *ptrs, n, d, f, stream)
                if rc:
                    raise SystemExit(f"{side} fused_ffn failed: {rc}")
            return run

        def library():
            return F.linear(torch.relu(F.linear(x, w1) + b1), w2) + b2

        key = f"ffn_{n}x{d}_f{f}"
        want = fused_ffn_reference(x, w1, b1, w2, b2)
        for side in libs:
            call(side)()
            torch.cuda.synchronize()
            res[f"{key}_{side}_differing"] = _differing(
                (out[side],), (want,), 2e-2, 1e-2)
            res[f"{key}_{side}_device_us"] = _us(call(side),
                                                        "ffn_bf16")
        res[f"{key}_other_ms"], res[f"{key}_this_ms"] = _in_turns(
            call("other"), call("this"))
        res[f"{key}_bound_ms"] = _bound_ms(
            2 * (2 * n * d + 2 * f * d + f + d), 4 * n * d * f)
        res[f"{key}_library_ms"] = _ms(library)
        res[f"{key}_library_device_us"] = _us(library, None)
    return res


def compare_masked_attention(libs, dev, rng) -> dict:
    stream = _build.stream_ptr(dev)
    res = {"dtype": "bfloat16; f32 where the label says so"}
    for label, (b, h, tq, tk, dh), causal, kp in FWD_CASES + SCALAR_CASES:
        dtype = torch.float32 if label.endswith("f32") else torch.bfloat16
        scalar = label in {case[0] for case in SCALAR_CASES}
        q = _bf16(rng, (b, h, tq, dh), dev, dtype=dtype)
        k, v = (_bf16(rng, (b, h, tk, dh), dev, dtype=dtype)
                for _ in range(2))
        k_valid, keep = _masks(rng, b, h, tq, tk, kp, dev)
        out = {side: torch.empty_like(q) for side in libs}

        def call(side):
            def run():
                rc = libs[side].asr_masked_attention(
                    _build.DTYPE_CODES[dtype], q.data_ptr(), k.data_ptr(),
                    v.data_ptr(),
                    k_valid.data_ptr(),
                    None if keep is None else keep.data_ptr(), kp,
                    out[side].data_ptr(), b, h, tq, tk, dh, attn._scale(dh),
                    int(causal), stream)
                if rc:
                    raise SystemExit(f"{side} forward failed: {rc}")
            return run

        want = attn.masked_attention_reference(q, k, v, k_valid, causal, keep,
                                               kp)
        key = f"fwd_{label}"
        tol = 1e-5 if dtype == torch.float32 else 2e-2
        for side in libs:
            call(side)()
            torch.cuda.synchronize()
            res[f"{key}_{side}_differing"] = _differing((out[side],), (want,),
                                                        tol, 1.0)
            res[f"{key}_{side}_device_us"] = _us(call(side),
                                                 "masked_attention")
        res[f"{key}_other_ms"], res[f"{key}_this_ms"] = _in_turns(
            call("other"), call("this"))
        res[f"{key}_bound_ms"] = bounds.bound(*bounds.masked_attention_work(
            q, k, v, k_valid, keep, out["this"], causal))[0]
        if scalar:
            same = torch.equal(out["this"], out["other"])
            res[f"{key}_sides_bit_equal"] = same
            if not same:
                raise SystemExit(f"{label}: the two libraries' outputs "
                                 "differ")
            continue
        if keep is not None:
            continue
        mask = additive_mask(k_valid, tq, tk, causal, torch.bfloat16)

        def sdpa():
            F.scaled_dot_product_attention(q, k, v, attn_mask=mask)

        res[f"{key}_library_ms"] = _ms(sdpa)
        res[f"{key}_library_device_us"] = _us(sdpa, None)
    return res


def compare_masked_attention_bwd(libs, dev, rng) -> dict:
    stream = _build.stream_ptr(dev)
    res = {"dtype": "bfloat16"}
    for label, (b, h, t, dh), causal, kp in BWD_CASES:
        q, k, v, g = (_bf16(rng, (b, h, t, dh), dev) for _ in range(4))
        k_valid, keep = _masks(rng, b, h, t, t, kp, dev)
        grads = {side: tuple(torch.empty_like(q) for _ in range(3))
                 for side in libs}
        stats = torch.empty((3, b, h, t), dtype=torch.float32, device=dev)

        def call(side):
            def run():
                rc = libs[side].asr_masked_attention_bwd(
                    1, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    k_valid.data_ptr(),
                    None if keep is None else keep.data_ptr(), kp,
                    g.data_ptr(), *(x.data_ptr() for x in grads[side]),
                    stats.data_ptr(), b, h, t, t, dh, attn._scale(dh),
                    int(causal), stream)
                if rc:
                    raise SystemExit(f"{side} backward failed: {rc}")
            return run

        want = attn.masked_attention_bwd_reference(q, k, v, k_valid, g,
                                                   causal, keep, kp)
        key = f"bwd_{label}"
        for side in libs:
            call(side)()
            torch.cuda.synchronize()
            res[f"{key}_{side}_differing"] = _differing(grads[side], want,
                                                        2e-2, 1.0)
            res[f"{key}_{side}_device_us"] = _us(
                call(side), "masked_attention_bwd")
        res[f"{key}_other_ms"], res[f"{key}_this_ms"] = _in_turns(
            call("other"), call("this"))
        res[f"{key}_bound_ms"] = bounds.bound(
            *bounds.masked_attention_bwd_work(q, k, v, k_valid, g, keep,
                                              grads["this"], causal))[0]
        if keep is not None:
            continue
        mask = additive_mask(k_valid, t, t, causal, torch.bfloat16)
        q4, k4, v4 = (x.detach().requires_grad_(True) for x in (q, k, v))
        out = F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask)

        def sdpa_bwd():
            torch.autograd.grad(out, (q4, k4, v4), g, retain_graph=True)

        res[f"{key}_library_ms"] = _ms(sdpa_bwd)
        res[f"{key}_library_device_us"] = _us(sdpa_bwd, None)
    return res


def compare_beam_search(libs, dev, rng) -> dict:
    stream = _build.stream_ptr(dev)
    res = {"dtype": "float32", "W": BEAM_W, "K": BEAM_W, "L": BEAM_L}
    for label, lens in (("path", BEAM_LENS), ("batch1", BEAM_LENS[:1])):
        b, t, v = len(lens), max(BEAM_LENS), BEAM_V
        lp = torch.log_softmax(_bf16(rng, (b, t, v), dev, 2.0,
                                     torch.float32), -1)
        top_lp, top_ids = topk_last_reference(lp, BEAM_W)
        lens_d = torch.tensor(lens, dtype=torch.int32, device=dev)
        outs = {side: (torch.empty((b, BEAM_W, BEAM_L), dtype=torch.int32,
                                   device=dev),
                       torch.empty((b, BEAM_W), dtype=torch.int32,
                                   device=dev),
                       torch.empty((b, BEAM_W), device=dev),
                       torch.empty((b, BEAM_W), device=dev))
                for side in libs}
        scratch = torch.empty((b, t, BEAM_W), dtype=torch.int32, device=dev)

        def call(side):
            lib = libs[side]
            ptrs = [lp.data_ptr(), top_lp.data_ptr(), top_ids.data_ptr(),
                    lens_d.data_ptr()]
            if len(lib.asr_beam_search.argtypes) == 17:   # back-pointers
                ptrs.append(scratch.data_ptr())
            ptrs += [o.data_ptr() for o in outs[side]]

            def run():
                rc = lib.asr_beam_search(*ptrs, b, t, v, BEAM_W, BEAM_W,
                                         v - 1, BEAM_L, stream)
                if rc:
                    raise SystemExit(f"{side} beam_search failed: {rc}")
            return run

        want = kbeam.beam_search_reference(
            lp, top_lp, top_ids, lens_d, beam_width=BEAM_W, topk=BEAM_W,
            blank=v - 1, max_decode_len=BEAM_L)
        key = f"beam_{label}"
        for side in libs:
            call(side)()
            torch.cuda.synchronize()
            got = outs[side]
            if not (torch.equal(got[0], want[0])
                    and torch.equal(got[1], want[1])):
                raise SystemExit(f"{side} beam_search: prefixes or lengths "
                                 "differ from the twin")
            err = max(float((g - w).abs().max())
                      for g, w in zip(got[2:], want[2:]))
            if err > 1e-5:
                raise SystemExit(f"{side} beam_search: pb / pnb {err} from "
                                 "the twin")
            res[f"{key}_{side}_max_abs_err"] = err
            res[f"{key}_{side}_device_us"] = _us(call(side),
                                                 "beam_search_kernel")
        res[f"{key}_sides_bit_equal"] = all(
            torch.equal(a, c) for a, c in zip(outs["this"], outs["other"]))
        res[f"{key}_other_ms"], res[f"{key}_this_ms"] = _in_turns(
            call("other"), call("this"))
        frames = sum(min(n, t) for n in lens)
        res[f"{key}_bound_ms"] = bounds.bound(*bounds.beam_search_work(
            frames, BEAM_W, BEAM_W, lens_d, outs["this"]))[0]
    return res


def compare_log_mel(libs, dev, rng) -> dict:
    stream = _build.stream_ptr(dev)
    res = {"dtype": "float32"}
    s = samples_for_frames(LOG_MEL_FRAMES)
    t = np.arange(s) / 16000.0
    f0 = rng.uniform(120.0, 400.0, size=(8, 1))
    sig = torch.from_numpy((0.3 * np.sin(2 * np.pi * f0 * t)
                            + 0.01 * rng.standard_normal((8, s))).astype(
        np.float32)).to(dev)
    lens = torch.from_numpy(rng.integers(s // 4, s + 1, size=8).astype(
        np.int32)).to(dev)
    for nfilt in LOG_MEL_NFILT:
        cfg = FbankConfig(nfilt=nfilt)
        cos_b, sin_b, mel = kfbank._bases(cfg, dev)
        tw, spans, weights = kfbank._fft_tables(cfg, dev)
        out = {side: torch.empty((8, LOG_MEL_FRAMES, nfilt), device=dev)
               for side in libs}

        def call(side):
            lib = libs[side]
            tables = ((tw, spans, weights) if side == "this"
                      else (cos_b, sin_b, mel))

            def run():
                rc = lib.asr_log_mel(
                    sig.data_ptr(), lens.data_ptr(),
                    *(x.data_ptr() for x in tables), out[side].data_ptr(), 8,
                    s, LOG_MEL_FRAMES, nfilt, cfg.preemph, 1.0 / cfg.nfft,
                    stream)
                if rc:
                    raise SystemExit(f"{side} log_mel failed: {rc}")
            return run

        want = kfbank.log_mel_reference(sig, lens, LOG_MEL_FRAMES, cfg)
        key = f"log_mel_nfilt{nfilt}"
        for side in libs:
            call(side)()
            torch.cuda.synchronize()
            d = (out[side] - want).abs()
            if not bool((d <= 1e-3 + 1e-4 * want.abs()).all()):
                raise SystemExit(f"{side} log_mel: {float(d.max())} from "
                                 "the twin")
            res[f"{key}_{side}_max_abs_err"] = float(d.max())
            res[f"{key}_{side}_over_1e-5"] = int((d > 1e-5).sum())
            res[f"{key}_{side}_device_us"] = _us(call(side), "log_mel")
        res[f"{key}_other_ms"], res[f"{key}_this_ms"] = _in_turns(
            call("other"), call("this"))
        res[f"{key}_bound_ms"] = bounds.bound(*bounds.log_mel_work(
            sig, lens, spans, weights, out["this"]))[0]
    need = (LOG_MEL_FRAMES - 1) * 160 + 400
    frames = torch.nn.functional.pad(sig, (0, max(0, need - s)))[:, :need] \
        .unfold(1, 400, 160).reshape(-1, 400).double().contiguous()

    def rfft():
        torch.fft.rfft(frames, 512)

    res["rfft_f64_frames"] = list(frames.shape)
    res["rfft_ms"] = _ms(rfft)
    res["rfft_device_us"] = _us(rfft, None)
    return res


def compare_cmvn(libs, dev, rng) -> dict:
    stream = _build.stream_ptr(dev)
    res = {"dtype": "float32"}
    for (b, t, f), ragged in CMVN_CASES:
        feat, valid = (torch.from_numpy(a).to(dev) for a in cmvn_inputs(
            rng, b, t, f, const_cols=(5,), ragged=ragged))
        out = {side: torch.empty_like(feat) for side in libs}

        def call(side, dst=None):
            target = out[side] if dst is None else dst

            def run():
                rc = libs[side].asr_cmvn(feat.data_ptr(), valid.data_ptr(),
                                         target.data_ptr(), b, t, f, stream)
                if rc:
                    raise SystemExit(f"{side} cmvn failed: {rc}")
            return run

        want = kfbank.cmvn_reference(feat, valid)
        key = f"cmvn_{b}x{t}x{f}_{'ragged' if ragged else 'full'}"
        again = torch.empty_like(feat)
        for side in libs:
            call(side)()
            torch.cuda.synchronize()
            err = float((out[side] - want).abs().max())
            if err > 1e-5:
                raise SystemExit(f"{side} cmvn {key}: {err} from the twin")
            res[f"{key}_{side}_max_abs_err"] = err
            res[f"{key}_{side}_device_us"] = _us(call(side), "cmvn_kernel")
        call("this", again)()
        torch.cuda.synchronize()
        if not torch.equal(again, out["this"]):
            raise SystemExit(f"cmvn {key}: two launches differ")
        short = (valid <= t).nonzero()[:, 0]
        if not bool((out["this"][short][:, :, 5] == 0).all()):
            raise SystemExit(f"cmvn {key}: the constant column is not 0")
        res[f"{key}_plan"] = {
            k: int(libs["this"].asr_cmvn_plan(b, t, f, i)) for i, k in
            enumerate(("cluster", "rows", "chunk", "groups", "stream",
                       "smem", "clusters_at_once"))}
        res[f"{key}_other_ms"], res[f"{key}_this_ms"] = _in_turns(
            call("other"), call("this"))
        res[f"{key}_bound_ms"] = bounds.bound(
            *bounds.cmvn_work(feat, valid, out["this"]))[0]
        res[f"{key}_this_share_of_bound"] = (
            res[f"{key}_bound_ms"] / (res[f"{key}_this_device_us"] / 1e3))
    return res


def compare_ctc_beta_xi(libs, dev, rng) -> dict:
    from asr_dfcnn_transformer_torch.kernels import ctc as kctc
    stream = _build.stream_ptr(dev)
    logits, logit_len, labels, label_len = ctc_problem(rng)
    d = ctc_dp_inputs(logits, logit_len, labels, label_len, dev)
    emit = d["emit"]
    args = d["xi_args"]
    t, b, s = emit.shape
    out = {side: torch.empty_like(emit) for side in libs}

    def call(side):
        def run():
            rc = libs[side].asr_ctc_beta_xi(
                *(x.data_ptr() for x in args), out[side].data_ptr(), t, b, s,
                stream)
            if rc:
                raise SystemExit(f"{side} ctc_beta_xi failed: {rc}")
        return run

    want = kctc.beta_xi_reference(*args)
    res = {"dtype": "float32", "shape": [t, b, s]}
    for side in libs:
        call(side)()
        torch.cuda.synchronize()
        if not torch.equal(out[side], want):
            raise SystemExit(f"{side} ctc_beta_xi is not its twin's bits")
        res[f"{side}_device_us"] = _us(call(side), "ctc_beta_xi_kernel")
    res["sides_bit_equal"] = torch.equal(out["this"], out["other"])
    if not res["sides_bit_equal"]:
        raise SystemExit("ctc_beta_xi: the two libraries' outputs differ")
    res["unsatisfiable_row_zero"] = bool((out["this"][:, 2] == 0).all())
    if not res["unsatisfiable_row_zero"]:
        raise SystemExit("ctc_beta_xi: the unsatisfiable row is not 0")
    res["other_ms"], res["this_ms"] = _in_turns(call("other"), call("this"))
    res["bound_ms"] = bounds.bound(
        *bounds.ctc_beta_xi_work(*args, out["this"]))[0]
    res["this_share_of_bound"] = res["bound_ms"] / (res["this_device_us"]
                                                    / 1e3)
    res["ctc_loss_fwd_device_us"], res["ctc_loss_bwd_device_us"] = (
        ctc_loss_device_us(d, labels, iters=20))
    return res


def compare_ctc_alpha(libs, dev, rng) -> dict:
    from asr_dfcnn_transformer_torch.kernels import ctc as kctc
    stream = _build.stream_ptr(dev)
    logits, logit_len, labels, label_len = ctc_problem(rng)
    d = ctc_dp_inputs(logits, logit_len, labels, label_len, dev)
    cases = [("main", tuple(d[k] for k in ("emit", "init", "can_skip",
                                           "valid", "lens")))]
    for label, t, b, s in ALPHA_EDGES:
        cases.append((label, tuple(torch.from_numpy(a).to(dev)
                                   for a in alpha_inputs(rng, t, b, s))))
    res = {"dtype": "float32"}
    for label, args in cases:
        t, b, s = args[0].shape
        out = {side: torch.empty_like(args[0]) for side in libs}

        def call(side):
            def run():
                rc = libs[side].asr_ctc_alpha(
                    *(x.data_ptr() for x in args), out[side].data_ptr(), t,
                    b, s, stream)
                if rc:
                    raise SystemExit(f"{side} ctc_alpha failed: {rc}")
            return run

        want = kctc.alpha_stack_reference(*args)
        key = f"alpha_{label}"
        res[f"{key}_shape"] = [t, b, s]
        for side in libs:
            call(side)()
            torch.cuda.synchronize()
            if not torch.equal(out[side], want):
                raise SystemExit(f"{side} ctc_alpha {label} is not its "
                                 "twin's bits")
            res[f"{key}_{side}_device_us"] = _us(call(side),
                                                 "ctc_alpha_kernel")
        if not torch.equal(out["this"], out["other"]):
            raise SystemExit(f"ctc_alpha {label}: the two libraries differ")
        res[f"{key}_other_ms"], res[f"{key}_this_ms"] = _in_turns(
            call("other"), call("this"))
        res[f"{key}_bound_ms"] = bounds.bound(
            *bounds.ctc_alpha_work(*args, out["this"]))[0]
        res[f"{key}_this_share_of_bound"] = _share(
            res[f"{key}_bound_ms"], res[f"{key}_this_device_us"])
    res["ctc_loss_fwd_device_us"], _ = ctc_loss_device_us(d, labels,
                                                          iters=20)
    return res


def compare_topk_last(libs, dev, rng) -> dict:
    stream = _build.stream_ptr(dev)
    res = {"dtype": "float32"}
    for label, x, k in topk_cases(rng, dev):
        n, v = x.shape
        out = {side: (torch.empty((n, k), device=dev),
                      torch.empty((n, k), dtype=torch.int32, device=dev))
               for side in libs}

        def call(side):
            def run():
                rc = libs[side].asr_topk_last(
                    x.data_ptr(), out[side][0].data_ptr(),
                    out[side][1].data_ptr(), n, v, k, stream)
                if rc:
                    raise SystemExit(f"{side} topk_last failed: {rc}")
            return run

        want_v, want_i = topk_last_reference(x, k)
        key = f"topk_{label}"
        res[f"{key}_shape"] = [n, v, k]
        for side in libs:
            call(side)()
            torch.cuda.synchronize()
            got_v, got_i = out[side]
            if not (torch.equal(got_i, want_i) and torch.equal(got_v,
                                                               want_v)):
                raise SystemExit(f"{side} topk_last {label}: ids or values "
                                 "differ from the twin")
            res[f"{key}_{side}_device_us"] = _us(call(side),
                                                 "topk_last_kernel")
        res[f"{key}_other_ms"], res[f"{key}_this_ms"] = _in_turns(
            call("other"), call("this"))
        res[f"{key}_bound_ms"] = bounds.bound(
            *bounds.topk_last_work(x, k))[0]
        res[f"{key}_this_share_of_bound"] = _share(
            res[f"{key}_bound_ms"], res[f"{key}_this_device_us"])
        res[f"{key}_torch_topk_device_us"] = _us(
            lambda: torch.topk(x, k, dim=-1), None)
    return res


def compare_interleave_epilogue(libs, dev, rng) -> dict:
    from asr_dfcnn_transformer_torch.kernels.fft_epilogue import (
        interleave_epilogue_reference)
    stream = _build.stream_ptr(dev)
    res = {}
    for label, shape, dtype, offset in EPILOGUE_CASES:
        b, n2, n1 = shape
        n = 2 * n1 * n2
        zr, zi = (epilogue_z(rng, shape, dtype, offset, dev)
                  for _ in range(2))
        out = {side: torch.empty((b, n), device=dev) for side in libs}

        def call(side):
            def run():
                rc = libs[side].asr_interleave_epilogue(
                    _build.DTYPE_CODES[dtype], zr.data_ptr(), zi.data_ptr(),
                    out[side].data_ptr(), b, n2, n1, 1.0 / n, stream)
                if rc:
                    raise SystemExit(f"{side} interleave_epilogue failed: "
                                     f"{rc}")
            return run

        want = interleave_epilogue_reference(zr, zi, n)
        key = f"epilogue_{label}"
        res[f"{key}_shape"] = [b, n2, n1, str(dtype), offset]
        for side in libs:
            call(side)()
            torch.cuda.synchronize()
            if not torch.equal(out[side], want):
                raise SystemExit(f"{side} interleave_epilogue {label} is "
                                 "not its twin's bits")
            res[f"{key}_{side}_device_us"] = _us(
                call(side), "interleave_epilogue_kernel")
        if not torch.equal(out["this"], out["other"]):
            raise SystemExit(f"interleave_epilogue {label}: the two "
                             "libraries differ")
        res[f"{key}_other_ms"], res[f"{key}_this_ms"] = _in_turns(
            call("other"), call("this"))
        res[f"{key}_bound_ms"] = bounds.bound(
            bounds.nbytes(zr, zi, out["this"]), {})[0]
        res[f"{key}_this_share_of_bound"] = _share(
            res[f"{key}_bound_ms"], res[f"{key}_this_device_us"])
    # a note, not a yardstick (no one call computes the relayout): what a
    # plain contiguous copy reaches, bytes read and written over its time
    x = torch.empty(COPY_SHAPE, device=dev)
    y = torch.empty_like(x)
    us = _us(lambda: y.copy_(x), None)
    res["copy_f32_device_us"] = us
    res["copy_f32_tb_s"] = 2 * bounds.nbytes(x) / (us * 1e-6) / 1e12
    return res


COMPARE = {"beam_search": compare_beam_search,
           "cmvn": compare_cmvn,
           "ctc_alpha": compare_ctc_alpha,
           "ctc_beta_xi": compare_ctc_beta_xi,
           "dual_attention": compare_dual_attention,
           "log_mel": compare_log_mel,
           "fused_ffn": compare_fused_ffn,
           "interleave_epilogue": compare_interleave_epilogue,
           "masked_attention": compare_masked_attention,
           "masked_attention_bwd": compare_masked_attention_bwd,
           "topk_last": compare_topk_last}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernel", required=True, choices=sorted(COMPARE))
    ap.add_argument("--other", required=True, type=Path)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(smi)
    libs = {"other": _other_library(args.other.resolve()),
            "this": _build.library()}
    dev = torch.device("cuda")
    res = {"kernel": args.kernel, "device": torch.cuda.get_device_name(0),
           "nvidia_smi": smi}
    res.update(COMPARE[args.kernel](libs, dev, np.random.default_rng(0)))
    line = json.dumps(res)
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
