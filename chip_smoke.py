#!/usr/bin/env python3
"""Drive the PyTorch port's AM -> LM serving path once on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Phases, each of which fails the run (non-zero exit) when it fails:

1. Device: the card's name and power limit (nvidia-smi), then a build of
   every CUDA kernel of the path from ``asr_dfcnn_transformer_torch/csrc``.
2. Kernels against their plain-PyTorch twins on the card, on seeded inputs
   at the main path's shapes (``log_mel`` + ``cmvn``, ``masked_attention``
   in f32 and bf16), each with its tolerance; then each kernel's time
   beside its twin's (CUDA events after warm-up).
3. The served main path: full-width SE-DFCNN + 12-block Transformer LM in
   bf16 from a seeded ``torch.Generator``, behind the port's ``Pipeline``
   and ``BatchingServer`` (max_batch 8, buckets 400/800/1200/1600), answering
   16 synthetic tone utterances. The launch counters are reset just before
   and read just after: every kernel must have been launched.
4. Card against CPU: two utterances at bucket 400 in f32, on the card
   through the kernels and on the CPU through the twins; pinyin (per-frame)
   and hanzi ids must agree wherever the CPU's top-2 logit margin >= 1e-3.

The line before the last is a JSON object with each kernel's launches,
error and times; the last line is ``{"ok": true, "device": {...}}``. Without
CUDA the script exits non-zero and prints no result.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import time
from concurrent.futures import as_completed

import numpy as np

SEED = 0
DEVICE = "cuda"
SAMPLE_RATE = 16000
BUCKETS = (400, 800, 1200, 1600)
MAX_BATCH = 8
SERVED_SECONDS = (0.5, 1.2, 2.0, 3.0, 3.9, 4.5, 6.0, 7.5, 8.0, 9.0, 10.5,
                  11.9, 12.5, 14.0, 15.0, 15.9)
KERNELS = {
    "log_mel": ("asr_dfcnn_transformer_torch/csrc/fbank.cu",
                "asr_dfcnn_transformer_tpu/ops/pallas/fbank_kernel.py:202"),
    "cmvn": ("asr_dfcnn_transformer_torch/csrc/fbank.cu",
             "asr_dfcnn_transformer_tpu/ops/pallas/fbank_kernel.py:168"),
    "masked_attention": (
        "asr_dfcnn_transformer_torch/csrc/attention.cu",
        "asr_dfcnn_transformer_tpu/ops/pallas/attn_kernel.py:531"),
}


class PhaseError(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def tone_utterance(rng: np.random.Generator, n: int) -> np.ndarray:
    """A synthetic utterance of n samples: 200 ms harmonic tones at random
    pitches with a little noise, float32 in [-1, 1]."""
    t = np.arange(n) / SAMPLE_RATE
    seg = int(0.2 * SAMPLE_RATE)
    f0 = np.repeat(rng.uniform(120.0, 400.0, size=n // seg + 1), seg)[:n]
    phase = 2 * np.pi * np.cumsum(f0) / SAMPLE_RATE
    x = sum(0.3 / h * np.sin(h * phase) for h in (1, 2, 3))
    x = x * (0.6 + 0.4 * np.sin(2 * np.pi * 2.5 * t))
    x = x + 0.01 * rng.standard_normal(n)
    return x.astype(np.float32)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() in ms from CUDA events, after warm-up."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def paired_ms(kernel_fn, plain_fn):
    """(kernel ms, plain ms), timed in turns plain, kernel, kernel, plain."""
    p1 = cuda_ms(plain_fn)
    k1 = cuda_ms(kernel_fn)
    k2 = cuda_ms(kernel_fn)
    p2 = cuda_ms(plain_fn)
    return (k1 + k2) / 2, (p1 + p2) / 2


def close_enough(got, want, rtol: float, atol: float):
    """(ok, max |got - want|) under |got - want| <= atol + rtol |want|."""
    diff = (got.float() - want.float()).abs()
    ok = bool((diff <= atol + rtol * want.float().abs()).all())
    return ok, float(diff.max())


# ---------------------------------------------------------------- phases

def phase_device():
    import torch
    from asr_dfcnn_transformer_torch.kernels import _build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi)                       # name, power limit as nvidia-smi has them
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.library()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s "
          f"({_build.BUILD_ROOT})")
    for line in _build.build_log().splitlines():
        if "registers" in line or "Compiling entry" in line \
                or "spill" in line:
            print(f"  ptxas: {line.strip()}")


def phase_kernels(results):
    import torch
    from asr_dfcnn_transformer_torch.audio.fbank import (mel_filterbank,
                                                         samples_for_frames,
                                                         valid_frames)
    from asr_dfcnn_transformer_torch.kernels import (
        cmvn, cmvn_reference, log_mel, log_mel_reference, masked_attention,
        masked_attention_reference)
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(SEED)
    empty = torch.from_numpy(np.flatnonzero(mel_filterbank().sum(0) == 0))

    for out_frames in (400, 1600):
        s = samples_for_frames(out_frames)
        # noise past each length too: the kernel must mask it away
        sig = np.stack([tone_utterance(rng, s)
                        for _ in range(8)])
        lens = rng.integers(s // 4, s + 1, size=8).astype(np.int32)
        lens[0], lens[1] = s, 300
        sig_d = torch.from_numpy(sig).to(dev)
        lens_d = torch.from_numpy(lens).to(dev)
        feat = log_mel(sig_d, lens_d, out_frames)
        feat_ref = log_mel_reference(sig_d, lens_d, out_frames)
        ok, err = close_enough(feat, feat_ref, 1e-4, 1e-3)
        print(f"log_mel [8, {s}] -> {out_frames} frames: max abs err "
              f"{err:.3g} (rtol 1e-4, atol 1e-3) {'ok' if ok else 'FAIL'}")
        require(ok, "log_mel disagrees with its twin")
        valid = valid_frames(lens_d)
        norm = cmvn(feat, valid)
        norm_ref = cmvn_reference(feat, valid)
        ok, err_c = close_enough(norm, norm_ref, 0.0, 2e-3)
        zero = bool((norm[:, :, empty.to(dev)] == 0).all())
        print(f"cmvn [8, {out_frames}, 200]: max abs err {err_c:.3g} "
              f"(atol 2e-3), empty-filter columns exactly 0: {zero}")
        require(ok and zero, "cmvn disagrees with its twin")
        if out_frames == BUCKETS[-1]:
            results["log_mel"]["max_abs_err"] = err
            results["cmvn"]["max_abs_err"] = err_c
            k_ms, p_ms = paired_ms(
                lambda: log_mel(sig_d, lens_d, out_frames),
                lambda: log_mel_reference(sig_d, lens_d, out_frames))
            results["log_mel"].update(ms=k_ms, plain_ms=p_ms)
            k_ms, p_ms = paired_ms(lambda: cmvn(feat, valid),
                                   lambda: cmvn_reference(feat, valid))
            results["cmvn"].update(ms=k_ms, plain_ms=p_ms)

    tol = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
    for shape in ((16, 8, 100, 100, 64), (2, 2, 7, 7, 32),
                  (MAX_BATCH, 8, 100, 100, 64)):
        b, h, tq, tk, dh = shape
        q, k, v = (torch.from_numpy(rng.standard_normal(
            (b, h, t, dh)).astype(np.float32)).to(dev) for t in (tq, tk, tk))
        k_valid = torch.from_numpy(rng.uniform(size=(b, tk)) > 0.3).to(dev)
        k_valid[:, 0] = True
        k_valid[0] = False                      # one fully invalid row
        for dtype in (torch.float32, torch.bfloat16):
            qd, kd, vd = (x.to(dtype) for x in (q, k, v))
            got = masked_attention(qd, kd, vd, k_valid, causal=True)
            want = masked_attention_reference(qd, kd, vd, k_valid, True)
            ok, err = close_enough(got, want, tol[dtype], tol[dtype])
            finite = bool(torch.isfinite(got.float()).all())
            print(f"masked_attention {list(shape)} {dtype}: max abs err "
                  f"{err:.3g} (tol {tol[dtype]}) finite {finite} "
                  f"{'ok' if ok else 'FAIL'}")
            require(ok and finite, "masked_attention disagrees with its twin")
            if b == MAX_BATCH and dtype == torch.bfloat16:
                results["masked_attention"]["max_abs_err"] = err
                k_ms, p_ms = paired_ms(
                    lambda: masked_attention(qd, kd, vd, k_valid,
                                             causal=True),
                    lambda: masked_attention_reference(qd, kd, vd, k_valid,
                                                       True))
                results["masked_attention"].update(ms=k_ms, plain_ms=p_ms)
    for name, r in results.items():
        print(f"time {name}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms")


def build_models(dtype, device):
    import torch
    from asr_dfcnn_transformer_torch import vocab
    from asr_dfcnn_transformer_torch.models import (SEDFCNN, SEDFCNNConfig,
                                                    TransformerLM,
                                                    TransformerLMConfig)
    av, lv = vocab.acoustic_vocab(), vocab.language_vocab()
    gen = torch.Generator().manual_seed(SEED)
    am = SEDFCNN(SEDFCNNConfig(av.size, dtype=dtype), device=device,
                 generator=gen)
    lm = TransformerLM(TransformerLMConfig(av.size, lv.size, dtype=dtype),
                       device=device, generator=gen)
    return am, lm, av, lv


def phase_served(results):
    import torch
    from asr_dfcnn_transformer_torch.infer import BatchingServer, Pipeline
    from asr_dfcnn_transformer_torch.kernels import LAUNCHES, reset_launches
    am, lm, av, lv = build_models(torch.bfloat16, DEVICE)
    n_params = sum(p.numel() for m in (am, lm) for p in m.parameters())
    print(f"models: SE-DFCNN 32/64/128/128/128 head 256 vocab {av.size}, "
          f"LM 12x512x8 vocab {lv.size}, bf16, {n_params / 1e6:.1f} M params")
    pipe = Pipeline(am, lm, acoustic_vocab=av, language_vocab=lv)
    rng = np.random.default_rng(SEED + 1)
    warm = [tone_utterance(rng, (b - 20) * 160) for b in BUCKETS]
    utts = [tone_utterance(rng, int(sec * SAMPLE_RATE))
            for sec in SERVED_SECONDS]

    reset_launches()
    with BatchingServer(pipe, max_batch=MAX_BATCH, max_wait_ms=20.0,
                        bucket_bounds=BUCKETS) as srv:
        for f in [srv.submit(u) for u in warm]:
            f.result(timeout=600)
        # latency: submit -> the future is seen resolved (as_completed
        # wakes on each completion; a done-callback could still be pending
        # when result() returns)
        t0 = time.perf_counter()
        futures = {srv.submit(u): i for i, u in enumerate(utts)}
        lat = {}
        for fut in as_completed(futures, timeout=600):
            lat[futures[fut]] = time.perf_counter() - t0
        outs = [fut.result() for fut in futures]
        stats = srv.stats
    counts = dict(LAUNCHES)
    for pinyin, hanzi in outs:
        require(isinstance(pinyin, list)
                and all(isinstance(p, str) for p in pinyin)
                and isinstance(hanzi, str), "result is not (pinyin, hanzi)")
    wall = max(lat.values())
    lat = sorted(lat.values())
    print(f"served {len(outs)} utterances ({stats.requests} requests "
          f"incl. {len(warm)} warm-up, {stats.batches} batches, occupancy "
          f"{stats.mean_occupancy:.2f}, per bucket {stats.per_bucket})")
    print(f"served burst of {len(utts)}: {len(utts) / wall:.2f} utt/s, "
          f"p50 latency {1e3 * lat[len(lat) // 2]:.1f} ms, max "
          f"{1e3 * lat[-1]:.1f} ms")
    print(f"example: {len(outs[0][0])} pinyin, first "
          f"{' '.join(outs[0][0][:5])!r}, hanzi {outs[0][1][:8]!r}")
    print(f"launch counts on the served path: {counts}")
    for name in KERNELS:
        require(counts.get(name, 0) > 0, f"{name} was never launched")
        results[name]["launches"] = counts[name]


def phase_card_vs_cpu():
    import torch
    from asr_dfcnn_transformer_torch.audio.fbank import (batched_fbank,
                                                         samples_for_frames)
    from asr_dfcnn_transformer_torch.models import (frames_from_samples,
                                                    logit_lengths)
    from asr_dfcnn_transformer_torch.ops import ctc_greedy_decode
    am_cpu, lm_cpu, _, _ = build_models(torch.float32, "cpu")
    am_gpu = copy.deepcopy(am_cpu).to(DEVICE).eval()
    lm_gpu = copy.deepcopy(lm_cpu).to(DEVICE).eval()
    rng = np.random.default_rng(SEED + 2)
    s = samples_for_frames(BUCKETS[0])
    sig = np.zeros((2, s), np.float32)
    lens = np.array([s, 2 * s // 3], np.int32)
    for i, n in enumerate(lens):
        sig[i, :n] = tone_utterance(rng, n)

    def run(am, lm, dev, pny_for_lm=None):
        x = torch.from_numpy(sig).to(dev)
        n = torch.from_numpy(lens).to(dev)
        feats, _ = batched_fbank(x, n, out_frames=BUCKETS[0])
        logits = am(feats[:, None])
        in_len = logit_lengths(frames_from_samples(n), logits.shape[1])
        ids, ids_len = ctc_greedy_decode(logits, in_len, max_output_len=100)
        lm_in = ids if pny_for_lm is None else pny_for_lm.to(dev)
        return (logits.cpu(), in_len.cpu(), ids.cpu(), ids_len.cpu(),
                lm(lm_in.long()).cpu())

    def margin(x):
        top2 = torch.topk(x, 2, dim=-1).values
        return top2[..., 0] - top2[..., 1]

    with torch.inference_mode():
        c_logits, c_len, c_ids, c_ids_len, c_lm = run(am_cpu, lm_cpu, "cpu")
        g_logits, _, g_ids, g_ids_len, g_lm = run(am_gpu, lm_gpu, DEVICE,
                                                  pny_for_lm=c_ids)
    frames = torch.arange(c_logits.shape[1])[None, :] < c_len[:, None]
    sure = frames & (margin(c_logits) >= 1e-3)
    am_bad = int((sure & (c_logits.argmax(-1) != g_logits.argmax(-1))).sum())
    pos = torch.arange(c_lm.shape[1])[None, :] < c_ids_len[:, None]
    sure_lm = pos & (margin(c_lm) >= 1e-3)
    lm_bad = int((sure_lm & (c_lm.argmax(-1) != g_lm.argmax(-1))).sum())
    seq_equal = bool(torch.equal(c_ids, g_ids)
                     and torch.equal(c_ids_len, g_ids_len))
    print(f"card vs CPU, f32, bucket {BUCKETS[0]}: AM logits max abs diff "
          f"{float((c_logits - g_logits).abs().max()):.3g}; frame argmax "
          f"mismatches {am_bad} of {int(sure.sum())} frames with margin >= "
          f"1e-3 ({int(frames.sum())} valid)")
    print(f"  pinyin lengths {c_ids_len.tolist()}, decoded pinyin equal: "
          f"{seq_equal}; LM logits max abs diff "
          f"{float((c_lm - g_lm).abs().max()):.3g}; hanzi mismatches "
          f"{lm_bad} of {int(sure_lm.sum())} positions with margin >= 1e-3")
    require(am_bad == 0 and lm_bad == 0, "card and CPU ids disagree")
    if bool((margin(c_logits)[frames] >= 1e-3).all()):
        require(seq_equal, "decoded pinyin differs with every margin >= 1e-3")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = {name: {"name": name, "route": "cuda", "source": src,
                      "replaces": rep}
               for name, (src, rep) in KERNELS.items()}
    phase_device()
    phase_kernels(results)
    phase_served(results)
    phase_card_vs_cpu()
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                  for r in results.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
