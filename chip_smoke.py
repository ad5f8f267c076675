#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths once on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Phases, each of which fails the run (non-zero exit) when it fails:

1. Device: the card's name and power limit (nvidia-smi), then a build of
   every CUDA kernel of the paths from ``asr_dfcnn_transformer_torch/csrc``
   (the compiler's registers and spills, and each kernel's count of
   tensor-core HMMA instructions from ``cuobjdump -sass``).
2. Kernels against their plain-PyTorch twins on the card, on seeded inputs
   at the main paths' shapes (``log_mel`` + ``cmvn``, ``log_mel`` also at
   the e2e front end's 80 filters, with the count of elements more than
   1e-5 off the twin; ``cmvn`` within atol 1e-5 of its twin, launched twice
   with the same bits, padding rows and (where valid <= T) an empty
   filter's column exactly 0, its tiling held to ``kernels/fbank.py``
   ``cmvn_plan``, at [8, 400 and 1600, 200], [16, 1600, 200], [8, 1600,
   80], [8, 400, 200], [1, 1600, 200], a streamed [2, 6400, 200] and [3,
   37, 1030] (bins in passes), with valid counts of 0 and above T; the
   ``masked_attention`` forward, with and without a keep mask, in f32 (the
   scalar kernel) and bf16 (the tensor-core kernel) at every forward shape
   of the LM and e2e paths: the LM served [8 and 16, 8, 100, 64] causal
   and trained [64, 8, 64, 64] causal at keep 0.5, the pre-net's time rows
   [640, 1, 134, 64], the encoder [8, 8, 134, 64] without a keep mask and
   at keep 0.9, the decoder's causal [8, 8, 65, 64] and cross q 65 / kv
   134 at keep 0.9, and a tiny [2, 2, 7, 32]; then in bf16 at the edges of
   the tensor-core tiles (B 2, H 3; Tq / Tk / Dh 1 / 1 / 7, 17 / 33 / 16,
   160 / 160 / 64 causal, 134 / 65 / 32 at keep 0.9, 65 / 134 / 64 causal,
   1600 / 64 / 64 causal at keep 0.9) and off them on the scalar kernel
   (Tk 161, Dh 128); each on its path (``fwd_path`` held to the C query,
   its shared memory too), with its count of differing elements, launched
   twice with bit-identical results; the forward and backward at long key
   lengths, f32 [1, 4, 256, 128] (scores kept in shared memory), f32 [1,
   8, 600, 64] at keep 0.9 and bf16 [1, 8, 1000, 64] (scores recomputed),
   causal with ragged keys and a query row without a valid key, with the
   scalar forward's shared memory (``fwd_smem_bytes``) held to the C query;
   ``ctc_alpha`` + ``ctc_beta_xi`` at B 16, T 200, S 129, both equal to
   their twins bit for bit (``ctc_alpha`` launched 20 more times with the
   same bits, also at ``check_inputs.ALPHA_EDGES``: T 1 and 2, S 1 to
   1024 on both sides of the warp multiples, B 1, 64 and 200, lengths of
   0 and past T; ``ctc_beta_xi`` launched twice with the same bits, its
   launch held to ``beta_xi_plan``, also at T 1, T below and past the
   ring's 8 slots and S 601 and 1023); the
   attention backward at the LM's training shape; ``topk_last`` at [1600,
   1536], k 8, in f32 and bf16, and at ``check_inputs.topk_cases`` (k 1 and
   32, a streamed chunk, N 1, V 1, 33 and 2048, ties with -0.0, -inf rows
   and rows with fewer than k entries above -1e30), timed beside
   ``torch.topk``'s device time, and ``beam_search`` at [8, 200, 1536], W =
   K = 8, L 100, with batch-1,
   exhausted-candidate and tie-heavy cases; ``dual_axis_attention`` at
   the e2e pre-net's frequency rows [1072, 80, 64] in bf16 and f32, its
   unmasked time rows [640, 134, 64], a ragged [13, 7, 32] and, in bf16,
   the edges of the tensor-core tiles ([45, 160, 128], [45, 33, 7], [45,
   17, 16], [45, 1, 1]), forward
   and backward, with the backward's shared-memory layout held to the C
   query and its refusal of the f32 time rows and of bf16 [., 160, 128];
   the ``masked_attention`` backward at the teacher-forced decoder's
   cross-attention shape, q [8, 8, 65, 64] against key-masked kv [8, 8,
   134, 64], in bf16 and f32, with the forwards' times there; the
   masked attention backward in f32 at e2e training's T' 134, Dh 64, the
   encoder's [8, 8, 134, 64] and the pre-net's time rows [640, 1, 134,
   64], with its shared-memory layout held to the C query; the bf16
   backward at every shape of the LM and e2e training paths (the LM's
   causal [64, 8, 64, 64] at keep 1.0 and 0.5, the encoder at keep 0.9,
   the time rows, the decoder's causal [8, 8, 65, 64] and its cross
   shape), each on the tensor-core path (``bwd_path`` held to the C
   query, its shared memory too), launched twice with bit-identical
   results, and at keep 1.0 timed beside the backward of
   ``scaled_dot_product_attention`` with the float mask; the bf16
   backward off those paths, the same way: the chunked launches at
   [8, 8, 200, 64] (causal, keep 0.9) and [8, 4, 64, 128], the
   tensor-core kernel at B 2, H 3 and Tq / Tk / Dh 1 / 1 / 7, 160 / 160 /
   64 (causal), 134 / 65 / 32 (keep 0.9) and 17 / 33 / 16;
   ``fused_ffn``
   at [4096, 512], [800, 512], [1072, 512], [8, 512], [1, 512] and
   [200, 512] (inner 2000) in bf16 and [800, 512] in f32, inner 2048, at
   [4096, 1024] in bf16 and [800, 1024] in f32, inner 4096, and at
   ragged widths, each launched twice with the same output and with its
   tiling (``kernels/ffn.py`` plan) held to the launcher's;
   ``interleave_epilogue`` bit for bit at ``check_inputs.EPILOGUE_CASES``:
   [128, 256, 512] in bf16 and f32, [16, 256, 512], [3, 2, 4], and ragged
   shapes with rows off 16-byte boundaries), each
   with its tolerance; then each kernel's time beside its twin's (CUDA
   events after warm-up, in turns), its bound computed from the inputs, and
   the time of the one PyTorch call that computes the same function, where
   there is one.
3. The served main path: full-width SE-DFCNN + 12-block Transformer LM in
   bf16 from a seeded ``torch.Generator``, behind the port's ``Pipeline``
   and ``BatchingServer`` (max_batch 8, buckets 400/800/1200/1600), answering
   16 synthetic tone utterances, once with ``decode="greedy"`` and once with
   ``decode="beam"`` (W = K = 8). The launch counters are reset just before
   and read just after each: every kernel of that path must have been
   launched.
4. Card against CPU: two utterances at bucket 400 in f32, on the card
   through the kernels and on the CPU through the twins; pinyin (per-frame)
   and hanzi ids must agree wherever the CPU's top-2 logit margin >= 1e-3;
   the beam decode of the CPU's logits on both devices must give the same
   ids and lengths.
5. The training path at full width, bf16 compute and f32 parameters: 10
   ``AMTrainer`` steps (SE-DFCNN, batch 16 at bucket 1600, 48-token labels
   padded to 64) and 10 ``LMTrainer`` steps (12x512x8 LM, dropout 0.5,
   batch 64 x 64) on one fixed synthetic batch each; every loss finite,
   the last below the first, every parameter with a finite gradient after
   the first step; ms/step and peak memory; one eval step and one epoch of
   ``fit`` with a checkpoint each. The launch counters are reset just
   before and read just after: every training kernel must have run.
6. Card against CPU for one training step of each trainer, f32, small
   widths, dropout 0, the same weights: the gradients must agree.
7. The e2e speech Transformer served: full width (80-bin fbank, LFR 4/3,
   64-channel pre-net, 6 + 6 blocks of d 512, 8 heads, vocab 6347) in bf16
   from a seeded ``torch.Generator``, behind ``E2EServing`` (buckets 128 /
   512 / 1600, batch sizes 1 / 8), answering the same 16 tone utterances,
   once with the greedy decode and once with beam K = 3 (lp_alpha 0.6,
   max_len 64). The launch counters are reset just before and read just
   after each: ``log_mel``, ``cmvn``, ``masked_attention`` and
   ``dual_axis_attention`` must have run, the last twice per encode.
8. Card against CPU for the e2e model: two utterances at bucket 512 in
   f32, the same weights; the encoder memory must agree, and the greedy and
   beam ids up to the first step at which the CPU's decision margin falls
   below 1e-3, with the beam scores where the ids agree.
9. The e2e model trained at full width, bf16 compute and f32 parameters:
   10 ``E2ETrainer`` steps on one fixed batch (8 tone utterances at bucket
   1600, hanzi labels of 24-48 tokens padded to 64, dropout 0.1,
   SpecAugment on); every loss finite, the last below the first, every
   parameter with a finite gradient after the first step; ms/step and peak
   memory; one eval step and one ``fit`` epoch with a checkpoint and the
   epoch marker. The launch counters are reset just before and read just
   after the steps: every kernel of the path must have run, and
   ``dual_axis_attention`` and its backward exactly twice a step.
10. Card against CPU for one e2e training step: small widths, f32,
    dropout 0, SpecAugment off, the same weights, the CPU's features on
    both, at bucket 512 and at bucket 1600 with Dh 64 (d_model 128 in 2
    heads, 64 pre-net channels: the f32 attention backward at T' 134); the
    loss and every gradient must agree.
11. ``fused_ffn="pallas"``: the LM and the e2e model built through
    ``train/factory.py`` from the default ``Config`` with that selector,
    full width, bf16: one AM -> LM served batch, one e2e greedy batch at
    bucket 1600, one ``LMTrainer`` step and one ``E2ETrainer`` step, with
    the launch counters reset before and read after each: ``fused_ffn``
    exactly 12 times a batch or step, 6 + 6 per cached step for the e2e
    decode; finite losses and gradients. Then the same seeded models in f32
    with "pallas" and "einsum": the LM's hanzi and the e2e greedy ids must
    agree wherever the einsum model's margin >= 1e-3.
12. Colored-noise AM training: (a) ``irfft_matmul`` at [128, 131,073] ->
    262,144 with ``epilogue="pallas"`` (``interleave_epilogue`` once a
    call) bit-equal to "xla", both near cuFFT, with the three transforms'
    times; (b) card against CPU: the noise mixtures on the same draws, and
    one small f32 noisy, SpecAugmented ``AMTrainer`` step's loss and
    gradients; (c) 10 full-width ``AMTrainer(augment_noise=True,
    augment_spec=True)`` steps on phase 5's batch (the noise at n 262,144
    through cuFFT), beside phase 5's clean step; (d) a synthetic corpus, its
    offline noise corpus, and one ``fit`` epoch of the full-width noisy AM
    on the port's ``DataLoader`` batches with a checkpoint. The launch
    counters are reset before and read after each path.
13. The port's CLI (``train/cli.py`` ``main``, in this process) at full
    width in a temporary workdir over its ``--synthetic 64`` corpus (bucket
    128): ``am`` and ``lm`` one epoch each (every logged loss finite, the
    identity stamps written), ``eval`` greedy and ``--decode beam`` (two
    accuracy lines each, a pred_log of 4 lines an utterance + 2),
    ``eval-lm``, ``infer`` on a tone wav, ``export --format tf1`` of both
    models (their tensors the checkpoints' bit for bit) and ``eval
    --am-tf-ckpt --lm-tf-ckpt`` (the greedy eval's accuracy lines and
    pred_log exactly), ``eval --model se_dfcnn_pre`` refused with a
    ``ModelIdentityError`` naming ``se_first``, ``e2e`` one epoch and
    ``eval-e2e``, and ``eval --config`` selecting ``fused_ffn="pallas"``
    (12 launches an eval batch); each command's wall time, with the launch
    counters reset before and read after it: every kernel of its path
    must have run. Then ``--small`` f32 models trained by the CLI on the
    CPU, served through ``Pipeline.from_checkpoints`` on the CPU and on the
    card over the test batches, agree by phase 4's rule.

The line before the last is a JSON object with each kernel's launches,
error and times; the last line is ``{"ok": true, "device": {...}}``. Without
CUDA the script exits non-zero and prints no result.
"""

from __future__ import annotations

import copy
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import as_completed
from pathlib import Path

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
    "masked_attention_drop": (
        "asr_dfcnn_transformer_torch/csrc/attention.cu",
        "asr_dfcnn_transformer_tpu/ops/pallas/attn_kernel.py:484"),
    "masked_attention_bwd": (
        "asr_dfcnn_transformer_torch/csrc/attention.cu",
        "asr_dfcnn_transformer_tpu/ops/pallas/attn_kernel.py:411"),
    "ctc_alpha": ("asr_dfcnn_transformer_torch/csrc/ctc.cu",
                  "asr_dfcnn_transformer_tpu/ops/pallas/ctc_kernel.py:123"),
    "ctc_beta_xi": ("asr_dfcnn_transformer_torch/csrc/ctc.cu",
                    "asr_dfcnn_transformer_tpu/ops/pallas/ctc_kernel.py:156"),
    "topk_last": ("asr_dfcnn_transformer_torch/csrc/topk.cu",
                  "asr_dfcnn_transformer_tpu/ops/pallas/topk_kernel.py:66"),
    "beam_search": ("asr_dfcnn_transformer_torch/csrc/beam.cu",
                    "asr_dfcnn_transformer_tpu/ops/pallas/beam_kernel.py:543"),
    "dual_axis_attention": (
        "asr_dfcnn_transformer_torch/csrc/dual_attention.cu",
        "asr_dfcnn_transformer_tpu/ops/pallas/attn_kernel.py:589"),
    "dual_axis_attention_bwd": (
        "asr_dfcnn_transformer_torch/csrc/dual_attention.cu",
        "asr_dfcnn_transformer_tpu/ops/pallas/attn_kernel.py:176"),
    "fused_ffn": ("asr_dfcnn_transformer_torch/csrc/ffn.cu",
                  "asr_dfcnn_transformer_tpu/ops/pallas/ffn_kernel.py:146"),
    "interleave_epilogue": (
        "asr_dfcnn_transformer_torch/csrc/fft_epilogue.cu",
        "asr_dfcnn_transformer_tpu/ops/pallas/fft_epilogue.py:47"),
}
SERVED = {"greedy": ("log_mel", "cmvn", "masked_attention"),
          "beam": ("log_mel", "cmvn", "masked_attention", "topk_last",
                   "beam_search")}                     # launched by phase 3
BEAM_WIDTH = 8        # Pipeline's default: W = K = 8
LM_MAX_LEN = 100      # the LM's positions: the decode's prefix cap
TRAINED = ("masked_attention_drop", "masked_attention_bwd", "ctc_alpha",
           "ctc_beta_xi")                              # launched by phase 5
AM_BATCH, AM_BUCKET, AM_LABELS = 16, 1600, (48, 64)   # AmConfig.batch_size
LM_BATCH, LM_LEN = 64, 64                             # LmConfig.batch_size
TRAIN_STEPS, WARMUP_STEPS = 10, 2
LM_LR = 5e-4          # 10x LmConfig.lr: ten steps show the fit through dropout
E2E_SERVED = ("log_mel", "cmvn", "masked_attention",
              "dual_axis_attention")                  # launched by phase 7
E2E_NFILT, E2E_LFR = 80, (4, 3)                       # E2EConfig
E2E_BEAM, E2E_MAX_LEN = 3, 64                         # E2EConfig.beam_size
E2E_CMP_BUCKET = 512
E2E_MEMORY_ATOL = 2e-3
E2E_TRAINED = ("log_mel", "cmvn", "masked_attention", "masked_attention_drop",
               "masked_attention_bwd", "dual_axis_attention",
               "dual_axis_attention_bwd")             # launched by phase 9
E2E_BATCH, E2E_BUCKET, E2E_LABELS = 8, 1600, (48, 64)  # E2EConfig.batch_size
E2E_LR = 1e-3         # 3.3x E2EConfig.lr: ten steps show the fit, dropout on
MARGIN = 1e-3
NOISE_BATCH, NOISE_N = 128, 262144    # irfft_matmul's docstring shape


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


def paired_ms(kernel_fn, plain_fn, plain_iters: int = 20):
    """(kernel ms, plain ms), timed in turns plain, kernel, kernel, plain."""
    from asr_dfcnn_transformer_torch.timing import cuda_ms
    p1 = cuda_ms(plain_fn, plain_iters, min(3, plain_iters))
    k1 = cuda_ms(kernel_fn)
    k2 = cuda_ms(kernel_fn)
    p2 = cuda_ms(plain_fn, plain_iters, min(3, plain_iters))
    return (k1 + k2) / 2, (p1 + p2) / 2


def nbytes(*tensors) -> int:
    from asr_dfcnn_transformer_torch.bounds import nbytes
    return nbytes(*tensors)


def set_bound(result, n_bytes: float, ops: dict) -> None:
    """The least time the card could take (``bounds.bound``): the larger of
    the bytes over the memory rate and the operations ({type: count}) over
    each type's peak."""
    from asr_dfcnn_transformer_torch.bounds import bound
    result["bound_ms"], result["bound_by"] = bound(n_bytes, ops)


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
    for name, count in sass_hmma_counts(_build.build()).items():
        print(f"  sass: {name}: {count} HMMA")


def sass_hmma_counts(lib) -> dict:
    """The count of HMMA (tensor-core) instructions in each kernel of the
    library that has any, from ``cuobjdump -sass``; {} where the toolkit
    has no cuobjdump."""
    from asr_dfcnn_transformer_torch.kernels import _build
    tool = Path(_build.find_nvcc()).with_name("cuobjdump")
    if not tool.is_file():
        return {}
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
        elif name and "HMMA" in line:
            counts[name] = counts.get(name, 0) + 1
    return counts


def phase_kernels(results):
    rng = np.random.default_rng(SEED)
    check_front_end(results, rng)
    check_attention_fwd(results, rng)
    check_attention_long(rng)
    check_ctc_kernels(results, rng)
    check_attention_training_kernels(results, rng)
    check_beam_kernels(results, rng)
    check_dual_attention(results, rng)
    check_cross_attention(rng)
    check_attention_bwd_f32(rng)
    check_attention_bwd_edges(rng)
    check_fused_ffn(results, rng)
    check_interleave_epilogue(results, rng)
    for name, r in results.items():
        lib = ("—" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms")
        print(f"time {name}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms "
              f"({r['bound_by']}), library {lib}")


def check_front_end(results, rng):
    """``log_mel`` and ``cmvn`` against their twins on tone utterances with
    noise past each length, at 400 and 1600 frames (``log_mel`` at 1600
    also with the e2e front end's 80 filters): ``log_mel`` within rtol
    1e-4, atol 1e-3, ``cmvn`` as ``cmvn_case`` holds it (atol 1e-5, equal
    to the numpy mirror of its order of sums, the empty filters' columns
    exactly 0); then both timed at 1600 frames beside their twins and
    their bounds, and ``cmvn`` at ``CMVN_CASES``."""
    import torch
    from asr_dfcnn_transformer_torch.audio.fbank import (FbankConfig,
                                                         mel_filterbank,
                                                         samples_for_frames,
                                                         valid_frames)
    from asr_dfcnn_transformer_torch.bounds import cmvn_work, log_mel_work
    from asr_dfcnn_transformer_torch.kernels import fbank as kfbank
    from asr_dfcnn_transformer_torch.kernels import (cmvn, cmvn_reference,
                                                     log_mel,
                                                     log_mel_reference)
    dev = torch.device(DEVICE)
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
              f"{err:.3g} (rtol 1e-4, atol 1e-3), "
              f"{int(((feat - feat_ref).abs() > 1e-5).sum())} of "
              f"{feat.numel()} elements more than 1e-5 off "
              f"{'ok' if ok else 'FAIL'}")
        require(ok, "log_mel disagrees with its twin")
        if out_frames == BUCKETS[-1]:
            # the e2e front end's 80 filters, at its 1600-frame bucket
            cfg80 = FbankConfig(nfilt=E2E_NFILT)
            feat80 = log_mel(sig_d, lens_d, out_frames, cfg80)
            ref80 = log_mel_reference(sig_d, lens_d, out_frames, cfg80)
            ok80, err80 = close_enough(feat80, ref80, 1e-4, 1e-3)
            print(f"log_mel [8, {s}] -> {out_frames} frames, nfilt "
                  f"{E2E_NFILT}: max abs err {err80:.3g} (rtol 1e-4, atol "
                  f"1e-3), {int(((feat80 - ref80).abs() > 1e-5).sum())} of "
                  f"{feat80.numel()} elements more than 1e-5 off "
                  f"{'ok' if ok80 else 'FAIL'}")
            require(ok80, "log_mel disagrees with its twin at nfilt 80")
        valid = valid_frames(lens_d)
        norm, err_c = cmvn_case(f"[8, {out_frames}, 200], tone features",
                                feat, valid, empty)
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
            # the function's work (bounds.log_mel_work), with the sparse
            # mel bank the kernel reads. No one PyTorch call computes
            # either function.
            _, spans, weights = kfbank._fft_tables(FbankConfig(), dev)
            set_bound(results["log_mel"], *log_mel_work(
                sig_d, lens_d, spans, weights, feat))
            set_bound(results["cmvn"], *cmvn_work(feat, valid, norm))
            results["log_mel"]["library_ms"] = None
            results["cmvn"]["library_ms"] = None
    # a generator of their own: the later checks keep their draws
    check_cmvn_cases(np.random.default_rng(SEED + 2), empty)


def cmvn_case(label, feat, valid, empty):
    """``cmvn`` on the card against its twin within atol 1e-5 (its sums
    run in another order: per block and per cluster), equal bit for bit to
    ``cmvn_blocked_np``, the numpy mirror of that order (which the CPU tests
    hold to JAX's ``pallas_cmvn``), launched twice with the same bits, rows
    at and past ``valid`` exactly 0, and, where ``valid`` <= T, the columns
    of ``empty`` too. Returns (output, max abs error)."""
    import torch
    from asr_dfcnn_transformer_torch.kernels import (_build, cmvn,
                                                     cmvn_reference)
    from asr_dfcnn_transformer_torch.kernels import fbank as kfbank
    b, t, f = feat.shape
    lib = _build.library()
    cluster = int(lib.asr_cmvn_plan(b, t, f, 0))
    active = int(lib.asr_cmvn_plan(b, t, f, 6))
    plan = {k: int(lib.asr_cmvn_plan(b, t, f, i))
            for i, k in enumerate(("rows", "chunk", "groups", "stream",
                                   "smem"), start=1)}
    require(plan == kfbank.cmvn_plan(t, f, cluster),
            f"cmvn {label}: the launcher's plan {plan} (cluster {cluster}) "
            f"is not kernels/fbank.py's {kfbank.cmvn_plan(t, f, cluster)}")
    norm = cmvn(feat, valid)
    again = cmvn(feat, valid)
    torch.cuda.synchronize()
    norm_ref = cmvn_reference(feat, valid)
    ok, err = close_enough(norm, norm_ref, 0.0, 1e-5)
    same = torch.equal(norm, again)
    rows = torch.arange(t, device=feat.device)[None, :]
    pad_zero = bool((norm[rows >= valid[:, None].long()] == 0).all())
    cols = norm[(valid <= t).nonzero()[:, 0]][:, :, empty.to(feat.device)]
    zero = bool((cols == 0).all()) if empty.numel() else True
    mirror = kfbank.cmvn_blocked_np(feat.cpu().numpy(), valid.cpu().numpy(),
                                    cluster)
    off = int((norm.cpu() != torch.from_numpy(mirror)).sum())
    print(f"cmvn {label} {list(feat.shape)}: cluster {cluster} ({active} "
          f"at once), {plan['rows']} rows a block, "
          f"{'streams' if plan['stream'] else 'in shared memory'} "
          f"({plan['smem']} bytes); max abs err {err:.3g} (atol 1e-5), "
          f"bit-identical twice: {same}, padding rows 0: {pad_zero}, "
          f"empty-filter columns 0: {zero}; {off} of {norm.numel()} "
          f"elements differ from the numpy mirror "
          f"{'ok' if ok and same and pad_zero and zero and not off
             else 'FAIL'}")
    require(ok and same and pad_zero and zero,
            f"cmvn {label} disagrees with its twin")
    require(off == 0, f"cmvn {label}: {off} elements differ from "
            f"cmvn_blocked_np, the mirror of its order of sums")
    return norm, err


CMVN_CASES = (   # label, (B, T, F): the main paths' shapes and the edges
    ("AM training batch", (16, 1600, 200)),
    ("e2e front end", (8, 1600, 80)),
    ("bucket 400", (8, 400, 200)),
    ("batch 1", (1, 1600, 200)),
    ("streamed", (2, 6400, 200)),
    ("ragged F", (3, 37, 1030)),
)


def check_cmvn_cases(rng, empty):
    """``cmvn`` at the other main-path shapes and at the edges (an
    utterance that streams, bins past one pass), each on seeded features
    with a constant column where F is 200 (an empty mel filter's log eps)
    and ragged ``valid`` that includes 0 and a count above T."""
    import torch
    from asr_dfcnn_transformer_torch.check_inputs import cmvn_inputs
    dev = torch.device(DEVICE)
    for label, (b, t, f) in CMVN_CASES:
        cols = empty if f == 200 else torch.zeros(0, dtype=torch.long)
        feat, valid = (torch.from_numpy(a).to(dev) for a in cmvn_inputs(
            rng, b, t, f, const_cols=cols.numpy()))
        cmvn_case(label, feat, valid, cols)


def check_ctc_kernels(results, rng):
    import torch
    from asr_dfcnn_transformer_torch.bounds import (ctc_alpha_work,
                                                    ctc_beta_xi_work)
    from asr_dfcnn_transformer_torch.check_inputs import (ctc_dp_inputs,
                                                          ctc_loss_device_us,
                                                          ctc_problem)
    from asr_dfcnn_transformer_torch.kernels import (alpha_stack_reference,
                                                     beta_xi_reference,
                                                     ctc_alpha, ctc_beta_xi)
    from asr_dfcnn_transformer_torch.ops import ctc as ctc_ops
    from asr_dfcnn_transformer_torch.timing import device_us, us_text
    dev = torch.device(DEVICE)
    logits, logit_len, labels, label_len = ctc_problem(rng)
    d = ctc_dp_inputs(logits, logit_len, labels, label_len, dev)
    emit, init, valid, can_skip, lens = (
        d[k] for k in ("emit", "init", "valid", "can_skip", "lens"))
    alphas = alpha_case("main", (emit, init, can_skip, valid, lens),
                        repeats=20)
    err_a = float((alphas - d["alphas"]).abs().max())
    xi_args = d["xi_args"]
    err_x = beta_xi_case("main", xi_args)
    xi = ctc_beta_xi(*xi_args)
    dead = bool((xi[:, 2] == 0).all())
    print(f"ctc_beta_xi: unsatisfiable row all zero: {dead}")
    require(dead, "ctc_beta_xi: the unsatisfiable row is not 0")
    # generators of their own: the later checks keep their draws
    check_beta_xi_edges(np.random.default_rng(SEED + 1))
    check_alpha_edges(np.random.default_rng(SEED + 2))
    results["ctc_alpha"]["max_abs_err"] = err_a
    results["ctc_beta_xi"]["max_abs_err"] = err_x
    results["ctc_alpha"].update(zip(("ms", "plain_ms"), paired_ms(
        lambda: ctc_alpha(emit, init, can_skip, valid, lens),
        lambda: alpha_stack_reference(emit, init, can_skip, valid, lens))))
    results["ctc_beta_xi"].update(zip(("ms", "plain_ms"), paired_ms(
        lambda: ctc_beta_xi(*xi_args), lambda: beta_xi_reference(*xi_args))))
    # a chain of T dependent steps; what this run's lengths and labels
    # need (bounds.ctc_alpha_work, bounds.ctc_beta_xi_work)
    set_bound(results["ctc_alpha"],
              *ctc_alpha_work(emit, init, can_skip, valid, lens, alphas))
    set_bound(results["ctc_beta_xi"], *ctc_beta_xi_work(*xi_args, xi))
    print(f"ctc DPs: a chain of {emit.shape[0]} dependent steps each")
    # the library yardstick in device time (the profiler's, as the
    # kernels' own device us): F.ctc_loss's forward, and its backward (the
    # forward + backward less the forward)
    fwd, bwd = ctc_loss_device_us(d, labels)
    results["ctc_alpha"]["library_ms"] = fwd / 1e3
    results["ctc_beta_xi"]["library_ms"] = bwd / 1e3
    alpha_us = device_us(lambda: ctc_alpha(emit, init, can_skip, valid, lens),
                         "ctc_alpha_kernel")
    beta_us = device_us(lambda: ctc_beta_xi(*xi_args), "ctc_beta_xi_kernel")
    print(f"F.ctc_loss device us: forward {fwd:.1f}, backward "
          f"{bwd:.1f}; ctc_alpha {us_text(alpha_us)}, ctc_beta_xi "
          f"{us_text(beta_us)}")

    # the loss and its gradient on the card against the CPU's twins
    loss_grad = {}
    g = torch.from_numpy(rng.uniform(0.5, 1.5, len(logit_len))
                         .astype(np.float32))
    for where in ("cpu", DEVICE):
        x = torch.from_numpy(logits).to(where).requires_grad_(True)
        loss = ctc_ops.ctc_loss(x, torch.from_numpy(logit_len).to(where),
                                torch.from_numpy(labels).to(where),
                                torch.from_numpy(label_len).to(where))
        (grad,) = torch.autograd.grad(loss, x, g.to(where))
        loss_grad[where] = (loss.detach().cpu(), grad.cpu())
    (lc, gc), (lg, gg) = loss_grad["cpu"], loss_grad[DEVICE]
    ok_l, err_l = close_enough(lg, lc, 1e-5, 0.0)
    # The card's expf/logf and the CPU's differ in the last bit, and one
    # ulp of a log-probability of ~-1800 (200 random frames) is ~1.2e-4, so
    # the posteriors exp(alpha + beta - log P) carry that much relative
    # error on either device: the gradient's atol is 8 ulps of the largest
    # finite loss, not the twins' 1e-5 (on the card the kernels and their
    # twins agree exactly, above).
    big = float(lc[lc < 1e29].abs().max())
    atol = 8 * float(np.spacing(np.float32(big)))
    ok_g, err_g = close_enough(gg, gc, 1e-4, atol)
    finite = bool(torch.isfinite(gg).all())
    print(f"ctc_loss card vs CPU: loss max abs err {err_l:.3g} (rtol 1e-5) "
          f"grad max abs err {err_g:.3g} (rtol 1e-4, atol {atol:.3g} = 8 "
          f"ulps of the largest loss {big:.1f}) finite {finite} "
          f"{'ok' if ok_l and ok_g else 'FAIL'}")
    require(ok_l and ok_g and finite, "ctc_loss on the card disagrees with "
            "the CPU")


def alpha_case(label, args, repeats: int = 1):
    """``ctc_alpha`` on the card equal to its twin bit for bit and launched
    ``repeats`` more times with the same bits. Returns the alphas."""
    import torch
    from asr_dfcnn_transformer_torch.kernels import (alpha_stack_reference,
                                                     ctc_alpha)
    t, b, s = args[0].shape
    alphas = ctc_alpha(*args)
    same = all(torch.equal(ctc_alpha(*args), alphas) for _ in range(repeats))
    torch.cuda.synchronize()
    equal = torch.equal(alphas, alpha_stack_reference(*args))
    print(f"ctc_alpha {label} [{t}, {b}, {s}] lens "
          f"{args[4].min().item()}..{args[4].max().item()}: equal to the "
          f"twin {equal}, {repeats} more launches the same bits {same} "
          f"{'ok' if equal and same else 'FAIL'}")
    require(equal and same, f"ctc_alpha {label} is not its twin's bits")
    return alphas


def check_alpha_edges(rng):
    """``ctc_alpha`` bit for bit at ``check_inputs.ALPHA_EDGES``: T 1 and 2,
    S 1 to 1024 on both sides of the warp multiples, B 1, 64 and 200,
    lengths of 0 and past T."""
    import torch
    from asr_dfcnn_transformer_torch.check_inputs import (ALPHA_EDGES,
                                                          alpha_inputs)
    for label, t, b, s in ALPHA_EDGES:
        alpha_case(label, tuple(torch.from_numpy(a).to(DEVICE)
                                for a in alpha_inputs(rng, t, b, s)))


def beta_xi_case(label, xi_args):
    """``ctc_beta_xi`` on the card equal to its twin bit for bit, launched
    twice with the same bits, its launch held to ``beta_xi_plan``. Returns
    the max abs error (0)."""
    import torch
    from asr_dfcnn_transformer_torch.kernels import (_build,
                                                     beta_xi_reference,
                                                     ctc_beta_xi)
    from asr_dfcnn_transformer_torch.kernels import ctc as kctc
    t, b, s = xi_args[0].shape
    lib = _build.library()
    plan = {k: int(lib.asr_ctc_beta_xi_plan(s, i))
            for i, k in enumerate(("ring", "states", "threads", "smem"))}
    require(plan == kctc.beta_xi_plan(s), f"ctc_beta_xi {label}: the "
            f"launcher's plan {plan} is not kernels/ctc.py's "
            f"{kctc.beta_xi_plan(s)}")
    xi = ctc_beta_xi(*xi_args)
    again = ctc_beta_xi(*xi_args)
    torch.cuda.synchronize()
    want = beta_xi_reference(*xi_args)
    equal = torch.equal(xi, want) and torch.equal(xi, again)
    err = float((xi - want).abs().max())
    print(f"ctc_beta_xi {label} [{t}, {b}, {s}]: {plan['states']} state(s) a "
          f"chain thread, {plan['threads']} threads, {plan['smem']} bytes; "
          f"equal to the twin and to a second launch: {equal} (max abs err "
          f"{err:.3g}) {'ok' if equal else 'FAIL'}")
    require(equal, f"ctc_beta_xi {label} is not its twin's bits")
    return err


BETA_XI_EDGES = (   # (T, B, lmax): T 1, T below the ring's 8 slots, T mod 8
    # of 1 and 7, S above the 512 states of one a chain thread, S at 1023
    (1, 3, 2), (5, 2, 4), (17, 3, 16), (31, 2, 40), (40, 2, 300),
    (24, 2, 511))


def check_beta_xi_edges(rng):
    """``ctc_beta_xi`` bit for bit at the ring's edges (``BETA_XI_EDGES``),
    on ``ctc_problem``'s kind of inputs at a small vocabulary."""
    import torch
    from asr_dfcnn_transformer_torch.check_inputs import ctc_dp_inputs
    for t, b, lmax in BETA_XI_EDGES:
        v = 64
        logits = (2.0 * rng.standard_normal((b, t, v))).astype(np.float32)
        logit_len = rng.integers(1, t + 1, size=b).astype(np.int32)
        logit_len[0] = t
        label_len = rng.integers(0, lmax + 1, size=b).astype(np.int32)
        label_len[0] = lmax
        labels = rng.integers(0, v - 1, size=(b, lmax)).astype(np.int32)
        beta_xi_case("edge", ctc_dp_inputs(
            logits, logit_len, labels, label_len,
            torch.device(DEVICE))["xi_args"])


FWD_CASES = (   # label, (B, H, Tq, Tk, Dh), causal, keep probability
    # the forward's main-path shapes: the LM served (batch 8 and 16, and a
    # tiny one) and trained, the e2e pre-net's time rows (B 8 x F' 80 rows
    # of T' 134), its encoder served and trained, its teacher-forced
    # decoder's causal self-attention and cross-attention
    ("LM serving", (MAX_BATCH, 8, 100, 100, 64), True, 1.0),
    ("LM serving b16", (16, 8, 100, 100, 64), True, 1.0),
    ("LM tiny", (2, 2, 7, 7, 32), True, 1.0),
    ("LM training", (LM_BATCH, 8, LM_LEN, LM_LEN, 64), True, 0.5),
    ("e2e pre-net time rows", (MAX_BATCH * 80, 1, 134, 134, 64), False, 1.0),
    ("e2e encoder", (MAX_BATCH, 8, 134, 134, 64), False, 1.0),
    ("e2e encoder training", (E2E_BATCH, 8, 134, 134, 64), False, 0.9),
    ("decoder causal", (E2E_BATCH, 8, 65, 65, 64), True, 0.9),
    ("decoder cross", (E2E_BATCH, 8, 65, 134, 64), False, 0.9),
    ("decoder cross eval", (E2E_BATCH, 8, 65, 134, 64), False, 1.0),
)
FWD_EDGES = (   # label, (B, H, Tq, Tk, Dh), causal, keep probability, path
    # the tensor-core forward at the edges of its tiles: one query and one
    # key with Dh 7 (element-wise loads), part-filled tiles at Dh 16, its
    # limit with a fully invalid row under the causal mask, Tq above Tk at
    # Dh 32 with an odd Tk (byte-wise keep loads), Tq below Tk causal, a
    # long query axis (any Tq)
    ("one row", (2, 3, 1, 1, 7), False, 1.0, "mma"),
    ("ragged tiles", (2, 3, 17, 33, 16), False, 1.0, "mma"),
    ("limit", (2, 3, 160, 160, 64), True, 1.0, "mma"),
    ("Tq > Tk", (2, 3, 134, 65, 32), False, 0.9, "mma"),
    ("Tq < Tk causal", (2, 3, 65, 134, 64), True, 1.0, "mma"),
    ("long queries", (2, 3, 1600, 64, 64), True, 0.9, "mma"),
    # bf16 shapes the launcher sends to the scalar kernel: keys past 160,
    # heads wider than 64
    ("long keys", (2, 3, 64, 161, 64), True, 0.9, "scalar"),
    ("wide heads", (2, 3, 64, 64, 128), False, 1.0, "scalar"),
)


def attention_problem(rng, b, h, tq, tk, dh, keep_p):
    """Seeded q [b, h, tq, dh], k / v [b, h, tk, dh] in f32 on the card,
    ragged key validity with one fully invalid row, and a keep mask at
    ``keep_p`` (None at 1.0)."""
    import torch
    dev = torch.device(DEVICE)
    q = torch.from_numpy(rng.standard_normal((b, h, tq, dh)).astype(
        np.float32)).to(dev)
    k, v = (torch.from_numpy(rng.standard_normal((b, h, tk, dh)).astype(
        np.float32)).to(dev) for _ in range(2))
    k_valid = torch.from_numpy(rng.uniform(size=(b, tk)) > 0.3).to(dev)
    k_valid[:, 0] = True
    k_valid[0] = False                           # one fully invalid row
    keep = (None if keep_p == 1.0 else torch.from_numpy(
        rng.uniform(size=(b, h, tq, tk)) < keep_p).to(dev))
    return q, k, v, k_valid, keep


def fwd_case(label, q, k, v, k_valid, causal, keep, kp, path_bf16="mma"):
    """The masked attention forward at one shape: against its twin (bf16
    within 2e-2, f32 within 1e-5), with its count of differing elements,
    launched twice and required bit-identical, with the path it took
    (``fwd_path``, held to the C query ``asr_masked_attention_path``, and
    on the tensor-core path its shared memory held to
    ``asr_masked_attention_mma_smem``). The path must be ``path_bf16`` in
    bf16 ("mma" at every main-path shape) and "scalar" in f32. Returns
    (the output, the largest error)."""
    import torch
    from asr_dfcnn_transformer_torch.kernels import _build
    from asr_dfcnn_transformer_torch.kernels import attention as attn
    lib = _build.library()
    b, h, tq, dh = q.shape
    tk = k.shape[2]
    code = _build.DTYPE_CODES[q.dtype]
    path = attn.fwd_path(tq, tk, dh, q.dtype)
    native = lib.asr_masked_attention_path(code, tq, tk, dh)
    require((native == 1) == (path == "mma"),
            f"masked_attention path at {label}: Python {path}, C {native}")
    smem = ""
    if path == "mma":
        mirror = attn.mma_fwd_smem_bytes(tk, dh)
        c_smem = lib.asr_masked_attention_mma_smem(tk, dh)
        require(mirror == c_smem, f"masked_attention shared memory at "
                f"{label}: Python {mirror}, C {c_smem}")
        smem = f", {c_smem} bytes of shared memory"
    want_path = path_bf16 if q.dtype == torch.bfloat16 else "scalar"
    require(path == want_path, f"masked_attention at {label} {q.dtype} took "
            f"the {path} path, not the {want_path} one")
    got = attn._forward(q, k, v, k_valid, causal, keep, kp)
    again = attn._forward(q, k, v, k_valid, causal, keep, kp)
    twin = attn.masked_attention_reference(q, k, v, k_valid, causal, keep,
                                           kp)
    tol = 2e-2 if q.dtype == torch.bfloat16 else 1e-5
    ok, err = close_enough(got, twin, tol, tol)
    ok &= bool(torch.isfinite(got.float()).all())
    same = torch.equal(got, again)
    differ = int((got != twin).sum())
    print(f"masked_attention {label} [{b}, {h}, {tq}/{tk}, {dh}] {q.dtype} "
          f"causal {causal} keep {kp}: path {path}{smem}, max abs err "
          f"{err:.3g} (tol {tol}), {differ} of {got.numel()} elements "
          f"differ from the twin, bit-identical twice {same} "
          f"{'ok' if ok and same else 'FAIL'}")
    require(ok, f"masked_attention disagrees with its twin at {label}")
    require(same, f"masked_attention at {label} differs between launches")
    return got, err


def check_attention_fwd(results, rng):
    """The masked attention forward, with and without a keep mask
    (``fwd_case``): every main-path shape of ``FWD_CASES`` in f32 (the
    scalar kernel) and bf16 (the tensor-core kernel), then the bf16 edges
    of ``FWD_EDGES``, each on the path named; then the bf16 LM serving
    forward timed beside its twin, its bound and
    ``scaled_dot_product_attention`` with the bool mask, and the bf16 LM
    training dropout forward beside its twin and its bound."""
    import torch
    import torch.nn.functional as F
    from asr_dfcnn_transformer_torch.bounds import masked_attention_work
    from asr_dfcnn_transformer_torch.kernels import attention as attn
    from asr_dfcnn_transformer_torch.timing import cuda_ms
    timed = {"LM serving": "masked_attention",
             "LM training": "masked_attention_drop"}
    for label, (b, h, tq, tk, dh), causal, kp in FWD_CASES:
        q, k, v, k_valid, keep = attention_problem(rng, b, h, tq, tk, dh, kp)
        for dtype in (torch.float32, torch.bfloat16):
            qd, kd, vd = (x.to(dtype) for x in (q, k, v))
            got, err = fwd_case(label, qd, kd, vd, k_valid, causal, keep, kp)
            if dtype != torch.bfloat16 or label not in timed:
                continue
            r = results[timed[label]]
            r["max_abs_err"] = err
            r.update(zip(("ms", "plain_ms"), paired_ms(
                lambda: attn._forward(qd, kd, vd, k_valid, causal, keep,
                                      kp),
                lambda: attn.masked_attention_reference(
                    qd, kd, vd, k_valid, causal, keep, kp))))
            # QK^T and PV over the causal triangle
            set_bound(r, *masked_attention_work(qd, kd, vd, k_valid, keep,
                                                got, causal))
            r["library_ms"] = None           # no PyTorch call takes a keep
            if keep is None:
                mask = (torch.ones(tq, tk, dtype=torch.bool, device=q.device)
                        .tril()[None, None] & k_valid[:, None, None, :])
                r["library_ms"] = cuda_ms(
                    lambda: F.scaled_dot_product_attention(
                        qd, kd, vd, attn_mask=mask))
    for label, (b, h, tq, tk, dh), causal, kp, path in FWD_EDGES:
        q, k, v, k_valid, keep = attention_problem(rng, b, h, tq, tk, dh, kp)
        fwd_case(label, *(x.to(torch.bfloat16) for x in (q, k, v)), k_valid,
                 causal, keep, kp, path)


LONG_CASES = (   # label, (B, H, T, Dh), dtype, keep probability
    # key lengths the scalar forward refused for shared memory before it
    # walked the keys in chunks (Tk above 435 in f32 at Dh 64, above 220
    # at Dh 128): causal, ragged keys, key 0 invalid, so that query row 0
    # has no valid key at all; up to Tk 512 the block's scores are kept
    # in shared memory (the first case), above it recomputed in each walk
    ("f32 Dh 128", (1, 4, 256, 128), "float32", 1.0),
    ("f32 Tk 600", (1, 8, 600, 64), "float32", 0.9),
    ("bf16 Tk 1000", (1, 8, 1000, 64), "bfloat16", 1.0),
)


def check_attention_long(rng):
    """The masked attention forward and backward at long key lengths
    (``LONG_CASES``) against their twins, with ``fwd_case`` and
    ``bwd_case``' tolerances (bf16 2e-2, f32 1e-5), on the scalar forward
    and the chunked backward; and the Python mirror of the scalar
    forward's shared memory (``fwd_smem_bytes``) against the C query at
    each of these shapes, within the card's limit."""
    import torch
    from asr_dfcnn_transformer_torch.kernels import _build
    from asr_dfcnn_transformer_torch.kernels import attention as attn
    dev = torch.device(DEVICE)
    lib = _build.library()
    for label, (b, h, t, dh), dtype, kp in LONG_CASES:
        dtype = getattr(torch, dtype)
        mirror = attn.fwd_smem_bytes(dh, dtype, t)
        native = lib.asr_masked_attention_smem(_build.DTYPE_CODES[dtype], dh,
                                               t)
        require(mirror == native and native <= attn.MAX_SMEM,
                f"masked_attention shared memory at {label}: Python "
                f"{mirror}, C {native}")
        q, k, v, dout = (torch.from_numpy(rng.standard_normal(
            (b, h, t, dh)).astype(np.float32)).to(dev, dtype)
            for _ in range(4))
        k_valid = torch.from_numpy(rng.uniform(size=(b, t)) > 0.2).to(dev)
        k_valid[:, 0] = False                    # row 0: no valid key
        keep = (None if kp == 1.0 else torch.from_numpy(
            rng.uniform(size=(b, h, t, t)) < kp).to(dev))
        print(f"masked_attention {label}: {native} bytes of shared memory "
              "(the mirror's)")
        fwd_case(label, q, k, v, k_valid, True, keep, kp, "scalar")
        bwd_case(label, q, k, v, k_valid, dout, True, keep, kp, "chunked")


def bwd_case(label, q, k, v, k_valid, dout, causal, keep, kp,
             path_bf16="mma"):
    """The masked attention backward at one shape: against its twin (bf16
    within 2e-2, f32 within 1e-5, as phase 2 holds it everywhere), launched
    twice and required bit-identical, with the path it took (``bwd_path``,
    held to the C query ``asr_masked_attention_bwd_path``, and on the
    tensor-core path its shared memory held to
    ``asr_masked_attention_bwd_mma_smem``). The path must be
    ``path_bf16`` in bf16 ("mma" at every main-path shape) and "chunked"
    in f32. Returns (the gradients, the largest error)."""
    import torch
    from asr_dfcnn_transformer_torch.kernels import _build
    from asr_dfcnn_transformer_torch.kernels import attention as attn
    lib = _build.library()
    b, h, tq, dh = q.shape
    tk = k.shape[2]
    code = _build.DTYPE_CODES[q.dtype]
    path = attn.bwd_path(tq, tk, dh, q.dtype)
    native = lib.asr_masked_attention_bwd_path(code, tq, tk, dh)
    require((native == 1) == (path == "mma"),
            f"masked_attention_bwd path at {label}: Python {path}, C {native}")
    if path == "mma":
        mirror = attn.mma_bwd_smem_bytes(tq, tk, dh)
        c_smem = lib.asr_masked_attention_bwd_mma_smem(tq, tk, dh)
        require(mirror == c_smem, f"masked_attention_bwd shared memory at "
                f"{label}: Python {mirror}, C {c_smem}")
    want = path_bf16 if q.dtype == torch.bfloat16 else "chunked"
    require(path == want, f"masked_attention_bwd at {label} {q.dtype} took "
            f"the {path} path, not the {want} one")
    got = attn._backward(q, k, v, k_valid, dout, causal, keep, kp)
    again = attn._backward(q, k, v, k_valid, dout, causal, keep, kp)
    twin = attn.masked_attention_bwd_reference(q, k, v, k_valid, dout, causal,
                                               keep, kp)
    tol = 2e-2 if q.dtype == torch.bfloat16 else 1e-5
    errs, ok, worst = [], True, 0.0
    for name, x, y in zip(("dq", "dk", "dv"), got, twin):
        good, err = close_enough(x, y, tol, tol)
        ok &= good and bool(torch.isfinite(x.float()).all())
        worst = max(worst, err)
        errs.append(f"{name} {err:.3g}")
    same = all(torch.equal(x, y) for x, y in zip(got, again))
    print(f"masked_attention_bwd {label} [{b}, {h}, {tq}/{tk}, {dh}] "
          f"{q.dtype} causal {causal} keep {kp}: path {path}, max abs err "
          f"{', '.join(errs)} (tol {tol}), bit-identical twice {same} "
          f"{'ok' if ok and same else 'FAIL'}")
    require(ok, f"masked_attention_bwd disagrees with its twin at {label}")
    require(same, f"masked_attention_bwd at {label} differs between launches")
    return got, worst


def check_attention_training_kernels(results, rng):
    """The backward kernel against its twin at the LM's training shape [64,
    8, 64, 64]: causal, ragged keys with one fully invalid row, keep mask
    off and at 0.5 (at keep 1.0 beside the library yardstick); then the
    bf16 backward at e2e training's encoder [8, 8, 134, 64] (keep 0.9) and
    pre-net time rows [640, 1, 134, 64] (no keep mask). Every bf16 backward
    here takes the tensor-core path and gives the same output twice
    (``bwd_case``). The dropout forward is ``check_attention_fwd``'s."""
    import torch
    from asr_dfcnn_transformer_torch.bounds import masked_attention_bwd_work
    from asr_dfcnn_transformer_torch.kernels import attention as attn
    dev = torch.device(DEVICE)
    b, h, t, dh = LM_BATCH, 8, LM_LEN, 64
    q, k, v, dout = (torch.from_numpy(rng.standard_normal(
        (b, h, t, dh)).astype(np.float32)).to(dev) for _ in range(4))
    k_valid = torch.from_numpy(rng.uniform(size=(b, t)) > 0.3).to(dev)
    k_valid[:, 0] = True
    k_valid[0] = False                           # one fully invalid row
    keep = torch.from_numpy(rng.uniform(size=(b, h, t, t)) < 0.5).to(dev)
    for dtype in (torch.float32, torch.bfloat16):
        qd, kd, vd, dd = (x.to(dtype) for x in (q, k, v, dout))
        for mask in (None, keep):
            kp = 1.0 if mask is None else 0.5
            got, err_b = bwd_case("LM", qd, kd, vd, k_valid, dd, True, mask,
                                  kp)
            if dtype == torch.bfloat16 and mask is None:
                bwd_library_keep1(qd, kd, vd, k_valid, dd)
            if dtype != torch.bfloat16 or mask is None:
                continue
            results["masked_attention_bwd"]["max_abs_err"] = err_b
            results["masked_attention_bwd"].update(zip(
                ("ms", "plain_ms"), paired_ms(
                    lambda: attn._backward(qd, kd, vd, k_valid, dd, True,
                                           mask, kp),
                    lambda: attn.masked_attention_bwd_reference(
                        qd, kd, vd, k_valid, dd, True, mask, kp))))
            # over the causal triangle: S again, dV, dP, dQ and dK. No
            # PyTorch call takes a keep mask (the keep 1.0 yardstick is
            # printed above).
            set_bound(results["masked_attention_bwd"],
                      *masked_attention_bwd_work(qd, kd, vd, k_valid, dd,
                                                 mask, got, True))
            results["masked_attention_bwd"]["library_ms"] = None
    # the e2e training shapes: the encoder's self-attention (key-masked,
    # keep 0.9) and the pre-net's time rows (no dropout)
    for b, h, keep_p in ((E2E_BATCH, 8, 0.9), (E2E_BATCH * 80, 1, 1.0)):
        t = 134
        q, k, v, dout = (torch.from_numpy(rng.standard_normal(
            (b, h, t, dh)).astype(np.float32)).to(dev, torch.bfloat16)
            for _ in range(4))
        k_valid = torch.arange(t, device=dev)[None, :] < torch.from_numpy(
            rng.integers(t // 3, t + 1, size=b)).to(dev)[:, None]
        k_valid[0] = False                       # one fully invalid row
        keep = (None if keep_p == 1.0 else torch.from_numpy(
            rng.uniform(size=(b, h, t, t)) < keep_p).to(dev))
        bwd_case("e2e encoder" if h == 8 else "e2e pre-net time rows", q, k,
                 v, k_valid, dout, False, keep, keep_p)


def bwd_library_keep1(q, k, v, k_valid, dout):
    """The masked backward's library yardstick: at keep 1.0 the backward of
    ``scaled_dot_product_attention`` with a float additive mask (the -1e9 of
    ``_scores`` for invalid and future keys, in the inputs' type) computes
    the same function, fully invalid rows included. Its backward
    (``autograd.grad`` per call) by CUDA events and by the device time of
    all its kernels, beside the kernel's, at the LM's shape."""
    import torch
    import torch.nn.functional as F
    from asr_dfcnn_transformer_torch.kernels import attention as attn
    from asr_dfcnn_transformer_torch.timing import (additive_mask, cuda_ms,
                                                     device_us, us_text)
    mask = additive_mask(k_valid, q.shape[2], k.shape[2], True, q.dtype)
    q4, k4, v4 = (x.detach().requires_grad_(True) for x in (q, k, v))
    out = F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask)

    def sdpa_bwd():
        torch.autograd.grad(out, (q4, k4, v4), dout, retain_graph=True)

    def kernel():
        attn._backward(q, k, v, k_valid, dout, True, None, 1.0)

    k_ms, lib_ms = cuda_ms(kernel), cuda_ms(sdpa_bwd)
    k_us = device_us(kernel, "masked_attention_bwd")
    lib_us = device_us(sdpa_bwd, None)
    print(f"time masked_attention_bwd keep 1.0 {list(q.shape)} bf16: kernel "
          f"{k_ms:.4f} ms ({us_text(k_us)} of device time); library "
          f"(scaled_dot_product_attention backward, float mask) {lib_ms:.4f} "
          f"ms ({us_text(lib_us)} of device time)")


BWD_EDGES = (   # label, (B, H, Tq, Tk, Dh), causal, keep probability, path
    # bf16 shapes the launcher sends to the two chunked launches: rows
    # longer than 160, heads wider than 64
    ("long rows", (8, 8, 200, 200, 64), True, 0.9, "chunked"),
    ("wide heads", (8, 4, 64, 64, 128), False, 1.0, "chunked"),
    # the tensor-core kernel's edges: one query and one key with Dh 7
    # (element-wise staging), the 10-tile instance at its limit, Tq above
    # Tk (phase-2 warps leave early) at Dh 32, part-filled tiles at Dh 16
    ("one row", (2, 3, 1, 1, 7), True, 0.9, "mma"),
    ("limit", (2, 3, 160, 160, 64), True, 1.0, "mma"),
    ("Tq > Tk", (2, 3, 134, 65, 32), False, 0.9, "mma"),
    ("ragged tiles", (2, 3, 17, 33, 16), True, 1.0, "mma"),
)


def check_attention_bwd_edges(rng):
    """The bf16 masked attention backward off the main paths (``bwd_case``
    at each of ``BWD_EDGES``): the chunked launches at shapes the
    tensor-core kernel does not take, and that kernel at the edges of its
    tiles, each on the path named, within 2e-2 of its twin and the same
    output twice; ragged keys with one fully invalid row."""
    import torch
    dev = torch.device(DEVICE)
    for label, (b, h, tq, tk, dh), causal, kp, path in BWD_EDGES:
        q, dout = (torch.from_numpy(rng.standard_normal(
            (b, h, tq, dh)).astype(np.float32)).to(dev, torch.bfloat16)
            for _ in range(2))
        k, v = (torch.from_numpy(rng.standard_normal(
            (b, h, tk, dh)).astype(np.float32)).to(dev, torch.bfloat16)
            for _ in range(2))
        k_valid = torch.arange(tk, device=dev)[None, :] < torch.from_numpy(
            rng.integers(tk // 3, tk + 1, size=b)).to(dev)[:, None]
        k_valid[0] = False                       # one fully invalid row
        keep = (None if kp == 1.0 else torch.from_numpy(
            rng.uniform(size=(b, h, tq, tk)) < kp).to(dev))
        bwd_case(label, q, k, v, k_valid, dout, causal, keep, kp, path)


def check_beam_kernels(results, rng):
    """``topk_last`` and ``beam_search`` against their twins: at the beam
    path's shapes ([8, 200, 1536] log-probs with ragged lengths and a 0,
    W = K = 8, L 100), at batch 1, with W > K + 1 (live candidates run out,
    as in tests/test_pallas_beam.py, and a 1-frame row keeps dead beams),
    ``topk_last`` also on the path's rows in bf16 and on quantised,
    tie-heavy values. Ids, values, lengths and prefixes must be equal;
    pb / pnb within 1e-5."""
    import torch
    from asr_dfcnn_transformer_torch.bounds import (beam_search_work,
                                                    topk_last_work)
    from asr_dfcnn_transformer_torch.check_inputs import topk_cases
    from asr_dfcnn_transformer_torch.kernels import (beam_search,
                                                     beam_search_reference,
                                                     topk_last,
                                                     topk_last_reference)
    from asr_dfcnn_transformer_torch.timing import (device_us, library_us,
                                                     us_text)
    dev = torch.device(DEVICE)
    b, t, v, w = MAX_BATCH, 200, 1536, BEAM_WIDTH

    def topk_case(name, x, k):
        vals, ids = topk_last(x, k)
        want_v, want_i = topk_last_reference(x, k)
        same = torch.equal(ids, want_i) and torch.equal(vals, want_v)
        err = float((vals - want_v).abs().max())
        print(f"topk_last {name} {list(x.shape)} k {k}: ids and values "
              f"equal {same} (max abs err {err:.3g})")
        require(same, f"topk_last disagrees with its twin ({name})")
        return vals, ids, err

    def beam_case(name, lp, lens, w, k, lcap):
        top_lp, top_ids, _ = topk_case(f"for {name}", lp, k)
        kw = dict(beam_width=w, topk=k, blank=lp.shape[-1] - 1,
                  max_decode_len=lcap)
        args = (lp, top_lp, top_ids, lens)
        got = beam_search(*args, **kw)
        want = beam_search_reference(*args, **kw)
        same = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        ok_b, err_b = close_enough(got[2], want[2], 0.0, 1e-5)
        ok_n, err_n = close_enough(got[3], want[3], 0.0, 1e-5)
        err = max(err_b, err_n)
        print(f"beam_search {name} {list(lp.shape)} W {w} K {k} L {lcap} "
              f"lens {lens.tolist()}: prefixes and lengths equal {same}, "
              f"pb / pnb max abs err {err:.3g} (atol 1e-5), longest prefix "
              f"{int(got[1].max())} "
              f"{'ok' if same and ok_b and ok_n else 'FAIL'}")
        require(same and ok_b and ok_n,
                f"beam_search disagrees with its twin ({name})")
        return args, kw, got, err

    def log_probs(shape):
        x = torch.from_numpy((2.0 * rng.standard_normal(shape))
                             .astype(np.float32)).to(dev)
        return torch.log_softmax(x, -1)

    lens = torch.tensor([200, 0, 150, 50, 100, 173, 200, 1],
                        dtype=torch.int32, device=dev)
    args, kw, got, err = beam_case("path", log_probs((b, t, v)), lens, w, w,
                                   LM_MAX_LEN)
    beam_case("batch 1", log_probs((1, t, v)),
              torch.tensor([t], dtype=torch.int32, device=dev), w, w,
              LM_MAX_LEN)
    # the 1-frame row keeps dead beams to the end: their order among equal
    # totals (ties to the lower candidate index) reaches the output
    beam_case("W > K + 1", log_probs((3, 10, 12)),
              torch.tensor([10, 7, 1], dtype=torch.int32, device=dev), 6, 2,
              6)
    x2d = args[0].view(-1, v)
    _, _, err_t = topk_case("path", x2d, w)
    topk_case("bf16", x2d.to(torch.bfloat16), w)
    ties = torch.round(torch.from_numpy(rng.standard_normal((b * t, v))
                                        .astype(np.float32)).to(dev) * 2) / 2
    topk_case("quantised ties", ties, w)
    # the edges (a generator of their own: the later checks keep their
    # draws)
    for name, x, k in topk_cases(np.random.default_rng(SEED + 3), dev):
        topk_case(name, x, k)

    r = results["topk_last"]
    r["max_abs_err"] = err_t
    r.update(zip(("ms", "plain_ms"), paired_ms(
        lambda: topk_last(x2d, w), lambda: topk_last_reference(x2d, w))))
    # each row read once, k picks of V compares each
    set_bound(r, *topk_last_work(x2d, w))
    # torch.topk's device time (all its kernels), as the kernel's
    lib_us, how = library_us(lambda: torch.topk(x2d, w, dim=-1))
    r["library_ms"] = lib_us / 1e3
    k_us = device_us(lambda: topk_last(x2d, w), "topk_last_kernel")
    print(f"torch.topk {lib_us:.2f} us ({how}); topk_last {us_text(k_us)} "
          "of device time")

    r = results["beam_search"]
    r["max_abs_err"] = err
    # the twin is some 10^4 small launches a call: fewer iterations
    r.update(zip(("ms", "plain_ms"), paired_ms(
        lambda: beam_search(*args, **kw),
        lambda: beam_search_reference(*args, **kw), plain_iters=2)))
    # what this run's data needs (bounds.beam_search_work): its valid
    # frames. Nominal: the frames are a chain of dependent steps.
    frames = int(lens.clamp(max=t).sum())
    set_bound(r, *beam_search_work(frames, w, w, lens, got))
    r["library_ms"] = None          # no PyTorch call does a beam search
    print(f"beam_search: a chain of up to {t} dependent frames "
          f"({frames} valid frames in all)")


def bf16_ulp(x):
    """The spacing of bfloat16 numbers at each |x| (8 significant bits;
    the smallest subnormal's at 0)."""
    import torch
    _, e = torch.frexp(x.float())
    ulp = torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)
    return torch.where(x == 0, 2.0 ** -133, ulp)


def check_dual_attention(results, rng):
    """``dual_axis_attention`` against its twin: f32 within 1e-5 on
    unit-normal inputs; bf16 each output within one bf16 ulp of the twin's
    (the count of elements that differ at all is printed)."""
    import torch
    import torch.nn.functional as F
    from asr_dfcnn_transformer_torch.kernels import (
        dual_axis_attention, dual_axis_attention_reference)
    from asr_dfcnn_transformer_torch.timing import cuda_ms
    dev = torch.device(DEVICE)
    freq_rows = (MAX_BATCH * 134, 80, 64)     # B 8 x T' 134 rows of F' 80
    cases = ((freq_rows, torch.bfloat16), (freq_rows, torch.float32),
             ((MAX_BATCH * 80, 134, 64), torch.bfloat16),
             ((13, 7, 32), torch.bfloat16), ((13, 7, 32), torch.float32))
    # the bf16 tensor-core kernels at the edges of their 16 x 16 tiles: the
    # largest T and C, T and C one past a tile (C not a multiple of 8: the
    # element-wise copy), exact tiles, and one key of one channel
    cases += tuple(((45, t, c), torch.bfloat16)
                   for t, c in ((160, 128), (33, 7), (17, 16), (1, 1)))
    for shape, dtype in cases:
        q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev, dtype) for _ in range(3))
        got = dual_axis_attention(q, k, v)
        want = dual_axis_attention_reference(q, k, v)
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        n_diff = int((got != want).sum())
        if dtype == torch.float32:
            ok, tol = err <= 1e-5, "atol 1e-5"
        else:
            ok, tol = bool((diff <= bf16_ulp(want)).all()), "one bf16 ulp"
        ok &= bool(torch.isfinite(got.float()).all())
        print(f"dual_axis_attention {list(shape)} {dtype}: max abs err "
              f"{err:.3g} ({tol}), {n_diff} of {got.numel()} elements "
              f"differ {'ok' if ok else 'FAIL'}")
        require(ok, "dual_axis_attention disagrees with its twin")
        if shape == freq_rows and dtype == torch.bfloat16:
            r = results["dual_axis_attention"]
            r["max_abs_err"] = err
            r.update(zip(("ms", "plain_ms"), paired_ms(
                lambda: dual_axis_attention(q, k, v),
                lambda: dual_axis_attention_reference(q, k, v))))
            rows, t, c = shape
            set_bound(r, nbytes(q, k, v, got), {"bf16": 4 * rows * t * t * c})
            r["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
                q[:, None], k[:, None], v[:, None]))
    check_dual_attention_bwd(results, rng, cases)


def check_dual_attention_bwd(results, rng, cases):
    """The backward kernel against its twin at the forward's cases: dq, dk,
    dv in f32 within rtol = atol = 1e-5; in bf16 within 2e-2 (dS and the
    outputs are rounded to bf16, and a different f32 sum order may round
    an element the other way), as the masked backward, and with at most
    one element in 10^3 differing at all: a bf16 rounding moved to another
    place (dsum over the rounded P, say) stays inside 2e-2 but changes a
    fifth of the elements. The Python mirror
    of the kernel's shared-memory layout must equal the C query, and the
    launcher must refuse the f32 time rows and every case whose layout
    needs more than the card has (bf16 [., 160, 128])."""
    import torch
    import torch.nn.functional as F
    from asr_dfcnn_transformer_torch.kernels import (
        dual_axis_attention_bwd_reference, _build, dual_attention)
    from asr_dfcnn_transformer_torch.timing import cuda_ms
    dev = torch.device(DEVICE)
    lib = _build.library()
    for t, c in ((80, 64), (134, 64), (7, 32), (160, 128), (1, 1), (33, 7)):
        for dtype, code in _build.DTYPE_CODES.items():
            mirror = dual_attention.bwd_smem_bytes(t, c, dtype)
            native = lib.asr_dual_attention_bwd_smem(code, t, c)
            require(mirror == native, f"dual_axis_attention_bwd shared memory "
                    f"at T={t}, C={c}, {dtype}: Python {mirror}, C {native}")
    refused = [(s, d) for s, d in cases
               if not dual_attention.supports(s[1], s[2], d, grad=True)]
    refused.append(((2, 134, 64), torch.float32))
    for shape, dtype in refused:
        x = torch.zeros(shape, device=dev, dtype=dtype)
        try:
            dual_attention._backward(x, x, x, x)
        except RuntimeError as e:
            print(f"dual_axis_attention_bwd {list(shape)} {dtype} "
                  f"refused: {e}")
        else:
            raise PhaseError(f"the {dtype} {list(shape)} backward was not "
                             "refused")
    tol = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
    for shape, dtype in cases:
        if (shape, dtype) in refused:
            continue
        q, k, v, g = (torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev, dtype) for _ in range(4))
        got = dual_attention._backward(q, k, v, g)
        want = dual_axis_attention_bwd_reference(q, k, v, g)
        errs, ok, err = [], True, 0.0
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            good, e = close_enough(a, b, tol[dtype], tol[dtype])
            n_diff = int((a != b).sum())
            ok &= good and bool(torch.isfinite(a.float()).all())
            if dtype == torch.bfloat16:
                ok &= n_diff <= a.numel() // 1000
            err = max(err, e)
            errs.append(f"{name} {e:.3g} ({n_diff} differ)")
        few = "; at most 1 in 1000 differ" if dtype == torch.bfloat16 else ""
        print(f"dual_axis_attention_bwd {list(shape)} {dtype}: max abs err "
              f"{', '.join(errs)} of {got[0].numel()} each (tol "
              f"{tol[dtype]}{few}) {'ok' if ok else 'FAIL'}")
        require(ok, "dual_axis_attention_bwd disagrees with its twin")
        if shape != cases[0][0] or dtype != torch.bfloat16:
            continue
        r = results["dual_axis_attention_bwd"]
        r["max_abs_err"] = err
        r.update(zip(("ms", "plain_ms"), paired_ms(
            lambda: dual_attention._backward(q, k, v, g),
            lambda: dual_axis_attention_bwd_reference(q, k, v, g))))
        rows, t, c = shape
        # S, dP, dQ, dK and dV: five [T, T, C] products of 2 operations
        set_bound(r, nbytes(q, k, v, g, *got),
                  {"bf16": 10 * rows * t * t * c})
        # the library yardstick: the backward of scaled_dot_product_attention
        # on the same rows, timed alone
        q4, k4, v4 = (x[:, None].detach().requires_grad_(True)
                      for x in (q, k, v))
        out = F.scaled_dot_product_attention(q4, k4, v4)
        g4 = g[:, None]
        r["library_ms"] = cuda_ms(lambda: torch.autograd.grad(
            out, (q4, k4, v4), g4, retain_graph=True))


def check_cross_attention(rng):
    """The masked attention backward at the teacher-forced decoder's
    cross-attention shape, q [8, 8, 65, 64] against key-masked k / v [8, 8,
    134, 64], keep 0.9, against its twin in bf16 and f32, with the
    decoder's causal self-attention backward [8, 8, 65, 64] (keep 0.9;
    ``bwd_case``: the tensor-core path in bf16, the same output twice),
    then the bf16 times of the forward, the dropout forward and the
    backward there (the forwards' checks are ``check_attention_fwd``'s)."""
    import torch
    from asr_dfcnn_transformer_torch.kernels import attention as attn
    dev = torch.device(DEVICE)
    b, h, tq, tk, dh = E2E_BATCH, 8, E2E_LABELS[1] + 1, 134, 64
    q, dout = (torch.from_numpy(rng.standard_normal((b, h, tq, dh)).astype(
        np.float32)).to(dev) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((b, h, tk, dh)).astype(
        np.float32)).to(dev) for _ in range(2))
    k_valid = torch.arange(tk, device=dev)[None, :] < torch.from_numpy(
        rng.integers(tk // 3, tk + 1, size=b)).to(dev)[:, None]
    keep = torch.from_numpy(rng.uniform(size=(b, h, tq, tk)) < 0.9).to(dev)
    for dtype in (torch.bfloat16, torch.float32):
        qd, kd, vd, dd = (x.to(dtype) for x in (q, k, v, dout))
        bwd_case("cross", qd, kd, vd, k_valid, dd, False, keep, 0.9)
        # the decoder's causal self-attention over its 65 label positions
        qs, ks, vs = (x[:, :, :tq] for x in (qd, kd, vd))
        dec_valid = k_valid[:, :tq].clone()
        dec_valid[0] = False                     # one fully invalid row
        bwd_case("decoder causal", qs.contiguous(), ks.contiguous(),
                 vs.contiguous(), dec_valid, dd, True,
                 keep[..., :tq].contiguous(), 0.9)
        if dtype != torch.bfloat16:
            continue
        times = [paired_ms(
            lambda: attn._forward(qd, kd, vd, k_valid, False, None, 1.0),
            lambda: attn.masked_attention_reference(qd, kd, vd, k_valid)),
            paired_ms(
            lambda: attn._forward(qd, kd, vd, k_valid, False, keep, 0.9),
            lambda: attn.masked_attention_reference(qd, kd, vd, k_valid,
                                                    False, keep, 0.9)),
            paired_ms(
            lambda: attn._backward(qd, kd, vd, k_valid, dd, False, keep, 0.9),
            lambda: attn.masked_attention_bwd_reference(
                qd, kd, vd, k_valid, dd, False, keep, 0.9))]
        print("time masked_attention cross bf16: " + "; ".join(
            f"{n} kernel {k:.4f} ms, plain {p:.4f} ms" for n, (k, p)
            in zip(("forward", "dropout forward", "backward"), times)))


def check_attention_bwd_f32(rng):
    """The masked attention backward in f32 at the shapes of e2e training
    at bucket 1600 (T' 134, Dh 64), which the earlier one-block-per-(b, h)
    kernel refused for shared memory: the encoder's [8, 8, 134, 64] with
    ragged keys and the pre-net's time rows [640, 1, 134, 64] (batch 8 x F'
    80), each against its twin within 1e-6; then the Python mirror of the
    backward's shared memory against the C query, and the f32 encoder
    shape's time beside its twin's."""
    import torch
    from asr_dfcnn_transformer_torch.kernels import _build
    from asr_dfcnn_transformer_torch.kernels import attention as attn
    dev = torch.device(DEVICE)
    lib = _build.library()
    for dh in (1, 7, 16, 32, 63, 64, 100, 128):
        for dtype, code in _build.DTYPE_CODES.items():
            mirror = attn.bwd_smem_bytes(dh, dtype)
            native = lib.asr_masked_attention_bwd_smem(code, dh)
            require(mirror == native and native <= attn.MAX_SMEM,
                    f"masked_attention_bwd shared memory at Dh={dh}, {dtype}: "
                    f"Python {mirror}, C {native}")
    print("masked_attention_bwd shared memory: mirror equals the C query at "
          f"8 widths; {attn.bwd_smem_bytes(64, torch.float32)} bytes at f32 "
          "Dh 64 (independent of Tq, Tk)")
    for b, h in ((E2E_BATCH, 8), (E2E_BATCH * 80, 1)):
        t, dh = 134, 64
        q, k, v, dout = (torch.from_numpy(rng.standard_normal(
            (b, h, t, dh)).astype(np.float32)).to(dev) for _ in range(4))
        k_valid = torch.arange(t, device=dev)[None, :] < torch.from_numpy(
            rng.integers(t // 3, t + 1, size=b)).to(dev)[:, None]
        got = attn._backward(q, k, v, k_valid, dout, False, None, 1.0)
        want = attn.masked_attention_bwd_reference(q, k, v, k_valid, dout)
        errs, ok = [], True
        for name, x, y in zip(("dq", "dk", "dv"), got, want):
            good, err = close_enough(x, y, 0.0, 1e-6)
            ok &= good and bool(torch.isfinite(x).all())
            errs.append(f"{name} {err:.3g}")
        print(f"masked_attention_bwd f32 [{b}, {h}, {t}, {dh}]: max abs err "
              f"{', '.join(errs)} (atol 1e-6) {'ok' if ok else 'FAIL'}")
        require(ok, "masked_attention_bwd disagrees with its twin in f32 at "
                "T 134")
        if h == 8:
            k_ms, p_ms = paired_ms(
                lambda: attn._backward(q, k, v, k_valid, dout, False, None,
                                       1.0),
                lambda: attn.masked_attention_bwd_reference(q, k, v, k_valid,
                                                            dout))
            print(f"time masked_attention_bwd f32 [{b}, {h}, {t}, {dh}]: "
                  f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms")


def ffn_problem(rng, n, dtype, d=512, f=2048):
    """x [n, d] and Dense-initialised W1 [f, d], W2 [d, f] with non-zero
    biases, on the card in ``dtype``."""
    import torch
    arrays = (rng.standard_normal((n, d)),
              rng.standard_normal((f, d)) / np.sqrt(d),
              0.1 * rng.standard_normal(f),
              rng.standard_normal((d, f)) / np.sqrt(f),
              0.1 * rng.standard_normal(d))
    return [torch.from_numpy(a.astype(np.float32)).to(DEVICE, dtype)
            for a in arrays]


def check_fused_ffn(results, rng):
    """``fused_ffn`` against its twin at the paths' shapes: [4096, 512] (LM
    training, 64 x 64), [800, 512] (LM serving, 8 x 100), [1072, 512] (the
    e2e encoder, 8 x 134), [8, 512] (a cached decoder step) in bf16 and
    [800, 512] in f32, inner width 2048; D 1024 with inner 4096, [4096,
    1024] in bf16 (four column groups, two passes over F with the
    workspace) and [800, 1024] in f32 (the wide f32 kernel); a single
    row [1, 512] and [200, 512] with inner 2000 in bf16 (a part-filled row
    tile of the 128-row tiling and a part-filled last F-slice); then a
    ragged [37, 48] with inner 208 (fewer inner and output columns than a
    tile) and D 40 / F 72 (zero-padded to 48 / 80) in both types. bf16:
    within 2e-2 and at most 1 in 100 elements differing at all (the
    kernel's f32 sums run in another order than cuBLAS's, so an element may
    round the other way, and an inner element that does moves the output by
    a fraction of an ulp); the count that differ is printed; f32 within
    1e-5. Every shape is launched twice and must give the same output, and
    its tiling (``kernels/ffn.py`` plan: rows, slices, width, passes,
    groups, shared memory, workspace) must equal the launcher's
    (``asr_fused_ffn_plan``). The shapes of D 512 and 1024 are timed beside
    the twin and the library yardstick, ``F.linear`` -> relu ->
    ``F.linear`` on cuBLAS with the same roundings (the twin's own ops,
    called directly), with their bound."""
    import torch
    import torch.nn.functional as F
    from asr_dfcnn_transformer_torch.kernels import (_build, ffn, fused_ffn,
                                                     fused_ffn_reference)
    from asr_dfcnn_transformer_torch.timing import cuda_ms
    r = results["fused_ffn"]
    lib = _build.library()
    for n, dtype, d, f in ((4096, torch.bfloat16, 512, 2048),
                           (800, torch.bfloat16, 512, 2048),
                           (1072, torch.bfloat16, 512, 2048),
                           (8, torch.bfloat16, 512, 2048),
                           (1, torch.bfloat16, 512, 2048),
                           (200, torch.bfloat16, 512, 2000),
                           (800, torch.float32, 512, 2048),
                           (4096, torch.bfloat16, 1024, 4096),
                           (800, torch.float32, 1024, 4096),
                           (37, torch.bfloat16, 48, 208),
                           (37, torch.float32, 48, 208),
                           (37, torch.bfloat16, 40, 72),
                           (37, torch.float32, 40, 72)):
        x, w1, b1, w2, b2 = ffn_problem(rng, n, dtype, d, f)
        got = fused_ffn(x, w1, b1, w2, b2)
        same = torch.equal(got, fused_ffn(x, w1, b1, w2, b2))
        want = fused_ffn_reference(x, w1, b1, w2, b2)
        n_diff = int((got != want).sum())
        pd, pf = -(-d // 16) * 16, -(-f // 16) * 16   # the padded widths
        plan = ffn.plan(n, pd, pf, dtype)
        native = {k: lib.asr_fused_ffn_plan(_build.DTYPE_CODES[dtype], n, pd,
                                            pf, i)
                  for i, k in enumerate(ffn.PLAN_FIELDS)}
        require(plan == native, f"fused_ffn plan at [{n}, {pd}] F {pf} "
                f"{dtype}: Python {plan}, C {native}")
        require(same, f"fused_ffn at [{n}, {d}] F {f} {dtype} differs "
                "between launches")
        if dtype == torch.float32:
            ok, err = close_enough(got, want, 1e-5, 1e-5)
            tol = "rtol = atol = 1e-5"
        else:
            ok, err = close_enough(got, want, 2e-2, 2e-2)
            ok &= n_diff <= got.numel() // 100
            tol = "2e-2; at most 1 in 100 differ"
        ok &= bool(torch.isfinite(got.float()).all())
        line = (f"fused_ffn [{n}, {d}] F {f} {dtype}: max abs err {err:.3g}, "
                f"{n_diff} of {got.numel()} elements differ ({tol}), the "
                f"same twice, plan {plan} (the C query's) "
                f"{'ok' if ok else 'FAIL'}")
        if d % 512 or n in (1, 200):          # checked, not timed
            print(line)
            require(ok, f"fused_ffn disagrees with its twin at [{n}, {d}] "
                    f"F {f} {dtype}")
            continue
        k_ms, p_ms = paired_ms(lambda: fused_ffn(x, w1, b1, w2, b2),
                               lambda: fused_ffn_reference(x, w1, b1, w2, b2))

        def library():
            inner = torch.relu(F.linear(x, w1) + b1)
            return F.linear(inner, w2) + b2
        lib_ms = cuda_ms(library)
        bound = {}
        set_bound(bound, nbytes(x, w1, b1, w2, b2, got),
                  {"bf16" if dtype == torch.bfloat16 else "f32":
                   4 * n * d * f})
        print(f"{line}; kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, library "
              f"{lib_ms:.4f} ms, bound {bound['bound_ms']:.5f} ms "
              f"({bound['bound_by']})")
        require(ok, f"fused_ffn disagrees with its twin at [{n}, {d}] "
                f"{dtype}")
        if n == LM_BATCH * LM_LEN and d == 512:
            r.update(bound, max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                     library_ms=lib_ms)


def check_interleave_epilogue(results, rng):
    """``interleave_epilogue`` against its twin, bit for bit, at
    ``check_inputs.EPILOGUE_CASES``: its docstring's shape [128, 256, 512]
    (batch 128, n 262,144) in bf16 and f32, the AM step's [16, 256, 512] in
    bf16, [3, 2, 4] (n 16) in both types, and ragged shapes whose rows
    start off 16-byte boundaries ([5, 33, 36], [5, 33, 35] and [3, 7, 5],
    the last two a view one element into its storage); each timed beside
    its twin (CUDA events, in turns) with its device time per launch
    (profiler) and its bound: the bytes of z read once and of x written
    once. No one PyTorch call computes this relayout."""
    import torch
    from asr_dfcnn_transformer_torch.check_inputs import (EPILOGUE_CASES,
                                                          epilogue_z)
    from asr_dfcnn_transformer_torch.kernels import (
        interleave_epilogue, interleave_epilogue_reference)
    from asr_dfcnn_transformer_torch.timing import device_us, us_text
    r = results["interleave_epilogue"]
    for label, shape, dtype, offset in EPILOGUE_CASES:
        n = 2 * shape[1] * shape[2]
        zr, zi = (epilogue_z(rng, shape, dtype, offset, DEVICE)
                  for _ in range(2))
        got = interleave_epilogue(zr, zi, n)
        want = interleave_epilogue_reference(zr, zi, n)
        same = torch.equal(got, want)
        err = float((got - want).abs().max())
        line = (f"interleave_epilogue {label} {list(shape)} {dtype} offset "
                f"{offset}: bit-equal {same} (max abs err {err:.3g})")
        print(line)
        require(same and got.shape == (shape[0], n),
                f"interleave_epilogue disagrees with its twin at "
                f"{list(shape)} {dtype}")
        k_ms, p_ms = paired_ms(lambda: interleave_epilogue(zr, zi, n),
                               lambda: interleave_epilogue_reference(zr, zi,
                                                                     n))
        us = device_us(lambda: interleave_epilogue(zr, zi, n),
                       "interleave_epilogue_kernel")
        bound = {}
        set_bound(bound, nbytes(zr, zi, got), {})
        print(f"time interleave_epilogue {list(shape)} {dtype}: kernel "
              f"{k_ms:.4f} ms, device {us_text(us)} a launch, plain "
              f"{p_ms:.4f} ms, bound {bound['bound_ms']:.5f} ms "
              f"({bound['bound_by']}), library — no one call")
        if shape == (128, 256, 512) and dtype == torch.bfloat16:
            r.update(bound, max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                     library_ms=None)


def build_models(dtype, device):
    import torch
    from asr_dfcnn_transformer_torch import vocab
    from asr_dfcnn_transformer_torch.models import (SEDFCNN, SEDFCNNConfig,
                                                    TransformerLM,
                                                    TransformerLMConfig)
    av, lv = vocab.acoustic_vocab(), vocab.language_vocab()
    gen = torch.Generator().manual_seed(SEED)
    am = SEDFCNN(SEDFCNNConfig(av.size, dtype=dtype), device=device,
                 generator=gen).eval()
    lm = TransformerLM(TransformerLMConfig(av.size, lv.size, dtype=dtype),
                       device=device, generator=gen).eval()
    return am, lm, av, lv


def phase_served(results):
    import torch
    from asr_dfcnn_transformer_torch.infer import BatchingServer, Pipeline
    from asr_dfcnn_transformer_torch.kernels import LAUNCHES, reset_launches
    am, lm, av, lv = build_models(torch.bfloat16, DEVICE)
    n_params = sum(p.numel() for m in (am, lm) for p in m.parameters())
    print(f"models: SE-DFCNN 32/64/128/128/128 head 256 vocab {av.size}, "
          f"LM 12x512x8 vocab {lv.size}, bf16, {n_params / 1e6:.1f} M params")
    rng = np.random.default_rng(SEED + 1)
    warm = [tone_utterance(rng, (b - 20) * 160) for b in BUCKETS]
    utts = [tone_utterance(rng, int(sec * SAMPLE_RATE))
            for sec in SERVED_SECONDS]
    for decode, names in SERVED.items():
        pipe = Pipeline(am, lm, acoustic_vocab=av, language_vocab=lv,
                        decode=decode, beam_width=BEAM_WIDTH)
        reset_launches()
        with BatchingServer(pipe, max_batch=MAX_BATCH, max_wait_ms=20.0,
                            bucket_bounds=BUCKETS) as srv:
            for f in [srv.submit(u) for u in warm]:
                f.result(timeout=600)
            # latency: submit -> the future is seen resolved (as_completed
            # wakes on each completion; a done-callback could still be
            # pending when result() returns)
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
                    and isinstance(hanzi, str),
                    "result is not (pinyin, hanzi)")
        wall = max(lat.values())
        lat = sorted(lat.values())
        print(f"{decode}: served {len(outs)} utterances ({stats.requests} "
              f"requests incl. {len(warm)} warm-up, {stats.batches} batches, "
              f"occupancy {stats.mean_occupancy:.2f}, per bucket "
              f"{stats.per_bucket})")
        print(f"{decode}: served burst of {len(utts)}: "
              f"{len(utts) / wall:.2f} utt/s, p50 latency "
              f"{1e3 * lat[len(lat) // 2]:.1f} ms, max {1e3 * lat[-1]:.1f} ms")
        print(f"{decode}: example: {len(outs[0][0])} pinyin, first "
              f"{' '.join(outs[0][0][:5])!r}, hanzi {outs[0][1][:8]!r}")
        print(f"{decode}: launch counts on the served path: {counts}")
        for name in names:
            require(counts.get(name, 0) > 0,
                    f"{name} was never launched ({decode})")
            results[name].setdefault("launches", counts[name])


def run_am_lm(am, lm, dev, sig, lens, bucket, pny_for_lm=None):
    """fbank -> AM -> greedy pinyin (capped at the LM's positions) -> LM
    on ``dev`` for host signals [B, S] and lengths [B]; the LM reads
    ``pny_for_lm`` when given. -> (logits, logit lengths, pinyin ids,
    pinyin lengths, LM logits), on the CPU."""
    import torch
    from asr_dfcnn_transformer_torch.audio.fbank import batched_fbank
    from asr_dfcnn_transformer_torch.models import (frames_from_samples,
                                                    logit_lengths)
    from asr_dfcnn_transformer_torch.ops import ctc_greedy_decode
    x = torch.from_numpy(np.asarray(sig, np.float32)).to(dev)
    n = torch.from_numpy(np.asarray(lens, np.int32)).to(dev)
    feats, _ = batched_fbank(x, n, out_frames=bucket)
    logits = am(feats[:, None])
    in_len = logit_lengths(frames_from_samples(n), logits.shape[1])
    ids, ids_len = ctc_greedy_decode(logits, in_len,
                                     max_output_len=LM_MAX_LEN)
    lm_in = ids if pny_for_lm is None else pny_for_lm.to(dev)
    return (logits.cpu(), in_len.cpu(), ids.cpu(), ids_len.cpu(),
            lm(lm_in.long()).cpu())


def top2_margin(x):
    import torch
    top2 = torch.topk(x, 2, dim=-1).values
    return top2[..., 0] - top2[..., 1]


def check_am_lm_agreement(label, cpu_models, card_models, sig, lens,
                          bucket):
    """Phase 4's rule: the AM's frame argmax and the LM's hanzi argmax (the
    LM fed the CPU's pinyin on both devices) agree wherever the CPU's
    top-2 margin >= MARGIN, and with every AM margin that high the
    decoded pinyin are equal. Returns (CPU logits, logit lengths, whether
    every margin of both models was that high)."""
    import torch
    with torch.inference_mode():
        c_logits, c_len, c_ids, c_ids_len, c_lm = run_am_lm(
            *cpu_models, "cpu", sig, lens, bucket)
        g_logits, _, g_ids, g_ids_len, g_lm = run_am_lm(
            *card_models, DEVICE, sig, lens, bucket, pny_for_lm=c_ids)
    frames = torch.arange(c_logits.shape[1])[None, :] < c_len[:, None]
    sure = frames & (top2_margin(c_logits) >= MARGIN)
    am_bad = int((sure & (c_logits.argmax(-1) != g_logits.argmax(-1))).sum())
    pos = torch.arange(c_lm.shape[1])[None, :] < c_ids_len[:, None]
    sure_lm = pos & (top2_margin(c_lm) >= MARGIN)
    lm_bad = int((sure_lm & (c_lm.argmax(-1) != g_lm.argmax(-1))).sum())
    seq_equal = bool(torch.equal(c_ids, g_ids)
                     and torch.equal(c_ids_len, g_ids_len))
    print(f"{label}: AM logits max abs diff "
          f"{float((c_logits - g_logits).abs().max()):.3g}; frame argmax "
          f"mismatches {am_bad} of {int(sure.sum())} frames with margin >= "
          f"1e-3 ({int(frames.sum())} valid)")
    print(f"  pinyin lengths {c_ids_len.tolist()}, decoded pinyin equal: "
          f"{seq_equal}; LM logits max abs diff "
          f"{float((c_lm - g_lm).abs().max()):.3g}; hanzi mismatches "
          f"{lm_bad} of {int(sure_lm.sum())} positions with margin >= 1e-3")
    require(am_bad == 0 and lm_bad == 0, f"{label}: card and CPU ids "
            "disagree")
    am_sure = bool(sure.sum() == frames.sum())
    if am_sure:
        require(seq_equal, f"{label}: decoded pinyin differs with every "
                "margin >= 1e-3")
    return c_logits, c_len, am_sure and bool(sure_lm.sum() == pos.sum())


def phase_card_vs_cpu():
    import torch
    from asr_dfcnn_transformer_torch.audio.fbank import samples_for_frames
    from asr_dfcnn_transformer_torch.ops import ctc_beam_search_decode
    am_cpu, lm_cpu, _, _ = build_models(torch.float32, "cpu")
    am_gpu = copy.deepcopy(am_cpu).to(DEVICE).eval()
    lm_gpu = copy.deepcopy(lm_cpu).to(DEVICE).eval()
    rng = np.random.default_rng(SEED + 2)
    s = samples_for_frames(BUCKETS[0])
    sig = np.zeros((2, s), np.float32)
    lens = np.array([s, 2 * s // 3], np.int32)
    for i, n in enumerate(lens):
        sig[i, :n] = tone_utterance(rng, n)
    c_logits, c_len, _ = check_am_lm_agreement(
        f"card vs CPU, f32, bucket {BUCKETS[0]}", (am_cpu, lm_cpu),
        (am_gpu, lm_gpu), sig, lens, BUCKETS[0])

    # the beam decode of the CPU's logits: the twins on the CPU, the
    # kernels on the card
    kw = dict(beam_width=BEAM_WIDTH, topk=BEAM_WIDTH,
              max_decode_len=LM_MAX_LEN)
    with torch.inference_mode():
        c_beam = ctc_beam_search_decode(c_logits, c_len, **kw)
        g_beam = [x.cpu() for x in ctc_beam_search_decode(
            c_logits.to(DEVICE), c_len.to(DEVICE), **kw)]
    same = (torch.equal(c_beam[0], g_beam[0])
            and torch.equal(c_beam[1], g_beam[1]))
    ok, err = close_enough(g_beam[2], c_beam[2], 1e-5, 1e-4)
    print(f"  beam decode (W = K = {BEAM_WIDTH}, L {LM_MAX_LEN}) card vs "
          f"CPU: lengths {c_beam[1].tolist()}, ids equal {same}, "
          f"neg-log-prob {c_beam[2].tolist()} max abs diff {err:.3g} (rtol "
          f"1e-5, atol 1e-4) {'ok' if same and ok else 'FAIL'}")
    require(same and ok, "beam decode differs between card and CPU")


def am_batch(rng, batch, bucket, labels, vocab):
    """A fixed synthetic AM batch: tone utterances of ragged length (the
    first fills the bucket), ``labels`` = (tokens, padded width) random
    pinyin ids (never 0, never the blank)."""
    from asr_dfcnn_transformer_torch.audio.fbank import samples_for_frames
    from asr_dfcnn_transformer_torch.data import AMBatch
    n = samples_for_frames(bucket)
    lens = rng.integers(int(0.6 * n), n + 1, size=batch).astype(np.int32)
    lens[0] = n
    sig = np.zeros((batch, n), np.float32)
    for i, m in enumerate(lens):
        sig[i, :m] = tone_utterance(rng, int(m))
    frames = (1 + np.ceil((lens - 400) / 160)).astype(np.int32)
    n_tok, width = labels
    pinyin = np.zeros((batch, width), np.int32)
    pinyin[:, :n_tok] = rng.integers(1, vocab - 1, size=(batch, n_tok))
    pny_len = np.full(batch, n_tok, np.int32)
    return AMBatch(sig, lens, frames, pinyin, pny_len, pinyin.copy(),
                   pny_len.copy(), np.ones(batch, np.float32), bucket)


def lm_batch(rng, batch, length, in_vocab, out_vocab):
    """A fixed synthetic LM batch: ragged pinyin/hanzi id rows with PAD
    tails, the last row back-filled (weight 0)."""
    from asr_dfcnn_transformer_torch.data import LMBatch
    lens = rng.integers(length // 2, length + 1, size=batch).astype(np.int32)
    lens[0] = length
    pinyin = np.zeros((batch, length), np.int32)
    hanzi = np.zeros((batch, length), np.int32)
    for i, m in enumerate(lens):
        pinyin[i, :m] = rng.integers(1, in_vocab, m)
        hanzi[i, :m] = rng.integers(1, out_vocab, m)
    weights = np.ones(batch, np.float32)
    weights[-1] = 0.0
    return LMBatch(pinyin, hanzi, lens, weights)


def train_steps(name, tr, batch, gen):
    """TRAIN_STEPS steps on one batch, then one eval step; the checks of
    phases 5 and 9; returns the losses, ms/step over the steps after
    WARMUP_STEPS, peak memory, and the launch counts just after the
    steps."""
    import torch
    from asr_dfcnn_transformer_torch.kernels import LAUNCHES
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = [tr.train_step(batch, gen)["loss"]]
    require_finite_grads(f"{name} after step 1", tr.model)
    for _ in range(WARMUP_STEPS - 1):
        losses.append(tr.train_step(batch, gen)["loss"])
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(TRAIN_STEPS - WARMUP_STEPS):
        losses.append(tr.train_step(batch, gen)["loss"])
    end.record()
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    ms = start.elapsed_time(end) / (TRAIN_STEPS - WARMUP_STEPS)
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    print(f"{name}: {TRAIN_STEPS} steps, losses "
          f"{' '.join(f'{x:.4f}' for x in losses)}")
    print(f"{name}: {ms:.2f} ms/step over steps {WARMUP_STEPS + 1}-"
          f"{TRAIN_STEPS} (CUDA events), peak memory {peak / 2**30:.2f} GiB")
    require(all(np.isfinite(losses)), f"{name}: a loss is not finite")
    require(losses[-1] < losses[0], f"{name}: the loss did not fall")
    ev = {k: float(v) for k, v in tr.eval_step(batch).items()}
    print(f"{name}: eval step {ev}")
    require(all(np.isfinite(list(ev.values()))), f"{name}: eval not finite")
    return {"losses": losses, "ms_per_step": ms, "peak_bytes": peak,
            "launches": launches}


def fit_epoch(name, tr, batch, gen):
    """One epoch of an AM / LM trainer's ``fit``: a checkpoint for epoch 0
    and a finite dev loss."""
    out = tr.fit(lambda: iter([batch]), lambda: iter([batch]), epochs=1,
                 generator=gen)
    saved = tr.ckpt.latest_step()
    print(f"{name}: fit epoch {out}, checkpoint step {saved}, best metric "
          f"{tr.ckpt.best_metric()}")
    require(saved == 0 and np.isfinite(out["dev_loss"]),
            f"{name}: fit saved no checkpoint")


def phase_training(results):
    import torch
    from asr_dfcnn_transformer_torch.kernels import LAUNCHES, reset_launches
    from asr_dfcnn_transformer_torch.train import AMTrainer, LMTrainer
    am, lm, av, lv = build_models(torch.bfloat16, DEVICE)
    rng = np.random.default_rng(SEED + 3)
    amb = am_batch(rng, AM_BATCH, AM_BUCKET, AM_LABELS, av.size)
    lmb = lm_batch(rng, LM_BATCH, LM_LEN, av.size, lv.size)
    print(f"training: AM batch {AM_BATCH} at bucket {AM_BUCKET}, "
          f"{AM_LABELS[0]} labels padded to {AM_LABELS[1]}; LM batch "
          f"{LM_BATCH} x {LM_LEN}, dropout {lm.config.dropout_rate}; "
          f"bf16 compute, f32 parameters, Adam (AM lr 7e-4, LM lr {LM_LR})")
    workdir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    stats = {}
    try:
        reset_launches()
        for name, tr, batch in (
                ("am", AMTrainer(am, os.path.join(workdir, "am")), amb),
                ("lm", LMTrainer(lm, os.path.join(workdir, "lm"), lr=LM_LR),
                 lmb)):
            gen = torch.Generator(device=DEVICE).manual_seed(SEED)
            stats[name] = train_steps(name, tr, batch, gen)
            fit_epoch(name, tr, batch, gen)
        counts = dict(LAUNCHES)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(f"launch counts on the training path: {counts}")
    for name in TRAINED:
        require(counts.get(name, 0) > 0, f"{name} was never launched")
        results[name]["launches"] = counts[name]
    return stats["am"]


def phase_train_card_vs_cpu():
    """One step of each trainer at small widths, f32, dropout 0, the same
    weights on the card (kernels) and the CPU (twins); both AM steps read
    the CPU's fbank features, which phase 2 holds to the kernels'."""
    import torch
    from asr_dfcnn_transformer_torch.models import (SEDFCNN, SEDFCNNConfig,
                                                    TransformerLM,
                                                    TransformerLMConfig)
    from asr_dfcnn_transformer_torch.train import AMTrainer, LMTrainer
    rng = np.random.default_rng(SEED + 4)
    gen = torch.Generator().manual_seed(SEED)
    am = SEDFCNN(SEDFCNNConfig(48, stage_features=(8, 8, 16, 16, 16),
                               head_features=16, dropout_rate=0.0,
                               dtype=torch.float32), device="cpu",
                 generator=gen)
    lm = TransformerLM(TransformerLMConfig(48, 64, d_model=64, num_heads=4,
                                           num_blocks=2, dropout_rate=0.0,
                                           dtype=torch.float32),
                       device="cpu", generator=gen)
    amb = am_batch(rng, 4, 128, (8, 12), 48)
    lmb = lm_batch(rng, 4, 16, 48, 64)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_cmp_")
    try:
        feats = None
        for name, model, make, batch in (("am", am, AMTrainer, amb),
                                         ("lm", lm, LMTrainer, lmb)):
            out = {}
            for where in ("cpu", DEVICE):
                tr = make(copy.deepcopy(model).to(where),
                          os.path.join(workdir, f"{name}_{where}"))
                if name == "am":
                    if feats is None:
                        feats = tr.features(torch.from_numpy(batch.signals),
                                            torch.from_numpy(
                                                batch.signal_lengths),
                                            batch.bucket_frames)
                    tr.features = lambda *a, _d=where: feats.to(_d)
                out[where] = step_and_grads(tr, batch)
            compare_steps(name, out["cpu"], out[DEVICE])
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def step_and_grads(tr, batch):
    """One train step: (its loss, every parameter's gradient on the CPU)."""
    loss = float(tr.train_step(batch)["loss"])
    return loss, {n: p.grad.cpu() for n, p in tr.model.named_parameters()}


def compare_steps(name, cpu, card):
    """The loss within rtol 1e-5 and every gradient within rtol 1e-4, atol
    1e-5 x max(1, its largest entry): sums in another order (cuDNN's
    convolutions, cuBLAS, the kernels) on one side."""
    (lc, gc), (lg, gg) = cpu, card
    worst, worst_name, ok = 0.0, "", abs(lg - lc) <= 1e-5 * abs(lc)
    for n, want in gc.items():
        atol = 1e-5 * max(1.0, float(want.abs().max()))
        good, err = close_enough(gg[n], want, 1e-4, atol)
        ok &= good
        if err >= worst:
            worst, worst_name = err, n
    print(f"train step card vs CPU, {name}: loss {lg:.6f} vs "
          f"{lc:.6f}; {len(gc)} gradients, max abs err {worst:.3g} "
          f"({worst_name}; rtol 1e-4, atol 1e-5 x max(1, |grad|max)) "
          f"{'ok' if ok else 'FAIL'}")
    require(ok, f"{name}: card and CPU training steps disagree")


def build_e2e(dtype, device):
    import torch
    from asr_dfcnn_transformer_torch import vocab
    from asr_dfcnn_transformer_torch.models import (SpeechTransformer,
                                                    SpeechTransformerConfig)
    ev = vocab.e2e_language_vocab()
    model = SpeechTransformer(
        SpeechTransformerConfig(ev.size, dtype=dtype),
        feature_dim=E2E_LFR[0] * E2E_NFILT, device=device,
        generator=torch.Generator().manual_seed(SEED)).eval()
    return model, ev


def phase_e2e_served(results):
    import torch
    from asr_dfcnn_transformer_torch.infer import E2EServing
    from asr_dfcnn_transformer_torch.kernels import LAUNCHES, reset_launches
    model, ev = build_e2e(torch.bfloat16, DEVICE)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"e2e model: pre-net 64 ch + 2 dual blocks, 6 + 6 blocks d 512 "
          f"x 8 heads, vocab {ev.size}, bf16, {n_params / 1e6:.1f} M params")
    rng = np.random.default_rng(SEED + 5)
    utts = [tone_utterance(rng, int(sec * SAMPLE_RATE))
            for sec in SERVED_SECONDS]
    lengths = np.array([len(u) for u in utts], np.int32)
    signals = np.zeros((len(utts), int(lengths.max())), np.float32)
    for i, u in enumerate(utts):
        signals[i, :len(u)] = u
    for decode in ("greedy", "beam"):
        srv = E2EServing(model, ev, feature_dim=E2E_NFILT,
                         lfr_m=E2E_LFR[0], lfr_n=E2E_LFR[1], decode=decode,
                         beam_width=E2E_BEAM, max_len=E2E_MAX_LEN)
        srv.recognize_batch(signals[:MAX_BATCH], lengths[:MAX_BATCH])
        reset_launches()
        t0 = time.perf_counter()
        ids, lens = srv.recognize_batch(signals, lengths)
        wall = time.perf_counter() - t0
        counts = dict(LAUNCHES)
        chunks = len(srv.chunk_ms)
        require(ids.shape == (len(utts), E2E_MAX_LEN) and ids.dtype == np.int32
                and lens.shape == (len(utts),), "e2e result shapes")
        require(bool(((ids >= 0) & (ids < ev.size)).all())
                and bool(((lens >= 0) & (lens <= E2E_MAX_LEN)).all()),
                "e2e ids or lengths out of range")
        text = "".join(ev.decode(ids[0][:int(lens[0])]))
        print(f"e2e {decode}: served burst of {len(utts)} in {chunks} chunks: "
              f"{len(utts) / wall:.2f} utt/s, chunk wall "
              f"{', '.join(f'{t:.1f}' for t in srv.chunk_ms)} ms")
        print(f"e2e {decode}: lengths {lens.tolist()}, first text "
              f"{text[:8]!r}")
        print(f"e2e {decode}: launch counts on the served path: {counts}")
        for name in E2E_SERVED:
            require(counts.get(name, 0) > 0,
                    f"{name} was never launched (e2e {decode})")
        dual = counts.get("dual_axis_attention", 0)
        require(dual == 2 * chunks, f"dual_axis_attention launched {dual} "
                f"times in {chunks} encodes, not twice each")
        if decode == "greedy":
            results["dual_axis_attention"]["launches"] = dual


def phase_e2e_card_vs_cpu():
    """The e2e program in f32 on both devices, each through its own front
    end: the encoder memory within E2E_MEMORY_ATOL; greedy and beam ids up
    to the first step at which the CPU's decision margin (top-2 logit gap;
    for the beam, the gap between the K-th and (K+1)-th best candidate)
    falls below MARGIN; beam scores within 1e-4 relative where the ids
    agree."""
    import torch
    from asr_dfcnn_transformer_torch.audio.fbank import (FbankConfig,
                                                         batched_fbank,
                                                         samples_for_frames)
    from asr_dfcnn_transformer_torch.audio.lfr import batched_lfr
    from asr_dfcnn_transformer_torch.models import speech_transformer as st
    cpu_model, _ = build_e2e(torch.float32, "cpu")
    gpu_model = copy.deepcopy(cpu_model).to(DEVICE).eval()
    rng = np.random.default_rng(SEED + 6)
    s = samples_for_frames(E2E_CMP_BUCKET)
    sig = np.zeros((2, s), np.float32)
    lens = np.array([s, 2 * s // 3], np.int32)
    for i, n in enumerate(lens):
        sig[i, :n] = tone_utterance(rng, n)

    def run(model, dev, margins):
        feats, valid = batched_fbank(
            torch.from_numpy(sig).to(dev), torch.from_numpy(lens).to(dev),
            cfg=FbankConfig(nfilt=E2E_NFILT), out_frames=E2E_CMP_BUCKET)
        lfr, lfr_valid = batched_lfr(feats, valid, *E2E_LFR)
        mem, mv = model.encode(lfr[..., None], lfr_valid)
        greedy = st._greedy_cached(model, mem, mv, E2E_MAX_LEN,
                                   margins["greedy"])
        beam = st._beam_cached(model, mem, mv, E2E_BEAM, 0.6, E2E_MAX_LEN,
                               margins["beam"])
        return [x.cpu() for x in (mem, *greedy, *beam)]

    margins = {"greedy": [], "beam": []}
    with torch.inference_mode():
        cpu = run(cpu_model, "cpu", margins)
        gpu = run(gpu_model, DEVICE, {"greedy": None, "beam": None})
    err = float((cpu[0] - gpu[0]).abs().max())
    print(f"e2e card vs CPU, f32, bucket {E2E_CMP_BUCKET}: encoder memory "
          f"{list(cpu[0].shape)} max abs diff {err:.3g} (atol "
          f"{E2E_MEMORY_ATOL})")
    require(err <= E2E_MEMORY_ATOL, "e2e encoder memory differs card vs CPU")
    for name, (ids_c, len_c), (ids_g, len_g) in (
            ("greedy", cpu[1:3], gpu[1:3]), ("beam", cpu[3:5], gpu[3:5])):
        gaps = torch.stack(margins[name], dim=1)               # [B, L]
        for b in range(ids_c.shape[0]):
            low = torch.nonzero(gaps[b] < MARGIN)
            upto = int(low[0]) if len(low) else E2E_MAX_LEN
            same = torch.equal(ids_c[b, :upto], ids_g[b, :upto])
            whole = upto == E2E_MAX_LEN
            if whole:
                same &= bool(len_c[b] == len_g[b])
            line = (f"  {name} utt {b}: CPU margin >= {MARGIN} for "
                    f"{upto} of {E2E_MAX_LEN} steps (least "
                    f"{float(gaps[b].min()):.3g}), ids equal there: {same}, "
                    f"lengths CPU {int(len_c[b])} card {int(len_g[b])}")
            if name == "beam" and whole and same:
                sc, sg = float(cpu[5][b]), float(gpu[5][b])
                ok = abs(sc - sg) <= 1e-4 * abs(sc)
                line += f", score {sc:.6f} vs {sg:.6f}"
                require(ok, "e2e beam scores differ card vs CPU")
            print(line)
            require(same, f"e2e {name} ids differ card vs CPU")


def e2e_batch(rng, batch, bucket, labels, vocab):
    """A fixed synthetic e2e batch: ``am_batch``'s tone utterances with
    ragged hanzi labels of up to ``labels[0]`` tokens (the first that
    long) padded to ``labels[1]``, ids past the special tokens."""
    from asr_dfcnn_transformer_torch.core import constants
    b = am_batch(rng, batch, bucket, labels, vocab)
    n_tok, width = labels
    lens = rng.integers(n_tok // 2, n_tok + 1, size=batch).astype(np.int32)
    lens[0] = n_tok
    hanzi = np.zeros((batch, width), np.int32)
    for i, m in enumerate(lens):
        hanzi[i, :m] = rng.integers(constants.EOS + 1, vocab, size=m)
    b.hanzi, b.hanzi_lengths = hanzi, lens
    return b


def phase_e2e_training(results):
    """Phase 9: the full-width e2e model trained on the card."""
    import torch
    from asr_dfcnn_transformer_torch.kernels import reset_launches
    from asr_dfcnn_transformer_torch.train import E2ETrainer
    model, ev = build_e2e(torch.bfloat16, DEVICE)
    rng = np.random.default_rng(SEED + 7)
    batch = e2e_batch(rng, E2E_BATCH, E2E_BUCKET, E2E_LABELS, ev.size)
    print(f"e2e training: batch {E2E_BATCH} at bucket {E2E_BUCKET}, hanzi "
          f"labels of {batch.hanzi_lengths.min()}-{E2E_LABELS[0]} tokens "
          f"padded to {E2E_LABELS[1]}, dropout {model.config.dropout_rate}, "
          f"SpecAugment on; bf16 compute, f32 parameters, Adam lr {E2E_LR}")
    workdir = tempfile.mkdtemp(prefix="chip_smoke_e2e_")
    try:
        tr = E2ETrainer(model, workdir, lr=E2E_LR, feature_dim=E2E_NFILT,
                        lfr_m=E2E_LFR[0], lfr_n=E2E_LFR[1],
                        augment_spec=True)
        gen = torch.Generator(device=DEVICE).manual_seed(SEED)
        reset_launches()
        counts = train_steps("e2e", tr, batch, gen)["launches"]
        print(f"launch counts on the e2e training path ({TRAIN_STEPS} "
              f"steps): {counts}")
        for name in E2E_TRAINED:
            require(counts.get(name, 0) > 0, f"{name} was never launched "
                    "(e2e training)")
        for name in ("dual_axis_attention", "dual_axis_attention_bwd"):
            n = counts.get(name, 0)
            require(n == 2 * TRAIN_STEPS, f"{name} launched {n} times in "
                    f"{TRAIN_STEPS} steps, not twice each")
        results["dual_axis_attention_bwd"]["launches"] = counts.get(
            "dual_axis_attention_bwd", 0)
        out = tr.fit(lambda: iter([batch]), epochs=1, generator=gen,
                     dev_batches=lambda: iter([batch]))
        saved = tr.ckpt.latest_step()
        with open(os.path.join(workdir, "e2e_epochs_completed.json")) as f:
            marker = json.load(f)
        print(f"e2e: fit epoch {out}, checkpoint step {saved}, epoch marker "
              f"{marker}, best metric {tr.ckpt.best_metric()}")
        require(saved == tr.step and marker == {"epochs_completed": 1}
                and np.isfinite(out["dev_loss"]),
                "e2e: fit saved no checkpoint or no epoch marker")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def phase_e2e_train_card_vs_cpu():
    """Phase 10: one e2e training step at small widths, f32, dropout 0,
    SpecAugment off, the same weights on the card (kernels) and the CPU
    (twins). Both read the CPU's features (phase 2 holds the front-end
    kernels to theirs). At bucket 512 (T' 43, Dh 16); then at bucket 1600
    with Dh 64 (d_model 128 in 2 heads, 64 pre-net channels), where the
    pre-net's time rows [B x 80, 1, 134, 64] and the encoder's [B, 2, 134,
    64] take the masked attention backward in f32."""
    import torch
    from asr_dfcnn_transformer_torch.models import (SpeechTransformer,
                                                    SpeechTransformerConfig)
    from asr_dfcnn_transformer_torch.train import E2ETrainer
    rng = np.random.default_rng(SEED + 8)
    vocab = 64
    for bucket, widths in (
            (E2E_CMP_BUCKET, dict(d_model=64, num_heads=4, num_enc_blocks=2,
                                  num_dec_blocks=2, prenet_channels=16)),
            (E2E_BUCKET, dict(d_model=128, num_heads=2, num_enc_blocks=1,
                              num_dec_blocks=1, prenet_channels=64))):
        model = SpeechTransformer(
            SpeechTransformerConfig(vocab, dropout_rate=0.0,
                                    dtype=torch.float32, **widths),
            feature_dim=E2E_LFR[0] * E2E_NFILT, device="cpu",
            generator=torch.Generator().manual_seed(SEED))
        batch = e2e_batch(rng, 4, bucket, (12, 16), vocab)
        workdir = tempfile.mkdtemp(prefix="chip_smoke_e2e_cmp_")
        try:
            out, feats = {}, None
            for where in ("cpu", DEVICE):
                tr = E2ETrainer(copy.deepcopy(model).to(where),
                                os.path.join(workdir, where),
                                feature_dim=E2E_NFILT, lfr_m=E2E_LFR[0],
                                lfr_n=E2E_LFR[1])
                if feats is None:
                    feats = tr.features(torch.from_numpy(batch.signals),
                                        torch.from_numpy(batch.signal_lengths),
                                        batch.bucket_frames)
                tr.features = lambda *a, _d=where: tuple(x.to(_d)
                                                         for x in feats)
                out[where] = step_and_grads(tr, batch)
            compare_steps(f"e2e at bucket {bucket}, Dh "
                          f"{widths['d_model'] // widths['num_heads']}",
                          out["cpu"], out[DEVICE])
        finally:
            shutil.rmtree(workdir, ignore_errors=True)


def ffn_config(dtype, ffn: str):
    """The default ``Config`` in ``dtype`` with ``fused_ffn=ffn`` for the
    LM and the e2e model."""
    import torch
    from asr_dfcnn_transformer_torch.core.config import (AmConfig, Config,
                                                         E2EConfig, LmConfig)
    name = "bfloat16" if dtype == torch.bfloat16 else "float32"
    return Config(am=AmConfig(dtype=name),
                  lm=LmConfig(fused_ffn=ffn, dtype=name),
                  e2e=E2EConfig(fused_ffn=ffn, dtype=name))


def require_finite_grads(name, model):
    """Every parameter has a gradient, and every gradient is finite."""
    import torch
    params = dict(model.named_parameters())
    no_grad = [n for n, p in params.items() if p.grad is None]
    not_finite = [n for n, p in params.items() if p.grad is not None
                  and not bool(torch.isfinite(p.grad).all())]
    print(f"{name}: {len(params) - len(no_grad)} of {len(params)} "
          f"parameters have a gradient, {len(not_finite)} non-finite")
    require(not no_grad, f"{name}: no gradient for {no_grad[:5]}")
    require(not not_finite, f"{name}: non-finite gradient in "
            f"{not_finite[:5]}")


def phase_fused_ffn(results):
    """Phase 11: the paths that select ``fused_ffn="pallas"``, built
    through ``train/factory.py`` from the default ``Config`` at full width
    in bf16: one AM -> LM served batch (greedy), one e2e greedy batch at
    bucket 1600 through ``E2EServing``, one ``LMTrainer`` step (64 x 64,
    dropout 0.5) and one ``E2ETrainer`` step (batch 8 at bucket 1600,
    dropout 0.1, SpecAugment). The launch counters are reset before and
    read after each: the kernel must run once per FeedForward block, 12
    times a served LM batch and a training step, 6 + 6 per cached step
    for the e2e decode. Then the same models in f32 with "pallas" and with
    "einsum" (the same seeded weights) on the served utterances: the LM's
    hanzi ids agree wherever the einsum model's top-2 logit margin >= 1e-3,
    the e2e encoder memory within E2E_MEMORY_ATOL and its greedy ids up to
    the first step whose margin falls below 1e-3 (phases 4 and 8's rule;
    f32, where the kernel's sums and cuBLAS's differ by ~1e-6, not bf16's
    ulps)."""
    import torch
    from asr_dfcnn_transformer_torch import vocab
    from asr_dfcnn_transformer_torch.audio.fbank import samples_for_frames
    from asr_dfcnn_transformer_torch.infer import E2EServing, Pipeline
    from asr_dfcnn_transformer_torch.kernels import LAUNCHES, reset_launches
    from asr_dfcnn_transformer_torch.train import factory
    av, lv, ev = (vocab.acoustic_vocab(), vocab.language_vocab(),
                  vocab.e2e_language_vocab())
    rng = np.random.default_rng(SEED + 9)
    utts = [tone_utterance(rng, int(sec * SAMPLE_RATE))
            for sec in SERVED_SECONDS[-MAX_BATCH:]]
    lengths = np.array([len(u) for u in utts], np.int32)
    signals = np.zeros((len(utts), samples_for_frames(BUCKETS[-1])),
                       np.float32)
    for i, u in enumerate(utts):
        signals[i, :len(u)] = u
    counts = {}

    def counted(name, fn):
        torch.cuda.synchronize()
        reset_launches()
        out = fn()
        torch.cuda.synchronize()
        counts[name] = LAUNCHES.get("fused_ffn", 0)
        return out

    def gen():
        return torch.Generator().manual_seed(SEED)

    cfg = ffn_config(torch.bfloat16, "pallas")
    am = factory.build_am_model(cfg, DEVICE, gen())
    lm = factory.build_lm_model(cfg, DEVICE, gen())
    pipe = Pipeline(am, lm, acoustic_vocab=av, language_vocab=lv)
    pny, pny_len, han = counted("AM -> LM batch", lambda: pipe.recognize_batch(
        signals, lengths, BUCKETS[-1]))
    require(han.shape == (MAX_BATCH, LM_MAX_LEN) and int(pny_len.min()) > 0
            and bool(((han >= 0) & (han < lv.size)).all()),
            "fused_ffn: AM -> LM results out of range")
    e2e = factory.build_e2e_model(cfg, DEVICE, gen())
    srv = E2EServing(e2e, ev, feature_dim=E2E_NFILT, lfr_m=E2E_LFR[0],
                     lfr_n=E2E_LFR[1], decode="greedy", max_len=E2E_MAX_LEN)
    ids, lens = counted("e2e greedy batch", lambda: srv.recognize_batch(
        signals, lengths))
    require(ids.shape == (MAX_BATCH, E2E_MAX_LEN)
            and bool(((ids >= 0) & (ids < ev.size)).all()),
            "fused_ffn: e2e ids out of range")
    workdir = tempfile.mkdtemp(prefix="chip_smoke_ffn_")
    try:
        tgen = torch.Generator(device=DEVICE).manual_seed(SEED)
        for name, tr, batch in (
                ("LM step", factory.build_lm_trainer(
                    cfg, os.path.join(workdir, "lm"), DEVICE, gen()),
                 lm_batch(rng, LM_BATCH, LM_LEN, av.size, lv.size)),
                ("e2e step", factory.build_e2e_trainer(
                    cfg, os.path.join(workdir, "e2e"), augment_spec=True,
                    device=DEVICE, generator=gen()),
                 e2e_batch(rng, E2E_BATCH, E2E_BUCKET, E2E_LABELS, ev.size))):
            loss = float(counted(name, lambda: tr.train_step(batch, tgen))[
                "loss"])
            print(f"fused_ffn {name}: loss {loss:.4f}")
            require(np.isfinite(loss), f"fused_ffn {name}: loss not finite")
            require_finite_grads(f"fused_ffn {name}", tr.model)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    want = {"AM -> LM batch": 12, "LM step": 12, "e2e step": 12,
            "e2e greedy batch": len(srv.chunk_ms) * 6 * (1 + E2E_MAX_LEN)}
    print(f"fused_ffn launches: {counts} (required {want})")
    require(counts == want, "fused_ffn: launch counts differ")
    results["fused_ffn"]["launches"] = sum(counts.values())
    compare_ffn_backends(signals, lengths)


def compare_ffn_backends(signals, lengths):
    """Phase 11's f32 comparison of ``fused_ffn="pallas"`` with "einsum"
    (see ``phase_fused_ffn``)."""
    import torch
    from asr_dfcnn_transformer_torch.audio.fbank import (FbankConfig,
                                                         batched_fbank)
    from asr_dfcnn_transformer_torch.audio.lfr import batched_lfr
    from asr_dfcnn_transformer_torch.models import speech_transformer as st
    from asr_dfcnn_transformer_torch.infer.pipeline import pipeline_program
    from asr_dfcnn_transformer_torch.train import factory
    sig = torch.from_numpy(signals).to(DEVICE)
    lens = torch.from_numpy(lengths).to(DEVICE)
    out = {}
    for ffn in ("pallas", "einsum"):
        cfg = ffn_config(torch.float32, ffn)
        models = [build(cfg, DEVICE, torch.Generator().manual_seed(SEED))
                  .eval() for build in (factory.build_am_model,
                                        factory.build_lm_model,
                                        factory.build_e2e_model)]
        am, lm, e2e = models
        margins = []
        with torch.inference_mode():
            pny, pny_len, _ = pipeline_program(
                am, None, sig, lens, BUCKETS[-1], fbank_cfg=FbankConfig(),
                decode="greedy", beam_width=BEAM_WIDTH,
                lm_max_len=LM_MAX_LEN)
            lm_logits = lm(pny.long())
            feats, valid = batched_fbank(sig, lens,
                                         cfg=FbankConfig(nfilt=E2E_NFILT),
                                         out_frames=BUCKETS[-1])
            lfr, lfr_valid = batched_lfr(feats, valid, *E2E_LFR)
            mem, mv = e2e.encode(lfr[..., None], lfr_valid)
            greedy = st._greedy_cached(e2e, mem, mv, E2E_MAX_LEN, margins)
        out[ffn] = (pny.cpu(), pny_len.cpu(), lm_logits.cpu(), mem.cpu(),
                    greedy[0].cpu(), torch.stack(margins, 1).cpu())
    (pny_p, _, lm_p, mem_p, ids_p, _) = out["pallas"]
    (pny_e, len_e, lm_e, mem_e, ids_e, gaps) = out["einsum"]
    require(torch.equal(pny_p, pny_e), "fused_ffn: the AM's pinyin differ")
    top2 = torch.topk(lm_e, 2, dim=-1).values
    pos = torch.arange(lm_e.shape[1])[None, :] < len_e[:, None]
    sure = pos & (top2[..., 0] - top2[..., 1] >= MARGIN)
    bad = int((sure & (lm_p.argmax(-1) != lm_e.argmax(-1))).sum())
    err_lm = float((lm_p - lm_e).abs().max())
    print(f"fused_ffn f32 pallas vs einsum, AM -> LM: LM logits max abs diff "
          f"{err_lm:.3g}; hanzi mismatches {bad} of {int(sure.sum())} "
          f"positions with margin >= {MARGIN} ({int(pos.sum())} valid)")
    require(bad == 0, "fused_ffn: hanzi ids differ from the einsum model's")
    err_mem = float((mem_p - mem_e).abs().max())
    agree = []
    for b in range(ids_e.shape[0]):
        low = torch.nonzero(gaps[b] < MARGIN)
        upto = int(low[0]) if len(low) else E2E_MAX_LEN
        require(torch.equal(ids_p[b, :upto], ids_e[b, :upto]),
                f"fused_ffn: e2e greedy ids of utterance {b} differ from the "
                "einsum model's")
        agree.append(upto)
    print(f"fused_ffn f32 pallas vs einsum, e2e: encoder memory max abs diff "
          f"{err_mem:.3g} (atol {E2E_MEMORY_ATOL}); greedy ids equal over "
          f"the first {agree} steps (margin >= {MARGIN})")
    require(err_mem <= E2E_MEMORY_ATOL, "fused_ffn: e2e memory differs")


def phase_noise(results, clean_am):
    """Phase 12: colored-noise AM training and the matmul inverse FFT."""
    phase_irfft_matmul(results)
    phase_noise_card_vs_cpu()
    phase_noise_training(clean_am)
    phase_noise_data()


def phase_irfft_matmul(results):
    """12a: ``irfft_matmul`` at its docstring's shape, [128, 131,073] ->
    262,144, on seeded half-spectra (real DC and Nyquist bins, as cuFFT's
    C2R assumes). The launch counters are reset before and read after the
    two "pallas" transforms (bf16 and f32 compute): ``interleave_epilogue``
    must run once each. Each "pallas" result is bit-equal to "xla"; each is
    within 0.03 (bf16 compute, the JAX test's bound) or 1e-4 (f32) of the
    peak of ``torch.fft.irfft`` (cuFFT); then the three transforms' times
    (CUDA events)."""
    import torch
    from asr_dfcnn_transformer_torch.kernels import LAUNCHES, reset_launches
    from asr_dfcnn_transformer_torch.ops.matfft import irfft_matmul
    from asr_dfcnn_transformer_torch.timing import cuda_ms
    rng = np.random.default_rng(SEED + 12)
    h = NOISE_N // 2
    sr, si = (torch.from_numpy(rng.standard_normal(
        (NOISE_BATCH, h + 1)).astype(np.float32)).to(DEVICE)
        for _ in range(2))
    si[:, 0] = 0.0
    si[:, h] = 0.0

    def cufft():
        return torch.fft.irfft(torch.complex(sr, si), n=NOISE_N)

    def matfft(cd, epilogue):
        return lambda: irfft_matmul(sr, si, NOISE_N, compute_dtype=cd,
                                    epilogue=epilogue)

    ref = cufft()
    peak = float(ref.abs().max())
    computes = ((torch.bfloat16, 0.03), (torch.float32, 1e-4))
    torch.cuda.synchronize()
    reset_launches()
    pallas = {cd: matfft(cd, "pallas")() for cd, _ in computes}
    torch.cuda.synchronize()
    launches = LAUNCHES.get("interleave_epilogue", 0)
    print(f"irfft_matmul [{NOISE_BATCH}, {h + 1}] -> {NOISE_N}: "
          f"interleave_epilogue launches {launches} (required 2)")
    require(launches == 2, "irfft_matmul(epilogue='pallas') did not run "
            "interleave_epilogue once a call")
    results["interleave_epilogue"]["launches"] = launches
    t_fft = cuda_ms(cufft)
    times = [f"cuFFT (torch.fft.irfft) {t_fft:.4f} ms"]
    for cd, tol in computes:
        xla = matfft(cd, "xla")()
        same = torch.equal(pallas[cd], xla)
        err = float((xla - ref).abs().max()) / peak
        print(f"irfft_matmul {cd}: pallas bit-equal to xla {same}; max abs "
              f"err against cuFFT {err:.3g} of the peak (tol {tol}) "
              f"{'ok' if same and err < tol else 'FAIL'}")
        require(same and err < tol, f"irfft_matmul {cd} disagrees")
        times.append(f"{cd} xla {cuda_ms(matfft(cd, 'xla')):.4f} ms, pallas "
                     f"{cuda_ms(matfft(cd, 'pallas')):.4f} ms")
    print(f"time irfft [{NOISE_BATCH}, {h + 1}] -> {NOISE_N}: "
          + "; ".join(times))


def phase_noise_card_vs_cpu():
    """12b: ``add_noise_from_draws`` on the card and on the CPU on the same
    draws (made on the CPU from a seeded generator): the mixtures within
    1e-5 of each signal's peak, the padding exactly 0 on both. Then one
    small f32 ``AMTrainer(augment_noise=True, augment_spec=True)`` step at
    phase 6's widths on the same weights and the same draws (a CPU
    generator on both sides): the card mixes the noise with its own
    arithmetic (cuFFT), and both steps take fbank and masks on the CPU from
    their own mixtures (phase 6's reason: phase 2 holds the fbank kernels
    to their twins); loss and gradients within phase 6's tolerances."""
    import torch
    from asr_dfcnn_transformer_torch.audio.fbank import samples_for_frames
    from asr_dfcnn_transformer_torch.audio.noise import (
        add_noise_from_draws, noise_draws)
    from asr_dfcnn_transformer_torch.models import SEDFCNN, SEDFCNNConfig
    from asr_dfcnn_transformer_torch.train import AMTrainer
    rng = np.random.default_rng(SEED + 13)
    b, s = 4, samples_for_frames(BUCKETS[0])
    lens = np.array([s, s - 999, s // 2, 4000], np.int32)
    sig = np.zeros((b, s), np.float32)
    for i, m in enumerate(lens):
        sig[i, :m] = tone_utterance(rng, int(m))
    draws = noise_draws(b, s, torch.Generator().manual_seed(SEED))
    cpu = add_noise_from_draws(torch.from_numpy(sig), torch.from_numpy(lens),
                               draws)
    card = add_noise_from_draws(torch.from_numpy(sig).to(DEVICE),
                                torch.from_numpy(lens).to(DEVICE),
                                draws).cpu()
    peak = cpu.abs().amax(dim=1, keepdim=True)
    err = float(((card - cpu).abs() / peak).max())
    pad = torch.arange(s)[None, :] >= torch.from_numpy(lens)[:, None]
    zero = bool((card[pad] == 0).all() and (cpu[pad] == 0).all())
    print(f"add_noise card vs CPU [{b}, {s}]: max abs diff {err:.3g} of each "
          f"signal's peak (tol 1e-5), padding exactly 0: {zero} "
          f"{'ok' if err <= 1e-5 and zero else 'FAIL'}")
    require(err <= 1e-5 and zero, "add_noise differs between card and CPU")

    model = SEDFCNN(SEDFCNNConfig(48, stage_features=(8, 8, 16, 16, 16),
                                  head_features=16, dropout_rate=0.0,
                                  dtype=torch.float32), device="cpu",
                    generator=torch.Generator().manual_seed(SEED))
    batch = am_batch(rng, 4, 128, (8, 12), 48)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_noise_cmp_")
    try:
        out, cpu_tr = {}, None
        for where in ("cpu", DEVICE):
            tr = AMTrainer(copy.deepcopy(model).to(where),
                           os.path.join(workdir, where), augment_noise=True,
                           augment_spec=True)
            if cpu_tr is None:
                cpu_tr = tr
            else:
                tr.features = lambda sig, lens, bucket, masks=None: \
                    cpu_tr.features(sig.cpu(), lens.cpu(), bucket, masks).to(
                        DEVICE)
            loss = float(tr.train_step(
                batch, torch.Generator().manual_seed(SEED))["loss"])
            out[where] = (loss, {n: p.grad.cpu()
                                 for n, p in tr.model.named_parameters()})
        compare_steps("am with noise and SpecAugment", out["cpu"],
                      out[DEVICE])
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def phase_noise_training(clean_am):
    """12c: ``build_am_trainer(Config(), augment_noise=True,
    augment_spec=True)`` at full width, 10 steps on phase 5's batch (16 at
    bucket 1600: the noise at n 262,144 through cuFFT), with train_steps'
    checks; ms/step and peak memory beside phase 5's clean step. Two draws
    of one generator mix different noise and a generator of the same seed
    repeats the first. The launch counters are reset before and read after
    the steps: ``log_mel``, ``cmvn`` and both CTC kernels ran."""
    import torch
    from asr_dfcnn_transformer_torch import vocab
    from asr_dfcnn_transformer_torch.audio.noise import add_noise_from_draws
    from asr_dfcnn_transformer_torch.core.config import Config
    from asr_dfcnn_transformer_torch.kernels import reset_launches
    from asr_dfcnn_transformer_torch.train import factory
    rng = np.random.default_rng(SEED + 3)
    amb = am_batch(rng, AM_BATCH, AM_BUCKET, AM_LABELS,
                   vocab.acoustic_vocab().size)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_noise_")
    try:
        tr = factory.build_am_trainer(
            Config(), os.path.join(workdir, "am"), augment_noise=True,
            augment_spec=True, device=DEVICE,
            generator=torch.Generator().manual_seed(SEED))
        gen = torch.Generator(device=DEVICE).manual_seed(SEED)
        torch.cuda.synchronize()
        reset_launches()
        out = train_steps("am noisy", tr, amb, gen)
        counts = out["launches"]
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(f"am noisy: {out['ms_per_step']:.2f} ms/step, peak "
          f"{out['peak_bytes'] / 2**30:.2f} GiB; phase 5's clean step "
          f"{clean_am['ms_per_step']:.2f} ms/step, peak "
          f"{clean_am['peak_bytes'] / 2**30:.2f} GiB")
    print(f"launch counts on the noisy AM path: {counts}")
    for name in ("log_mel", "cmvn", "ctc_alpha", "ctc_beta_xi"):
        require(counts.get(name, 0) > 0, f"{name} was never launched on the "
                "noisy AM path")
    sig, lens = (torch.from_numpy(a).to(DEVICE)
                 for a in (amb.signals, amb.signal_lengths))

    def mixed(g):
        return add_noise_from_draws(
            sig, lens, tr.augment_draws(*sig.shape, generator=g)[0])
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    first, second = mixed(g), mixed(g)
    again = mixed(torch.Generator(device=DEVICE).manual_seed(SEED + 1))
    differ, repeat = not torch.equal(first, second), torch.equal(first, again)
    print(f"am noisy: two draws mix different noise {differ}, the same seed "
          f"repeats it {repeat}")
    require(differ and repeat, "noise draws do not follow the generator")


def phase_noise_data():
    """12d: the host data path on the card: a synthetic corpus written by
    ``data/synthetic.py`` (24 utterances a split) in a temp dir, a noisy
    copy of each train utterance twice over by ``generate_noise_corpus``
    (the second copies resolve only under ``noise_root``), then one ``fit``
    epoch of the full-width AM with ``augment_noise=True`` on the port's
    ``DataLoader`` batches (clean + noise manifests, batch 8, prefetched),
    with a dev sweep and a checkpoint. The launch counters are reset
    before and read after: ``log_mel``, ``cmvn`` and both CTC kernels
    ran."""
    import torch
    from asr_dfcnn_transformer_torch import vocab
    from asr_dfcnn_transformer_torch.audio.noise_corpus import (
        generate_noise_corpus)
    from asr_dfcnn_transformer_torch.core.config import Config
    from asr_dfcnn_transformer_torch.data import (DataLoader, load_manifests,
                                                  make_synthetic_corpus,
                                                  prefetch)
    from asr_dfcnn_transformer_torch.kernels import LAUNCHES, reset_launches
    from asr_dfcnn_transformer_torch.train import factory
    av, lv = vocab.acoustic_vocab(), vocab.language_vocab()
    workdir = tempfile.mkdtemp(prefix="chip_smoke_data_")
    try:
        data_dir, wav_root, _, _ = make_synthetic_corpus(
            os.path.join(workdir, "corpus"), num_utts=24, num_classes=8,
            seed=SEED)
        clean = load_manifests(data_dir, "train", corpora=("thchs",))
        noise_root = os.path.join(workdir, "noisy")
        n = generate_noise_corpus(clean, wav_root, noise_root, data_dir,
                                  rate=1.0, n_per_utt=2, seed=SEED)
        train = load_manifests(data_dir, "train", corpora=("thchs",),
                               use_noise=True)
        loader = DataLoader(train, av, lv, speech_root=wav_root,
                            noise_root=noise_root)
        from_noise = sum(loader._resolve(p).startswith(noise_root)
                         for p in train.paths)
        print(f"noise corpus: {n} noisy utterances for {len(clean)} clean; "
              f"the loader reads {from_noise} of {len(train)} rows from "
              "the noise root")
        require(n == 2 * len(clean) and from_noise == len(clean),
                "the noise corpus or the noise_root fallback failed")
        dev = DataLoader(load_manifests(data_dir, "dev", corpora=("thchs",)),
                         av, lv, speech_root=wav_root)
        tr = factory.build_am_trainer(
            Config(), os.path.join(workdir, "am"), augment_noise=True,
            device=DEVICE, generator=torch.Generator().manual_seed(SEED))
        gen = torch.Generator(device=DEVICE).manual_seed(SEED)
        torch.cuda.synchronize()
        reset_launches()
        out = tr.fit(lambda: prefetch(loader.am_batches(8, seed=SEED)),
                     lambda: dev.am_batches(8, shuffle=False), epochs=1,
                     generator=gen)
        torch.cuda.synchronize()
        counts = dict(LAUNCHES)
        saved = tr.ckpt.latest_step()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(f"noisy fit on loader batches: {out}, {tr.step} steps, checkpoint "
          f"step {saved}; launch counts {counts}")
    require(saved == 0 and tr.step > 0 and np.isfinite(out["dev_loss"]),
            "the loader-driven noisy fit saved no checkpoint")
    for name in ("log_mel", "cmvn", "ctc_alpha", "ctc_beta_xi"):
        require(counts.get(name, 0) > 0, f"{name} was never launched on the "
                "loader-driven noisy fit")


CLI_SYNTHETIC = "64"        # utterances a split of the CLI's corpus
CLI_KERNELS = {   # what each of phase 13's commands must launch
    "am": ("log_mel", "cmvn", "ctc_alpha", "ctc_beta_xi"),
    "lm": ("masked_attention_drop", "masked_attention_bwd"),
    "eval": ("log_mel", "cmvn", "masked_attention"),
    "eval beam": ("log_mel", "cmvn", "masked_attention", "topk_last",
                  "beam_search"),
    "eval-lm": ("masked_attention",),
    "infer": ("log_mel", "cmvn", "masked_attention"),
    "eval tf1": ("log_mel", "cmvn", "masked_attention"),
    "e2e": E2E_TRAINED,
    "eval-e2e": E2E_SERVED,
    "eval fused_ffn": ("log_mel", "cmvn", "masked_attention", "fused_ffn"),
}


def run_cli(results, label, argv):
    """One CLI command in this process (the kernels built in phase 1 are
    reused), the launch counters reset just before and read just after:
    every kernel ``CLI_KERNELS[label]`` names must have run. Prints the
    command's output and wall time; returns (its stdout, the counts)."""
    import contextlib
    import io

    import torch
    from asr_dfcnn_transformer_torch.kernels import LAUNCHES, reset_launches
    from asr_dfcnn_transformer_torch.train import cli
    out = io.StringIO()
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            cli.main(argv)
        torch.cuda.synchronize()
    finally:
        print(out.getvalue(), end="")
    wall = time.perf_counter() - t0
    counts = dict(LAUNCHES)
    print(f"cli {label}: {wall:.2f} s wall; launch counts {counts}")
    for name in CLI_KERNELS.get(label, ()):
        require(counts.get(name, 0) > 0,
                f"{name} was never launched by the CLI's {label}")
        results[name].setdefault("launches", counts[name])
    return out.getvalue(), counts


def accuracy_lines(text: str):
    return [line for line in text.splitlines()
            if line.startswith("*[Test Result]")]


def pred_log_utterances(path: str):
    """(the pred_log's text, its utterance count), the count held to the
    4 lines an utterance + 2 accuracy lines of an AM -> LM eval."""
    with open(path, encoding="utf-8") as f:
        text = f.read()
    lines = text.splitlines()
    n = sum(line.startswith("原文拼音结果") for line in lines)
    require(n > 0 and len(lines) == 4 * n + 2,
            f"pred_log {path}: {len(lines)} lines for {n} utterances")
    return text, n


def require_finite_losses(workdir: str, name: str):
    """Every loss in ``<name>_metrics.jsonl`` (train and dev) is finite,
    and the checkpoint directory carries its identity stamp."""
    with open(os.path.join(workdir, f"{name}_metrics.jsonl")) as f:
        losses = [json.loads(line)["loss"] for line in f]
    print(f"cli {name}: {len(losses)} logged losses, first {losses[0]:.4g}, "
          f"last {losses[-1]:.4g}")
    require(losses and all(np.isfinite(losses)),
            f"{name}: a logged loss is not finite")
    require(os.path.exists(os.path.join(workdir, f"ckpt_{name}",
                                        "identity.json")),
            f"{name}: no identity stamp beside the checkpoints")


def phase_cli(results):
    """Phase 13: the port's CLI (``train/cli.py`` ``main``) on the card at
    full width, in a temporary workdir with ``--synthetic 64`` (bucket 128):
    train the AM and the LM one epoch each; eval greedy and beam; eval-lm;
    infer one tone wav; export both models as TF1 bundles and eval from
    them (the same parameters bit for bit, so the same accuracy lines and
    pred_log as the greedy eval); the refused ``--model se_dfcnn_pre``;
    e2e one epoch and eval-e2e; eval with a config selecting
    ``fused_ffn="pallas"`` (12 launches a batch). Then small f32 models
    trained by the CLI on the CPU, served through
    ``Pipeline.from_checkpoints`` on both devices over the test batches,
    agree by phase 4's rule."""
    import math

    from asr_dfcnn_transformer_torch.audio.wav import write_wav
    from asr_dfcnn_transformer_torch.core.config import Config, LmConfig
    from asr_dfcnn_transformer_torch.train.factory import config_to_json
    from asr_dfcnn_transformer_torch.train.identity import (
        ModelIdentityError)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    t0 = time.perf_counter()
    try:
        wd = ["--workdir", os.path.join(workdir, "full"), "--synthetic",
              CLI_SYNTHETIC]
        full = wd[1]
        for name in ("am", "lm"):
            run_cli(results, name, [name] + wd + ["--epochs", "1"])
            require_finite_losses(full, name)
        log = os.path.join(full, "pred", "pred_log")
        text, _ = run_cli(results, "eval", ["eval"] + wd)
        greedy = accuracy_lines(text), pred_log_utterances(log)
        require(len(greedy[0]) == 2, "eval printed no accuracy lines")
        text, _ = run_cli(results, "eval beam",
                          ["eval"] + wd + ["--decode", "beam"])
        pred_log_utterances(log)
        require(len(accuracy_lines(text)) == 2, "beam eval printed no "
                "accuracy lines")
        text, _ = run_cli(results, "eval-lm", ["eval-lm"] + wd)
        require(len(accuracy_lines(text)) == 1, "eval-lm printed no "
                "accuracy line")
        wav = os.path.join(workdir, "tone.wav")
        write_wav(wav, tone_utterance(np.random.default_rng(SEED + 13),
                                      int(2.5 * SAMPLE_RATE)))
        text, _ = run_cli(results, "infer", ["infer"] + wd + ["--wav", wav])
        require("拼音:" in text and "汉字:" in text, "infer printed no "
                "result")

        bundles = {w: os.path.join(workdir, "tf1", w) for w in ("am", "lm")}
        for w, prefix in bundles.items():
            run_cli(results, f"export {w}", ["export", "--workdir", full,
                                             "--what", w, "--out", prefix])
        check_bundles_equal_checkpoints(full, bundles)
        text, _ = run_cli(results, "eval tf1", ["eval"] + wd + [
            "--am-tf-ckpt", bundles["am"], "--lm-tf-ckpt", bundles["lm"]])
        from_tf1 = accuracy_lines(text), pred_log_utterances(log)
        print(f"cli eval from the TF1 bundles: accuracy lines "
              f"{'identical' if from_tf1 == greedy else 'DIFFER'} to the "
              f"checkpoint eval's; pred_log of {from_tf1[1][1]} utterances")
        require(from_tf1 == greedy, "the eval from the TF1 bundles differs "
                "from the eval from the checkpoints")

        try:
            run_cli(results, "eval refused",
                    ["eval"] + wd + ["--model", "se_dfcnn_pre"])
        except ModelIdentityError as e:
            print(f"cli eval --model se_dfcnn_pre refused: {e}")
            require("se_first" in str(e), "the refusal does not name "
                    "se_first")
        else:
            raise PhaseError("eval --model se_dfcnn_pre restored an "
                             "se_dfcnn checkpoint")

        run_cli(results, "e2e", ["e2e"] + wd + ["--epochs", "1"])
        require_finite_losses(full, "e2e")
        text, _ = run_cli(results, "eval-e2e", ["eval-e2e"] + wd)
        require(len(accuracy_lines(text)) == 1, "eval-e2e printed no "
                "accuracy line")

        cfg = os.path.join(workdir, "fused_ffn.json")
        with open(cfg, "w", encoding="utf-8") as f:
            f.write(config_to_json(Config(lm=LmConfig(fused_ffn="pallas"))))
        _, counts = run_cli(results, "eval fused_ffn",
                            ["eval"] + wd + ["--config", cfg])
        _, n_utts = pred_log_utterances(log)
        batches = math.ceil(n_utts / Config().am.batch_size)
        n_ffn = counts.get("fused_ffn", 0)
        require(n_ffn == 12 * batches,
                f"fused_ffn launched {n_ffn} times for "
                f"{batches} eval batches of the 12-block LM")
        print(f"cli phase, full width: {time.perf_counter() - t0:.1f} s")
        cli_card_vs_cpu(os.path.join(workdir, "small"))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(f"cli phase: {time.perf_counter() - t0:.1f} s")


def check_bundles_equal_checkpoints(workdir: str, bundles: dict):
    """The TF1 bundles, loaded through ``convert``, hold the latest
    checkpoints' parameters (what the CLI's eval restores) bit for bit."""
    import torch
    from asr_dfcnn_transformer_torch import vocab
    from asr_dfcnn_transformer_torch.convert import (am_state_dict,
                                                     lm_state_dict)
    from asr_dfcnn_transformer_torch.infer.tf_ckpt import (load_tf1_lm,
                                                           load_tf1_sedfcnn)
    from asr_dfcnn_transformer_torch.train import CheckpointManager
    av, lv = vocab.acoustic_vocab(), vocab.language_vocab()
    loaded = {"am": am_state_dict(load_tf1_sedfcnn(bundles["am"], av.size)),
              "lm": lm_state_dict(load_tf1_lm(bundles["lm"], av.size,
                                              lv.size))}
    for what, sd in loaded.items():
        ckpt = CheckpointManager(os.path.join(
            workdir, f"ckpt_{what}")).restore_latest()["model"]
        differ = [k for k in ckpt
                  if k not in sd or not torch.equal(ckpt[k], sd[k])]
        print(f"cli export {what}: {len(sd)} tensors, "
              f"{len(ckpt) - len(differ)} of {len(ckpt)} equal to the "
              "checkpoint's bit for bit")
        require(not differ and set(sd) == set(ckpt),
                f"export {what}: tensors differ from the checkpoint: "
                f"{differ[:5]}")


def cli_card_vs_cpu(workdir: str):
    """13, last step: ``--small`` f32 AM and LM trained one epoch each by
    the CLI on the CPU, loaded with ``Pipeline.from_checkpoints`` on the
    CPU and on the card; over the test batches the frame argmax and the
    hanzi argmax agree wherever the CPU's margin >= 1e-3 (phase 4's rule),
    and where every margin is that high the two pipelines' ids are
    equal."""
    import argparse

    import torch
    from asr_dfcnn_transformer_torch import vocab
    from asr_dfcnn_transformer_torch.core.config import Config
    from asr_dfcnn_transformer_torch.data import DataLoader, load_manifests
    from asr_dfcnn_transformer_torch.infer import Pipeline
    from asr_dfcnn_transformer_torch.train import cli
    wd = ["--workdir", workdir, "--synthetic", CLI_SYNTHETIC, "--small",
          "--platform", "cpu"]
    for name in ("am", "lm"):
        run_cli({}, f"small {name} (cpu)", [name] + wd + ["--epochs", "1"])
        require_finite_losses(workdir, name)
    av, lv = vocab.acoustic_vocab(), vocab.language_vocab()
    pipes = []
    for dev in ("cpu", DEVICE):
        args = argparse.Namespace(small=True, device=torch.device(dev),
                                  cfg=Config(), seed=SEED)
        pipes.append(Pipeline.from_checkpoints(
            workdir, cli._am_model(args, "se_dfcnn", av.size),
            cli._lm_model(args, av.size, lv.size), acoustic_vocab=av,
            language_vocab=lv))
    syn = os.path.join(workdir, "synthetic")
    test = DataLoader(load_manifests(os.path.join(syn, "data"), "test",
                                     corpora=("thchs",)), av, lv,
                      speech_root=os.path.join(syn, "wav"),
                      bucket_bounds=(128,))
    n_sure = 0
    for i, b in enumerate(test.am_batches(16, shuffle=False)):
        _, _, sure = check_am_lm_agreement(
            f"cli small checkpoints card vs CPU, batch {i}",
            (pipes[0].am_model, pipes[0].lm_model),
            (pipes[1].am_model, pipes[1].lm_model),
            b.signals, b.signal_lengths, b.bucket_frames)
        if sure:
            n_sure += 1
            outs = [p.recognize_batch(b.signals, b.signal_lengths,
                                      b.bucket_frames) for p in pipes]
            require(all(np.array_equal(c, g) for c, g in zip(*outs)),
                    f"batch {i}: the pipelines' ids differ with every "
                    "margin >= 1e-3")
    print(f"cli small checkpoints: {n_sure} batches with every margin >= "
          "1e-3 gave equal pipeline ids on both devices")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bf16 products sum wholly in f32 on cuBLAS, as in the kernels and the
    # JAX package (the fused_ffn twin is held to the kernel bit for bit)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    results = {name: {"name": name, "route": "cuda", "source": src,
                      "replaces": rep}
               for name, (src, rep) in KERNELS.items()}
    phase_device()
    phase_kernels(results)
    phase_served(results)
    phase_card_vs_cpu()
    clean_am = phase_training(results)
    phase_train_card_vs_cpu()
    phase_e2e_served(results)
    phase_e2e_card_vs_cpu()
    phase_e2e_training(results)
    phase_e2e_train_card_vs_cpu()
    phase_fused_ffn(results)
    phase_noise(results, clean_am)
    phase_cli(results)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                  for r in results.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
