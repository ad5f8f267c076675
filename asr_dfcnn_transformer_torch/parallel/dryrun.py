"""The multi-process dry run: the port's counterpart of the JAX package's
``dryrun_multichip`` (``__graft_entry__.py:61-210``), at the same sizes.

``dryrun_multichip(n, device)`` spawns ``n`` processes (one per rank, a
``file://`` store in a temporary directory, every wait bounded) that run:

  (a) a data-parallel SE-DFCNN CTC step over an (n, 1) mesh;
  (b) a tensor-parallel Transformer LM step over (n / 2, 2) (n odd:
      (n, 1));
  (c) a data-parallel CTC-attention step;
  (d) a data-parallel joint AM -> LM step;
  (e) a data-parallel e2e speech-Transformer step;
  (f) a meshed ``Pipeline`` whose ids, lengths and hanzi equal the
      single-process pipeline's, bit for bit.

Rank 0 prints one line in the JAX function's shape. The backend is
``parallel.backend_for`` the device and ``n`` (NCCL where every rank has a
card of its own, else gloo), and is printed. Run it as ``python -m
asr_dfcnn_transformer_torch.parallel.dryrun --processes 2 [--device cpu]``.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _batches(b: int):
    from asr_dfcnn_transformer_torch.data.batches import AMBatch, LMBatch
    bucket = 128
    s = (bucket - 1) * 160 + 400
    sig = np.random.default_rng(0).standard_normal((b, s)).astype(np.float32)
    am = AMBatch(
        signals=sig, signal_lengths=np.full((b,), s, np.int32),
        frame_lengths=np.full((b,), bucket, np.int32),
        pinyin=np.tile(np.array([[3, 4, 5] + [0] * 61], np.int32), (b, 1)),
        pinyin_lengths=np.full((b,), 3, np.int32),
        hanzi=np.tile(np.array([[6, 7, 8] + [0] * 61], np.int32), (b, 1)),
        hanzi_lengths=np.full((b,), 3, np.int32),
        weights=np.ones((b,), np.float32), bucket_frames=bucket)

    def lm(rows):
        return LMBatch(
            pinyin=np.tile(np.array([[3, 4, 5, 6, 0, 0, 0, 0]], np.int32),
                           (rows, 1)),
            hanzi=np.tile(np.array([[7, 8, 9, 10, 0, 0, 0, 0]], np.int32),
                          (rows, 1)),
            lengths=np.full((rows,), 4, np.int32),
            weights=np.ones((rows,), np.float32))
    return am, lm


def run_steps(n: int, device: torch.device, workdir: str) -> str:
    """Steps (a)-(f) in a process of an initialised group of ``n``; returns
    the summary line."""
    from asr_dfcnn_transformer_torch import models
    from asr_dfcnn_transformer_torch.core import vocab as vocab_mod
    from asr_dfcnn_transformer_torch.infer import Pipeline
    from asr_dfcnn_transformer_torch.parallel import make_mesh
    from asr_dfcnn_transformer_torch.train import (AMTrainer, AttenTrainer,
                                                   E2ETrainer, JointTrainer,
                                                   LMTrainer)
    f32 = torch.float32

    def gen(seed):
        return torch.Generator(device=device).manual_seed(seed)

    def init(seed):
        return torch.Generator().manual_seed(seed)

    batch, lm_batch = _batches(n)
    kw = dict(device=device)
    # (a) data-parallel SE-DFCNN CTC step over the whole mesh
    mesh_dp = make_mesh(n, 1, device)
    am = models.SEDFCNN(models.SEDFCNNConfig(
        64, stage_features=(4, 4, 8, 8, 8), se_ratio=(1, 2, 2, 2, 2),
        head_features=8, dropout_rate=0.0, dtype=f32), generator=init(0),
        **kw)
    tr = AMTrainer(am, workdir + "/am", mesh=mesh_dp)
    tr.restore_or_init()
    ma = float(tr.train_step(batch, gen(1))["loss"])
    # (b) tensor (+ data) parallel Transformer LM step
    mp = 2 if n % 2 == 0 else 1
    lm = models.TransformerLM(models.TransformerLMConfig(
        64, 128, d_model=64, num_heads=4, num_blocks=2, dropout_rate=0.0,
        parity_attention=False, dtype=f32), generator=init(0), **kw)
    lt = LMTrainer(lm, workdir + "/lm", mesh=make_mesh(n // mp, mp, device))
    lt.restore_or_init()
    mlm = float(lt.train_step(lm_batch(n // mp * 2), gen(2))["loss"])
    # (c) data-parallel CTC-attention step
    atten = models.CTCAttention(models.CTCAttentionConfig(
        64, d_model=32, bottleneck=8, num_heads=4, num_blocks=1,
        dropout_rate=0.0, dtype=f32), feature_dim=4 * 40,
        generator=init(0), **kw)
    at = AttenTrainer(atten, workdir + "/atten", feature_dim=40,
                      mesh=mesh_dp)
    at.restore_or_init()
    mat = float(at.train_step(batch, gen(3))["loss"])
    # (d) data-parallel joint AM + LM step
    joint = models.AMLMJoint(models.AMLMJointConfig(64, 128, small=True,
                                                    dtype=f32),
                             generator=init(0), **kw)
    jt = JointTrainer(joint, workdir + "/joint", mesh=mesh_dp)
    jt.restore_or_init()
    mj = float(jt.train_step(batch, gen(4))["loss"])
    # (e) data-parallel end-to-end speech-Transformer step
    e2e = models.SpeechTransformer(models.SpeechTransformerConfig(
        32, d_model=32, num_heads=4, num_enc_blocks=1, num_dec_blocks=1,
        prenet_channels=8, dropout_rate=0.0, dtype=f32),
        feature_dim=4 * 40, generator=init(0), **kw)
    et = E2ETrainer(e2e, workdir + "/e2e", feature_dim=40, mesh=mesh_dp)
    et.restore_or_init()
    me = float(et.train_step(batch, gen(5))["loss"])
    for name, v in (("am", ma), ("lm", mlm), ("atten", mat), ("joint", mj),
                    ("e2e", me)):
        if not np.isfinite(v):
            raise RuntimeError(f"dry run: the {name} step's loss is {v}")
    # (f) the meshed Pipeline == the single-process one
    lm_small = models.TransformerLM(models.TransformerLMConfig(
        64, 128, d_model=32, num_heads=4, num_blocks=1, dropout_rate=0.0,
        dtype=f32), generator=init(0), **kw)
    pkw = dict(acoustic_vocab=vocab_mod.acoustic_vocab(), decode="greedy")
    sharded = Pipeline(am, lm_small, mesh=mesh_dp, **pkw)
    single = Pipeline(am, lm_small, **pkw)
    args = (batch.signals, batch.signal_lengths, batch.bucket_frames)
    for a, b in zip(sharded.recognize_batch(*args),
                    single.recognize_batch(*args)):
        if not np.array_equal(a, b):
            raise RuntimeError("dry run: the meshed Pipeline's outputs "
                               "differ from the single-process ones")
    return (f"dryrun_multichip({n}): am dp loss={ma:.3f}, "
            f"lm tp loss={mlm:.3f}, atten dp loss={mat:.3f}, "
            f"joint dp loss={mj:.3f}, e2e dp loss={me:.3f}, "
            f"sharded-pipeline outputs == single-device")


def dryrun_multichip(n: int, device="cuda", timeout: float = 600.0) -> str:
    """Run steps (a)-(f) in ``n`` fresh processes; returns rank 0's line
    (also printed). Raises when a process fails or outlives ``timeout``
    seconds."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [_ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                   if p])
    with tempfile.TemporaryDirectory(prefix="dryrun_") as tmp:
        cmd = [sys.executable, "-m", "asr_dfcnn_transformer_torch.parallel."
               "dryrun", "--worker", "--processes", str(n), "--device",
               str(device), "--store",
               os.path.join(tmp, "store"), "--workdir", tmp,
               "--timeout", str(timeout)]
        procs = [subprocess.Popen(cmd + ["--rank", str(r)], env=env,
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for r in range(n)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=timeout)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        bad = [r for r, p in enumerate(procs) if p.returncode != 0]
        if bad:
            raise RuntimeError(f"dry run: rank(s) {bad} failed:\n" +
                               "\n".join(outs[r][-3000:] for r in bad))
    line = [ln for ln in outs[0].splitlines()
            if ln.startswith("dryrun_multichip")][-1]
    print(line, flush=True)
    return line


def _worker(args) -> None:
    from asr_dfcnn_transformer_torch.parallel import destroy, init_distributed
    device = init_distributed(
        torch.device(args.device) if args.device != "cuda" else None,
        init_method="file://" + args.store,
        world_size=args.processes, rank=args.rank, timeout=args.timeout)
    try:
        line = run_steps(args.processes, device,
                         os.path.join(args.workdir, f"rank{args.rank}"))
        if args.rank == 0:
            print(line, flush=True)
    finally:
        destroy()


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="dryrun")
    p.add_argument("--processes", type=int, default=2)
    p.add_argument("--device", default="cuda")
    p.add_argument("--timeout", type=float, default=600.0)
    p.add_argument("--worker", action="store_true")
    p.add_argument("--rank", type=int, default=0)
    p.add_argument("--store", default=None)
    p.add_argument("--workdir", default=None)
    args = p.parse_args(argv)
    if args.worker:
        _worker(args)
    else:
        dryrun_multichip(args.processes, args.device, args.timeout)


if __name__ == "__main__":
    main()
