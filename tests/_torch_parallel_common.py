"""Shared set-up of the port's multi-process CPU tests
(tests/test_torch_parallel.py, tests/test_torch_parallel_tp.py): the tiny
models and global batches of tests/test_distributed.py, the JAX optimizer
that keeps a step's gradients, and the worker processes
(tests/_torch_parallel_worker.py) with bounded waits."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_parallel_worker.py")
CPU = torch.device("cpu")
AM_CFG = dict(vocab_size=64, stage_features=(4, 4, 8, 8, 8),
              se_ratio=(1, 2, 2, 2, 2), head_features=8, dropout_rate=0.0,
              dtype=torch.float32)
LM_CFG = dict(input_vocab_size=64, output_vocab_size=128, d_model=64,
              num_heads=4, num_blocks=2, dropout_rate=0.0,
              parity_attention=False, dtype=torch.float32)
BUCKET = 128


def am_batch(b=2):
    """tests/test_distributed.py's global batch."""
    s = (BUCKET - 1) * 160 + 400
    sig = np.random.default_rng(0).standard_normal((b, s)).astype(np.float32)
    return dict(signals=sig, signal_lengths=np.full((b,), s, np.int32),
                frame_lengths=np.full((b,), BUCKET, np.int32),
                pinyin=np.tile(np.array([[3, 4, 5] + [0] * 61], np.int32),
                               (b, 1)),
                pinyin_lengths=np.full((b,), 3, np.int32),
                hanzi=np.tile(np.array([[6, 7, 8] + [0] * 61], np.int32),
                              (b, 1)),
                hanzi_lengths=np.full((b,), 3, np.int32),
                weights=np.ones((b,), np.float32), bucket_frames=BUCKET)


def lm_batch(b=4):
    """tests/test_distributed.py's LM batch, with a back-filled row."""
    return dict(pinyin=np.tile(np.array([[3, 4, 5, 6, 0, 0, 0, 0]], np.int32),
                               (b, 1)),
                hanzi=np.tile(np.array([[7, 8, 9, 10, 0, 0, 0, 0]], np.int32),
                              (b, 1)),
                lengths=np.full((b,), 4, np.int32),
                weights=np.array([1, 1, 1, 0][:b], np.float32))


def adam_keeping_grads(schedule):
    """optax.adam(schedule) whose state also holds the step's gradients."""
    adam = optax.adam(schedule)

    def update(grads, state, params=None):
        updates, adam_state = adam.update(grads, state[0], params)
        return updates, (adam_state, grads)

    return optax.GradientTransformation(
        init=lambda p: (adam.init(p), jax.tree.map(jnp.zeros_like, p)),
        update=update)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def spawn(world, scenarios, tmp, inputs):
    """Start ``world`` worker processes on ``scenarios``; returns (their
    output directory, the processes)."""
    out = tmp / f"out{world}"
    out.mkdir()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    store = str(tmp / f"store{world}")
    return out, [subprocess.Popen(
        [sys.executable, WORKER, str(r), str(world), store, inputs, str(out),
         *scenarios], env=env, cwd=str(tmp), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]


def join(procs, timeout=240):
    """Wait for every worker (at most ``timeout`` seconds each), kill any
    left, and fail with the output of one that failed."""
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]




def load(out, name, world):
    return [torch.load(str(out / f"{name}_{r}.pt"), weights_only=False)
            for r in range(world)]
