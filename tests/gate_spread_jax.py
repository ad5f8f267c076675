"""The e2e gate's spread over initial weights on the CPU, for the JAX
package and for the port from the same initial weights: a reference for
``asr_dfcnn_transformer_torch.gate_spread``. Not a test; run it from the
repository's root:

    python -m tests.gate_spread_jax --keys 0,1,2,3 [--which jax,port]

For each ``jax.random.PRNGKey(key)``, "jax" runs the JAX package's gate
(``tests/test_synthetic_e2e_gate.py``: the same corpus, model, 900 steps
and scoring, at that key in place of 0), and "port" runs
``gates.e2e_gate`` on the CPU from the JAX model's initial weights at that
key, bridged with ``convert.e2e_state_dict``. One JSON line a run.
"""

import os

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                           " --xla_force_host_platform_device_count=8")

import argparse  # noqa: E402
import json  # noqa: E402
import tempfile  # noqa: E402

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from asr_dfcnn_transformer_torch import gates  # noqa: E402
from asr_dfcnn_transformer_torch.convert import e2e_state_dict  # noqa: E402
from asr_dfcnn_transformer_tpu import models  # noqa: E402
from asr_dfcnn_transformer_tpu.core import vocab  # noqa: E402
from asr_dfcnn_transformer_tpu.data import (DataLoader,  # noqa: E402
                                            load_manifests,
                                            make_synthetic_corpus)
from asr_dfcnn_transformer_tpu.ops.edit_distance import (  # noqa: E402
    edit_distance)
from asr_dfcnn_transformer_tpu.parallel import make_mesh  # noqa: E402
from asr_dfcnn_transformer_tpu.train import E2ETrainer  # noqa: E402


def jax_gate(root: str, key: int):
    """(the JAX gate's numbers, its initial variables) at ``key``."""
    data_dir, wav_root, _, _ = make_synthetic_corpus(
        os.path.join(root, "corpus"), num_utts=144, num_classes=4,
        syllables_per_utt=(2, 4), tone_ms=250, seed=42)
    av, lv = vocab.acoustic_vocab(), vocab.language_vocab()

    def mk(mode):
        return DataLoader(load_manifests(data_dir, mode, corpora=("thchs",)),
                          av, lv, speech_root=wav_root, bucket_bounds=(128,))

    train_dl, test_dl = mk("train"), mk("test")
    model = models.SpeechTransformer(lv.size, d_model=64, num_heads=4,
                                     num_enc_blocks=2, num_dec_blocks=2,
                                     prenet_channels=16, dropout_rate=0.0,
                                     dtype=jnp.float32)
    tr = E2ETrainer(model, os.path.join(root, "work"), lr=2e-3,
                    feature_dim=40, mesh=make_mesh(8, 1))
    batches = list(train_dl.am_batches(8, shuffle=False))
    state = tr.init_state(jax.random.PRNGKey(key), batches[0])
    init = {"params": jax.tree.map(np.asarray, state.params)}
    if state.batch_stats:
        init["batch_stats"] = jax.tree.map(np.asarray, state.batch_stats)
    tr.restore_or_init(lambda: state)
    rng, accs = jax.random.PRNGKey(1), []
    for step in range(900):
        rng, sub = jax.random.split(rng)
        m = tr.train_step(batches[step % len(batches)], sub)
        accs.append(float(m["acc"]))
    variables = {"params": tr.state.params}
    if tr.state.batch_stats:
        variables["batch_stats"] = tr.state.batch_stats
    err = tot = n = 0
    for batch in test_dl.am_batches(8, shuffle=False):
        feats, valid = tr._features(jnp.asarray(batch.signals),
                                    jnp.asarray(batch.signal_lengths),
                                    batch.bucket_frames)
        ids, lens = models.greedy_decode_cached(model, variables, feats,
                                                valid)
        ids, lens = np.asarray(ids), np.asarray(lens)
        for j in range(ids.shape[0]):
            if batch.weights[j] == 0:
                continue
            n += 1
            gt = list(batch.hanzi[j][: batch.hanzi_lengths[j]])
            err += min(edit_distance(gt, list(ids[j][: lens[j]])), len(gt))
            tot += len(gt)
    last = accs[-len(batches):]
    out = {"teacher_forced": accs[-1], "hanzi": 1.0 - err / max(tot, 1),
           "utterances": n, "last_epoch_acc": float(np.mean(last)),
           "last_epoch_min": float(np.min(last))}
    return out, init


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--keys", default="0,1,2,3")
    ap.add_argument("--which", default="jax,port")
    ap.add_argument("--threads", type=int, default=2)
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)
    which = args.which.split(",")
    for key in [int(k) for k in args.keys.split(",")]:
        with tempfile.TemporaryDirectory(prefix="gate_spread_jax_") as d:
            out, init = jax_gate(d, key)
            if "jax" in which:
                print(json.dumps({"key": key, "run": "jax", **out,
                                  "misses": gates.e2e_misses(out)}),
                      flush=True)
            if "port" in which:
                port = gates.e2e_gate(os.path.join(d, "port"), "cpu",
                                      initial_state=e2e_state_dict(init))
                keep = ("teacher_forced", "hanzi", "utterances",
                        "last_epoch_acc", "last_epoch_min")
                print(json.dumps({"key": key, "run": "port from the jax init",
                                  **{k: port[k] for k in keep},
                                  "misses": gates.e2e_misses(port)}),
                      flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
