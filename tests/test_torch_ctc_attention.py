"""The port's ``CTCAttention`` and ``AttenTrainer`` against the JAX
package's: the logits and both length rules of a small f32 model on
bridged weights (convert.py), the attention maps, one train step (loss,
every gradient, the BatchNorm statistics) and one eval step, the identity
stamp, and the epoch loop's checkpoints and best gate."""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_dfcnn_transformer_tpu.data.loader import AMBatch as JaxAMBatch
from asr_dfcnn_transformer_tpu.models import CTCAttention as JaxCTCAttention
from asr_dfcnn_transformer_tpu.parallel import make_mesh
from asr_dfcnn_transformer_tpu.train import identity as jax_identity
from asr_dfcnn_transformer_tpu.train.trainer import (
    AttenTrainer as JaxAttenTrainer)
from asr_dfcnn_transformer_tpu.utils import attention_maps as jax_maps
from asr_dfcnn_transformer_torch.convert import (atten_state_dict,
                                                 flax_to_state_dict)
from asr_dfcnn_transformer_torch.data import AMBatch
from asr_dfcnn_transformer_torch.models import (CTCAttention,
                                                CTCAttentionConfig)
from asr_dfcnn_transformer_torch.train import AttenTrainer, identity
from asr_dfcnn_transformer_torch.utils import attention_maps
from tests._torch_cpu import use_two_threads
from tests.test_torch_train import _grab_tx, _np, _perturb

use_two_threads()

VOCAB, NFILT, BUCKET = 64, 40, 200
KW = dict(d_model=32, num_heads=4, num_blocks=2, dropout_rate=0.0)


@functools.lru_cache(maxsize=None)
def _variables(seed=1):
    """Perturbed Flax variables of the small model, once a module (both
    length rules share them)."""
    flax_m = JaxCTCAttention(VOCAB, dtype=jnp.float32, **KW)
    x = np.zeros((2, 66, 4 * NFILT, 1), np.float32)
    return _perturb(jax.jit(flax_m.init)(jax.random.PRNGKey(0),
                                         jnp.asarray(x)), seed)


def _pair(seed=1, **over):
    """(Flax module, perturbed variables, a fresh port model on them)."""
    kw = dict(KW, **over)
    flax_m = JaxCTCAttention(VOCAB, dtype=jnp.float32, **kw)
    variables = _variables(seed)
    m = CTCAttention(CTCAttentionConfig(VOCAB, dtype=torch.float32, **kw),
                     feature_dim=4 * NFILT, device="cpu")
    m.load_state_dict(atten_state_dict(variables), strict=True)
    return flax_m, variables, m


def _lfr(seed=2, b=3, t=66):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, 4 * NFILT, 1)).astype(np.float32)
    valid = np.array([t, 41, 9][:b], np.int32)
    return x, valid


@pytest.mark.parametrize("parity_lengths", [False, True])
def test_logits_and_lengths_match_jax(parity_lengths):
    flax_m, variables, m = _pair(parity_lengths=parity_lengths)
    x, valid = _lfr()
    want, want_len = jax.jit(flax_m.apply)(variables, jnp.asarray(x),
                                           jnp.asarray(valid))
    m.eval()
    with torch.no_grad():
        got, got_len = m(torch.from_numpy(x), torch.from_numpy(valid))
    assert got.shape == (3, 8, VOCAB)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    _, none_len = m(torch.from_numpy(x))
    assert none_len.tolist() == [8, 8, 8]


def test_attention_maps_match_jax():
    flax_m, variables, m = _pair()
    x, valid = _lfr(4)
    want = jax.jit(lambda v, *a: jax_maps(flax_m, v, *a, train=False))(
        variables, jnp.asarray(x), jnp.asarray(valid))
    m.eval()
    got = attention_maps(m, torch.from_numpy(x), torch.from_numpy(valid))
    assert set(got) == set(want) == {"block_0_attn", "block_1_attn"}
    for k in want:
        assert got[k].shape == (3, 4, 8, 8)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


def _batch(seed=0, b=4):
    rng = np.random.default_rng(seed)
    n = (BUCKET - 1) * 160 + 400
    lens = np.array([n, 24000, 16000, 30000][:b], np.int32)
    t = np.arange(n) / 16000.0
    sig = np.zeros((b, n), np.float32)
    for i, m in enumerate(lens):
        sig[i, :m] = (0.3 * np.sin(2 * np.pi * rng.uniform(150, 400)
                                   * t[:m])
                      + 0.01 * rng.standard_normal(m))
    frames = (1 + np.ceil((lens - 400) / 160)).astype(np.int32)
    hanzi = np.zeros((b, 4), np.int32)
    hz_len = np.array([3, 2, 1, 4][:b], np.int32)
    for i, m in enumerate(hz_len):
        hanzi[i, :m] = rng.integers(1, VOCAB - 1, m)
    weights = np.ones(b, np.float32)
    weights[-1] = 0.0
    return dict(signals=sig, signal_lengths=lens, frame_lengths=frames,
                pinyin=hanzi.copy(), pinyin_lengths=hz_len.copy(),
                hanzi=hanzi, hanzi_lengths=hz_len, weights=weights,
                bucket_frames=BUCKET)


@pytest.fixture(scope="module")
def jax_trainer(tmp_path_factory):
    """The JAX AttenTrainer both cases share (its jitted steps compile
    once), its optimizer swapped for one that keeps the gradients."""
    flax_m = JaxCTCAttention(VOCAB, dtype=jnp.float32, **KW)
    jtr = JaxAttenTrainer(flax_m, str(tmp_path_factory.mktemp("jax")),
                          lr=7e-4, feature_dim=NFILT,
                          mesh=make_mesh(1, 1, jax.devices()[:1]))
    jtr.tx = _grab_tx()
    jtr._train_step = jtr._build_train_step()
    return jtr, jax.jit(jtr._features, static_argnums=2)


@pytest.mark.parametrize("padded", [True, False])
def test_train_and_eval_step_match_jax(tmp_path, monkeypatch, padded,
                                       jax_trainer):
    """The loss, the eval step, the BatchNorm statistics and the gradients,
    on a batch with padded utterances and on one without.

    The three max-pooled conv cells' gradients are held by their norm:
    a 2x2 window whose two largest entries lie within rounding of each
    other (27 windows within 1e-6 of a tie on the unpadded batch; padded
    LFR rows, zero, give rows constant in time) sends its gradient to
    whichever entry each package's last bit makes the larger, a valid
    subgradient either way, and a few such windows move those cells'
    gradients by up to ~3e-3 of their norm. Every parameter after the
    last pooled cell is held element by element."""
    arrays = _batch()
    if not padded:
        arrays["signal_lengths"][:] = arrays["signals"].shape[1]
        arrays["frame_lengths"][:] = BUCKET
    jbatch = JaxAMBatch(**arrays)
    jtr, features = jax_trainer
    feats, valid = features(jnp.asarray(arrays["signals"]),
                            jnp.asarray(arrays["signal_lengths"]), BUCKET)
    variables = _variables()   # no parameter's shape depends on T
    jtr.state = jtr._make_state(jax.tree.map(jnp.asarray, variables))
    want_eval = jtr.eval_step(jbatch)
    want = jtr.train_step(jbatch, jax.random.PRNGKey(1))

    # both trainers see the JAX features (the port's fbank is held to the
    # JAX one in test_torch_fbank.py)
    m = CTCAttention(CTCAttentionConfig(VOCAB, dtype=torch.float32, **KW),
                     feature_dim=4 * NFILT, device="cpu")
    m.load_state_dict(atten_state_dict(variables), strict=True)
    tr = AttenTrainer(m, str(tmp_path / "port"), lr=7e-4,
                      feature_dim=NFILT)
    monkeypatch.setattr(tr, "features", lambda *a: (
        torch.from_numpy(np.array(feats)),
        torch.from_numpy(np.array(valid))))
    got_eval = tr.eval_step(AMBatch(**arrays))
    for key in ("loss", "ler", "weight"):
        np.testing.assert_allclose(float(got_eval[key]),
                                   float(want_eval[key]), rtol=1e-5,
                                   err_msg=key)
    got = tr.train_step(AMBatch(**arrays))
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(got["lr"], float(want["lr"]), rtol=1e-6)
    grads = flax_to_state_dict({"params": _np(jtr.state.opt_state["g"])})
    params = dict(m.named_parameters())
    assert set(params) == set(grads)
    # 1e-4 relative, and 1e-4 of the parameter's own largest gradient
    # entry absolute: f32 sums in another order through the train-mode
    # BatchNorms
    pooled = tuple(f"ConvBnCell_{i}." for i in range(3))
    for name, p in params.items():
        got, want = p.grad.numpy(), grads[name].numpy()
        assert np.isfinite(got).all(), name
        if name.startswith(pooled):
            err = np.linalg.norm(got - want) / np.linalg.norm(want)
            assert err < 1e-2, (name, err)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-4,
                                       atol=1e-4 * np.abs(want).max(),
                                       err_msg=name)
    stats = flax_to_state_dict({"batch_stats": _np(jtr.state.batch_stats)})
    buffers = dict(m.named_buffers())
    for name, want_stat in stats.items():
        np.testing.assert_allclose(buffers[name].numpy(), want_stat.numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_fit_saves_and_gates_on_wer(tmp_path):
    train = [AMBatch(**_batch(s)) for s in (0, 1)]
    dev = [AMBatch(**_batch(2))]
    _, _, m = _pair()
    tr = AttenTrainer(m, str(tmp_path), lr=1e-3, feature_dim=NFILT)
    assert tr.restore_or_init() == 0
    out = tr.fit(lambda: iter(train), lambda: iter(dev), epochs=2)
    assert out["epoch"] == 1 and tr.step == 4
    assert tr.ckpt.latest_step() == 1
    assert tr.ckpt.best_metric() <= out["dev_wer"]
    with open(os.path.join(str(tmp_path), "ckpt_atten",
                           "identity.json")) as f:
        assert json.load(f)["class"] == "CTCAttention"
    assert os.path.exists(os.path.join(str(tmp_path),
                                       "atten_metrics.jsonl"))


def test_identity_stamp_matches_jax(tmp_path):
    flax_m = JaxCTCAttention(6345, num_blocks=1, parity_lengths=True)
    m = CTCAttention(CTCAttentionConfig(6345, num_blocks=1,
                                        parity_lengths=True), device="cpu")
    jax_identity.write_identity(str(tmp_path / "j"), flax_m)
    identity.write_identity(str(tmp_path / "p"), m)
    want = (tmp_path / "j" / "identity.json").read_bytes()
    assert (tmp_path / "p" / "identity.json").read_bytes() == want
    assert json.loads(want)["class"] == "CTCAttention"


def test_cli_atten_and_eval_atten(tmp_path, capsys):
    """``atten`` trains the JAX CLI's small model (its checkpoint stamped
    as JAX stamps it), ``eval-atten`` prints the JAX CLI's accuracy line."""
    from asr_dfcnn_transformer_tpu.models import CTCAttention as JaxModel
    from asr_dfcnn_transformer_torch.train import cli
    wd = str(tmp_path / "wd")
    small = ["--synthetic", "16", "--small", "--batch-size", "8",
             "--platform", "cpu"]
    cli.main(["atten", "--workdir", wd, "--epochs", "1", "--lr", "1e-3"]
             + small)
    assert "ctc-attention training done" in capsys.readouterr().out
    jax_identity.write_identity(
        str(tmp_path / "j"), JaxModel(6345, d_model=32, num_heads=4,
                                      num_blocks=1, dropout_rate=0.0,
                                      dtype=jnp.float32))
    assert (tmp_path / "wd" / "ckpt_atten" / "identity.json").read_bytes() \
        == (tmp_path / "j" / "identity.json").read_bytes()
    cli.main(["eval-atten", "--workdir", wd] + small)
    out = capsys.readouterr().out
    assert "*[Test Result] atten 汉字 word accuracy ratio: " in out
    assert "utts)" in out
    with pytest.raises(SystemExit, match="no CTC-attention checkpoint"):
        cli.main(["eval-atten", "--workdir", str(tmp_path / "none")] + small)
