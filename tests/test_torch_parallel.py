"""The port's data parallelism (``parallel/``) against the JAX package's
meshed step.

Two real processes form a gloo group on the CPU through a ``file://``
store (``tests/_torch_parallel_worker.py``; every wait has a limit, and the
group is destroyed at the end). On weights the port initialises and
convert.py bridges to Flax they run a data-parallel ``AMTrainer`` step on
(data 2, model 1), the global batch and tiny SE-DFCNN of
tests/test_distributed.py, against JAX's ``AMTrainer(mesh=make_mesh(2,
1))`` on conftest's virtual devices; then a meshed ``Pipeline``, a
BatchNorm with global statistics and a non-finite loss on one rank's rows.
The workers start first and the JAX reference runs while they work. The
JAX trainer's optimizer is Adam that also keeps the step's gradients in
its state, so gradients and updated parameters are both compared.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_dfcnn_transformer_tpu.audio import batched_fbank as jax_fbank
from asr_dfcnn_transformer_tpu.audio.fbank import FbankConfig as JaxFbankCfg
from asr_dfcnn_transformer_tpu.data.loader import AMBatch as JaxAMBatch
from asr_dfcnn_transformer_tpu.models import SEDFCNN as JaxSEDFCNN
from asr_dfcnn_transformer_tpu.parallel import make_mesh as jax_make_mesh
from asr_dfcnn_transformer_tpu.parallel import (
    param_shardings as jax_param_shardings,
)
from asr_dfcnn_transformer_tpu.train import AMTrainer as JaxAMTrainer
from asr_dfcnn_transformer_torch import models
from asr_dfcnn_transformer_torch.convert import (flax_leaf,
                                                 flax_to_state_dict,
                                                 state_dict_to_flax)
from asr_dfcnn_transformer_torch.data import AMBatch
from asr_dfcnn_transformer_torch.models.layers import BatchNorm
from asr_dfcnn_transformer_torch.parallel import (Mesh, param_shardings,
                                                  shard_batch)
from asr_dfcnn_transformer_torch.train import AMTrainer
from tests._torch_cpu import use_two_threads
from tests._torch_parallel_common import (AM_CFG, BUCKET, CPU, LM_CFG,
                                          adam_keeping_grads, am_batch, join,
                                          load, np_tree, spawn)

use_two_threads()

SCENARIOS = ("dp_am", "pipeline", "batchnorm", "nan_abort")
LR = 7e-4           # AMTrainer's default rate, the step's Adam rate


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel")
    am = models.SEDFCNN(models.SEDFCNNConfig(**AM_CFG), device="cpu",
                        generator=torch.Generator().manual_seed(0))
    lm = models.TransformerLM(models.TransformerLMConfig(**LM_CFG),
                              device="cpu",
                              generator=torch.Generator().manual_seed(1))
    batch = am_batch()
    feats, _ = jax_fbank(jnp.asarray(batch["signals"]),
                         jnp.asarray(batch["signal_lengths"]),
                         cfg=JaxFbankCfg(nfilt=200), out_frames=BUCKET)
    rng = np.random.default_rng(2)
    pipe_sig = (0.3 * rng.standard_normal((3, (BUCKET - 1) * 160 + 400))
                ).astype(np.float32)
    inputs = dict(
        am_cfg=AM_CFG, lm_cfg=LM_CFG, am_sd=am.state_dict(),
        lm_sd=lm.state_dict(), am_batch=batch, am_feats=np.array(feats),
        pipe_signals=pipe_sig,
        pipe_lengths=np.array([pipe_sig.shape[1], 9000, 5000], np.int32),
        bn_x=rng.standard_normal((4, 3, 5, 6)).astype(np.float32),
        bn_r=rng.standard_normal((4, 3, 5, 6)).astype(np.float32))
    path = str(tmp / "inputs.pt")
    torch.save(inputs, path)
    out, procs = spawn(2, SCENARIOS, tmp, path)

    # JAX: the data-parallel step on (2, 1), from the bridged variables
    jam = JaxAMTrainer(JaxSEDFCNN(**dict(AM_CFG, dtype=jnp.float32)),
                       str(tmp / "jax_am"),
                       mesh=jax_make_mesh(2, 1, jax.devices()[:2]))
    jam.tx = adam_keeping_grads(jam.schedule)
    jam.state = jam._make_state(jax.tree.map(
        jnp.asarray, state_dict_to_flax(am.state_dict(), "am")))
    loss = float(jam.train_step(JaxAMBatch(**batch),
                                jax.random.PRNGKey(1))["loss"])
    want = dict(loss=loss,
                grads=flax_to_state_dict(
                    {"params": np_tree(jam.state.opt_state[1])}),
                params=flax_to_state_dict(
                    {"params": np_tree(jam.state.params),
                     "batch_stats": np_tree(jam.state.batch_stats)}))

    # the port's one-process step on the whole batch
    one = models.SEDFCNN(models.SEDFCNNConfig(**AM_CFG), device="cpu")
    one.load_state_dict(am.state_dict())
    tr = AMTrainer(one, str(tmp / "one"), feature_dim=200)
    tr.features = lambda *a, **k: torch.from_numpy(np.array(feats))[:, None]
    tr.train_step(AMBatch(**batch))
    join(procs)
    res = {n: load(out, n, 2) for n in SCENARIOS}
    return dict(res=res, want=want, inputs=inputs, one=one)


def test_param_shardings_match_jax_rules():
    """JAX's own test tree (tests/test_sharding.py), carried across by the
    bridge: the port splits the port axis that holds JAX's split axis."""
    z = np.zeros
    tree = {"block0_0_attn": {"q": {"kernel": z((64, 64))},
                              "out": {"kernel": z((64, 64))}},
            "block0_0_ffn": {"Dense_0": {"kernel": z((64, 256))},
                             "Dense_1": {"kernel": z((256, 64))}},
            "output": {"kernel": z((64, 128)), "bias": z((128,))},
            "odd": {"kernel": z((64, 63))},
            "token_embed": {"embedding": z((64, 32))}}
    sd = flax_to_state_dict({"params": tree})
    jmesh = jax_make_mesh(4, 2)
    for tp in (True, False):
        want = jax_param_shardings(jmesh, jax.tree.map(jnp.asarray, tree),
                                   tensor_parallel=tp)
        got = param_shardings(Mesh({"data": 4, "model": 2}, CPU), sd,
                              tensor_parallel=tp)
        assert set(got) == set(sd)
        for name, t in sd.items():
            _, path, axes = flax_leaf(name, t.dim())
            node = want
            for part in path.split("/"):
                node = node[part]
            spec = tuple(node.spec)
            axis = axes[spec.index("model")] if "model" in spec else None
            assert got[name] == axis, (name, spec, got[name])
    got = param_shardings(Mesh({"data": 4, "model": 2}, CPU), sd, True)
    assert got["block0_0_attn.q.weight"] == 0          # columns
    assert got["block0_0_attn.out.weight"] == 1        # rows
    assert got["output.weight"] == 0 and got["output.bias"] is None
    assert got["odd.weight"] is None
    one = param_shardings(Mesh({"data": 8, "model": 1}, CPU), sd, True)
    assert all(a is None for a in one.values())


def test_shard_batch_cuts_rows_and_refuses_ragged():
    arrays = am_batch(4)
    b = AMBatch(**arrays)
    mesh = Mesh({"data": 2, "model": 2}, CPU, data_rank=1, model_rank=1)
    got = shard_batch(mesh, b)
    np.testing.assert_array_equal(got.signals, arrays["signals"][2:])
    assert got.bucket_frames == BUCKET
    x, y = shard_batch(mesh, (np.arange(6), torch.arange(6)))
    assert list(x) == [3, 4, 5] and y.tolist() == [3, 4, 5]
    assert shard_batch(Mesh({"data": 1, "model": 2}, CPU), b) is b
    with pytest.raises(ValueError, match="global batch 3 must divide "
                                         "process count 2"):
        shard_batch(mesh, (np.zeros((3, 2)),))


def test_dp_am_step_matches_jax_meshed_step(runs):
    """Loss at rtol 1e-5. Gradients (summed over the ranks) within 1e-4
    relative plus 1e-5 of the model's largest gradient entry: they reach
    ~12 here (loss ~62), and f32 sums in another order leave differences
    of a few 1e-6 of that scale wherever the gradient is small, in the
    port's one-process step as in the two-process one (both are held).
    Adam's first update is lr * g / (|g| + eps): where the gradient is far
    above its rounding the parameters agree to 1e-6; where it is rounding
    noise (the BatchNorm biases that a following BatchNorm cancels,
    gradient 0 in exact arithmetic) the update is any value in [-lr, lr] in
    either package, so those entries are held to that range. The running
    statistics at 1e-6."""
    want, ranks = runs["want"], runs["res"]["dp_am"]
    one = dict(runs["one"].named_parameters())
    scale = max(float(g.abs().max()) for g in want["grads"].values())
    for got in ranks:
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        for name, g in got["grads"].items():
            ref = want["grads"][name].numpy()
            for mine in (g.numpy(), one[name].grad.numpy()):
                np.testing.assert_allclose(mine, ref, rtol=1e-4,
                                           atol=1e-5 * scale, err_msg=name)
            p0 = runs["inputs"]["am_sd"][name].numpy()
            p1, p1_jax = got["params"][name].numpy(), \
                want["params"][name].numpy()
            sure = np.abs(ref) > 1e-3
            np.testing.assert_allclose(p1[sure], p1_jax[sure], rtol=1e-6,
                                       atol=1e-6, err_msg=name)
            assert np.all(np.abs(p1 - p0) <= LR * (1 + 1e-5) + 1e-7), name
        stats = {k: v for k, v in got["params"].items() if "running" in k}
        assert len(stats) == 2 * 16      # 11 cells' and 5 SE blocks' BNs
        for name, s in stats.items():
            np.testing.assert_allclose(s.numpy(),
                                       want["params"][name].numpy(),
                                       rtol=1e-6, atol=1e-6, err_msg=name)
    for a, b in zip(ranks[0]["params"].values(), ranks[1]["params"].values()):
        assert torch.equal(a, b)


def test_meshed_pipeline_matches_single(runs):
    for got in runs["res"]["pipeline"]:
        for a, b in zip(got["meshed"], got["single"]):
            assert a.shape[0] == 3
            np.testing.assert_array_equal(a, b)


def test_batchnorm_global_statistics(runs):
    x = torch.from_numpy(runs["inputs"]["bn_x"]).requires_grad_(True)
    r = torch.from_numpy(runs["inputs"]["bn_r"])
    bn = BatchNorm(3, dtype=torch.float32, device="cpu")
    bn.train()
    y = bn(x)
    (y * r).sum().backward()
    ranks = runs["res"]["batchnorm"]
    got_y = torch.cat([g["y"] for g in ranks])
    got_gx = torch.cat([g["x_grad"] for g in ranks])
    np.testing.assert_allclose(got_y.numpy(), y.detach().numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_gx.numpy(), x.grad.numpy(), rtol=1e-4,
                               atol=1e-6)
    for key, want in (("w_grad", bn.weight.grad), ("b_grad", bn.bias.grad)):
        np.testing.assert_allclose(sum(g[key] for g in ranks).numpy(),
                                   want.numpy(), rtol=1e-5, atol=1e-6)
    for key, want in (("mean", bn.running_mean), ("var", bn.running_var)):
        assert torch.equal(ranks[0][key], ranks[1][key])
        np.testing.assert_allclose(ranks[0][key].numpy(), want.numpy(),
                                   rtol=1e-6, atol=1e-7)


def test_nan_on_one_rank_aborts_every_rank(runs):
    # the guard's limit is five consecutive non-finite losses
    assert [g["aborted_at"] for g in runs["res"]["nan_abort"]] == [4, 4]
