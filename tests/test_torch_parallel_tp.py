"""The port's tensor parallelism (``parallel/tensor.py``) against the JAX
package's tensor-parallel LM step.

Two processes of a gloo group on the CPU (``tests/_torch_parallel_worker.py``,
a ``file://`` store, bounded waits) take one ``LMTrainer`` step on (data 1,
model 2), the LM and batch of tests/test_distributed.py on weights the
port initialises, against JAX's ``LMTrainer`` with ``param_shardings(...,
tensor_parallel=True)`` on ``make_mesh(1, 2)``; then save and restore its
checkpoint, and take the step again through the ``fused_ffn`` kernel's
twin. Four processes take a (data 2, model 2) step. The JAX reference and
the port's one-process steps run while the workers work.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_dfcnn_transformer_tpu.data.loader import LMBatch as JaxLMBatch
from asr_dfcnn_transformer_tpu.models import TransformerLM as JaxLM
from asr_dfcnn_transformer_tpu.parallel import make_mesh as jax_make_mesh
from asr_dfcnn_transformer_tpu.parallel import (
    param_shardings as jax_param_shardings,
)
from asr_dfcnn_transformer_tpu.train import LMTrainer as JaxLMTrainer
from asr_dfcnn_transformer_torch import models
from asr_dfcnn_transformer_torch.convert import (flax_to_state_dict,
                                                 state_dict_to_flax)
from asr_dfcnn_transformer_torch.data import LMBatch
from asr_dfcnn_transformer_torch.parallel import Mesh
from asr_dfcnn_transformer_torch.parallel.tensor import shard_model
from asr_dfcnn_transformer_torch.train import LMTrainer
from tests._torch_cpu import use_two_threads
from tests._torch_parallel_common import (CPU, LM_CFG, adam_keeping_grads,
                                          join, lm_batch, load, np_tree,
                                          spawn)

use_two_threads()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel_tp")
    lm = models.TransformerLM(models.TransformerLMConfig(**LM_CFG),
                              device="cpu",
                              generator=torch.Generator().manual_seed(1))
    batch = lm_batch()
    inputs = dict(lm_cfg=LM_CFG, lm_sd=lm.state_dict(), lm_batch=batch)
    path = str(tmp / "inputs.pt")
    torch.save(inputs, path)
    out2, procs2 = spawn(2, ("tp_lm",), tmp, path)
    out4, procs4 = spawn(4, ("dp_tp_lm",), tmp, path)

    # JAX: the tensor-parallel step on (1, 2), from the bridged weights
    mesh = jax_make_mesh(1, 2, jax.devices()[:2])
    jlm = JaxLMTrainer(JaxLM(**dict(LM_CFG, dtype=jnp.float32)),
                       str(tmp / "jax_lm"), mesh=mesh)
    jlm.tx = adam_keeping_grads(jlm.schedule)
    jlm.state = jlm._make_state(jax.tree.map(
        jnp.asarray, state_dict_to_flax(lm.state_dict(), "lm")))
    params = jlm.state.params
    params = jax.device_put(params, jax_param_shardings(
        mesh, params, tensor_parallel=True))
    jlm.state = jlm.state.replace(params=params,
                                  opt_state=jlm.tx.init(params))
    loss = float(jlm.train_step(JaxLMBatch(**batch),
                                jax.random.PRNGKey(1))["loss"])
    want = dict(loss=loss,
                grads=flax_to_state_dict(
                    {"params": np_tree(jlm.state.opt_state[1])}),
                params=flax_to_state_dict({"params": np_tree(
                    jlm.state.params)}))

    # the port's one-process steps (plain FFN; the fused_ffn twin)
    def one_process(gen=None, **kw):
        m = models.TransformerLM(models.TransformerLMConfig(
            **dict(LM_CFG, **kw)), device="cpu")
        m.load_state_dict(lm.state_dict())
        tr = LMTrainer(m, str(tmp / f"one{kw}"))
        return float(tr.train_step(LMBatch(**batch), gen)["loss"])

    single = dict(lm=one_process(), pallas=one_process(fused_ffn="pallas"),
                  dropout=one_process(torch.Generator().manual_seed(3),
                                      dropout_rate=0.5))
    join(procs2)
    join(procs4)
    return dict(tp=load(out2, "tp_lm", 2), dp_tp=load(out4, "dp_tp_lm", 4),
                want=want, single=single, inputs=inputs, out=out2)


def test_tp_lm_step_matches_jax_tp_step(runs):
    """Loss at rtol 1e-5; the gathered gradients within 1e-4 relative plus
    1e-5 of the largest gradient entry, as the data-parallel AM step holds
    them (Adam's first update is about lr * sign(g), so only the gradients
    show a scale error of the column / row split operators); the gathered
    parameters after the Adam step at 1e-6 where JAX's gradient is far
    above its rounding, and within the rate elsewhere (the update of a
    rounding-noise gradient is any value in [-lr, lr] in either
    package)."""
    want, ranks = runs["want"], runs["tp"]
    full = ranks[0]["full"]
    assert set(full) == set(want["params"])
    scale = max(float(g.abs().max()) for g in want["grads"].values())
    for got in ranks:
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        assert set(got["grads"]) == set(want["grads"])
        for name, g in got["grads"].items():
            np.testing.assert_allclose(g.numpy(), want["grads"][name].numpy(),
                                       rtol=1e-4, atol=1e-5 * scale,
                                       err_msg=name)
    for name, p in full.items():
        p0 = runs["inputs"]["lm_sd"][name].numpy()
        sure = np.abs(want["grads"][name].numpy()) > 1e-4
        np.testing.assert_allclose(p.numpy()[sure],
                                   want["params"][name].numpy()[sure],
                                   rtol=1e-6, atol=1e-6, err_msg=name)
        assert np.all(np.abs(p.numpy() - p0) <= 5e-5 * (1 + 1e-5) + 1e-7)
    for a, b in zip(full.values(), ranks[1]["full"].values()):
        assert torch.equal(a, b)


def test_tp_ranks_hold_the_named_shards(runs):
    whole = dict(runs["inputs"]["lm_sd"])
    for r, got in enumerate(runs["tp"]):
        split = [n for n, a in got["specs"].items() if a is not None]
        assert "block0_0_attn.q.weight" in split and \
            "token_embed.embedding" in split and "output.weight" in split
        for name, axis in got["specs"].items():
            shape = list(whole[name].shape)
            if axis is not None:
                shape[axis] //= 2
                # this rank's shard of the stepped whole model
                np.testing.assert_array_equal(
                    got["params"][name].numpy(),
                    got["full"][name].chunk(2, axis)[r].numpy())
            assert list(got["shapes"][name]) == shape, name


def test_tp_checkpoint_restores_in_one_process(runs):
    ranks = runs["tp"]
    assert all(g["restored_equal"] and g["restored_step"] == 1
               for g in ranks)
    lm = models.TransformerLM(models.TransformerLMConfig(**LM_CFG),
                              device="cpu")
    tr = LMTrainer(lm, str(runs["out"] / "tp_lm"))
    assert tr.restore_or_init() == 1
    for name, p in lm.state_dict().items():
        assert torch.equal(p, ranks[0]["full"][name]), name
    # the optimizer's moments are whole too: one more step runs
    assert np.isfinite(float(tr.train_step(
        LMBatch(**runs["inputs"]["lm_batch"]))["loss"]))


def test_tp_fused_ffn_step_matches_one_process(runs):
    for got in runs["tp"]:
        np.testing.assert_allclose(got["pallas_loss"],
                                   runs["single"]["pallas"], rtol=1e-5)


def test_tp_dropout_step_matches_one_process(runs):
    """With one data rank every model rank draws the whole layer's keep
    masks from the same generator and keeps its heads', so a step with
    dropout 0.5 is the one-process step."""
    for got in runs["tp"]:
        assert got["dropout_loss"] != runs["single"]["lm"]
        np.testing.assert_allclose(got["dropout_loss"],
                                   runs["single"]["dropout"], rtol=1e-5)


def test_dp_tp_four_process_lm_step_matches_one_process(runs):
    losses = [g["loss"] for g in runs["dp_tp"]]
    assert len(set(losses)) == 1
    np.testing.assert_allclose(losses[0], runs["single"]["lm"], rtol=1e-5)


def test_shard_model_refuses_heads_that_do_not_divide():
    """A split of q / k / v into halves of 3 heads' width is JAX's rule
    (the width divides); the port runs whole heads only, and refuses."""
    lm = models.TransformerLM(models.TransformerLMConfig(
        **dict(LM_CFG, num_heads=3, d_model=48)), device="cpu")
    with pytest.raises(ValueError, match="3 heads do not divide"):
        shard_model(lm, Mesh({"data": 1, "model": 2}, CPU))
