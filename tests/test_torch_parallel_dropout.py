"""Dropout under data parallelism: a meshed step draws every dropout mask
for the global batch and keeps its rows (``models.layers.data_rows``), as
JAX's one ``dropout`` rng serves the global batch under ``pjit``, so a
data-parallel step with dropout is the one-process step.

Two real processes (and four, for ``data 2 x model 2``) form gloo groups
on the CPU through ``file://`` stores (``tests/_torch_parallel_worker.py``;
every wait has a limit). They take an ``LMTrainer`` step at dropout 0.5,
an ``AMTrainer`` step at 0.3 with noise and SpecAugment, and an
``E2ETrainer`` step at 0.1 with SpecAugment, each from the same seeded
generator as the one-process step that this process takes while they
work. The losses agree at rtol 1e-5 and the summed gradients by
``test_dp_am_step_matches_jax_meshed_step``'s rule. A process-free case
holds ``keep_mask`` under the context to rows of the one-process draw,
and to today's draw without it.
"""

import numpy as np
import pytest
import torch

from asr_dfcnn_transformer_torch import models
from asr_dfcnn_transformer_torch.core import vocab
from asr_dfcnn_transformer_torch.data import AMBatch, LMBatch
from asr_dfcnn_transformer_torch.models.layers import (Dropout,
                                                       MultiHeadAttention,
                                                       Split, data_rows,
                                                       keep_mask)
from asr_dfcnn_transformer_torch.train import (AMTrainer, E2ETrainer,
                                               LMTrainer)
from tests._torch_cpu import use_two_threads
from tests._torch_parallel_common import (AM_CFG, LM_CFG, am_batch, join,
                                          lm_batch, load, spawn)

use_two_threads()

TWO = ("dp_lm_drop", "dp_am_drop", "dp_e2e_drop")
FOUR = ("dp_tp_lm_drop",)
DROP_SEED = 11
E2E_NFILT = 40
E2E_CFG = dict(d_model=32, num_heads=4, num_enc_blocks=1, num_dec_blocks=1,
               prenet_channels=8, dropout_rate=0.1, dtype=torch.float32)


def _grads(tr):
    return {n: p.grad.clone() for n, p in tr.model.named_parameters()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel_dropout")
    am = models.SEDFCNN(models.SEDFCNNConfig(**AM_CFG), device="cpu",
                        generator=torch.Generator().manual_seed(0))
    lm = models.TransformerLM(models.TransformerLMConfig(**LM_CFG),
                              device="cpu",
                              generator=torch.Generator().manual_seed(1))
    ev_size = vocab.e2e_language_vocab().size
    e2e_cfg = dict(E2E_CFG, vocab_size=ev_size)
    e2e = models.SpeechTransformer(
        models.SpeechTransformerConfig(**e2e_cfg),
        feature_dim=4 * E2E_NFILT, device="cpu",
        generator=torch.Generator().manual_seed(2))
    am_drop = am_batch(4)
    inputs = dict(am_cfg=AM_CFG, lm_cfg=LM_CFG, am_sd=am.state_dict(),
                  lm_sd=lm.state_dict(), e2e_cfg=e2e_cfg,
                  e2e_sd=e2e.state_dict(), e2e_nfilt=E2E_NFILT,
                  lm_batch=lm_batch(), am_drop_batch=am_drop,
                  drop_seed=DROP_SEED)
    path = str(tmp / "inputs.pt")
    torch.save(inputs, path)
    out2, procs2 = spawn(2, TWO, tmp, path)
    out4, procs4 = spawn(4, FOUR, tmp, path)
    try:
        # the one-process steps on the whole batches while the ranks work
        gen = lambda: torch.Generator().manual_seed(DROP_SEED)  # noqa
        single = {}
        lm1 = models.TransformerLM(models.TransformerLMConfig(
            **dict(LM_CFG, dropout_rate=0.5)), device="cpu")
        lm1.load_state_dict(lm.state_dict())
        tr = LMTrainer(lm1, str(tmp / "lm1"))
        m = tr.train_step(LMBatch(**inputs["lm_batch"]), gen())
        single["lm"] = float(m["loss"]), _grads(tr)
        lm0 = LMTrainer(models.TransformerLM(models.TransformerLMConfig(
            **LM_CFG), device="cpu"), str(tmp / "lm0"))
        lm0.model.load_state_dict(lm.state_dict())
        single["lm_no_dropout"] = float(lm0.train_step(
            LMBatch(**inputs["lm_batch"]), gen())["loss"])
        am1 = models.SEDFCNN(models.SEDFCNNConfig(
            **dict(AM_CFG, dropout_rate=0.3)), device="cpu")
        am1.load_state_dict(am.state_dict())
        tr = AMTrainer(am1, str(tmp / "am1"), feature_dim=200,
                       augment_noise=True, augment_spec=True)
        m = tr.train_step(AMBatch(**am_drop), gen())
        single["am"] = float(m["loss"]), _grads(tr)
        e2e1 = models.SpeechTransformer(
            models.SpeechTransformerConfig(**e2e_cfg),
            feature_dim=4 * E2E_NFILT, device="cpu")
        e2e1.load_state_dict(e2e.state_dict())
        tr = E2ETrainer(e2e1, str(tmp / "e2e1"), feature_dim=E2E_NFILT,
                        augment_spec=True)
        m = tr.train_step(AMBatch(**am_drop), gen())
        single["e2e"] = float(m["loss"]), _grads(tr)
    finally:
        join(procs2)
        join(procs4)
    res = {n: load(out2, n, 2) for n in TWO}
    res.update({n: load(out4, n, 4) for n in FOUR})
    return res, single


def _hold(ranks, want):
    """Every rank's loss at rtol 1e-5 and summed gradients within 1e-4
    relative plus 1e-5 of the largest gradient entry (the data-parallel AM
    test's rule)."""
    loss, grads = want
    scale = max(float(g.abs().max()) for g in grads.values())
    for got in ranks:
        np.testing.assert_allclose(got["loss"], loss, rtol=1e-5)
        assert set(got["grads"]) == set(grads)
        for name, g in got["grads"].items():
            np.testing.assert_allclose(g.numpy(), grads[name].numpy(),
                                       rtol=1e-4, atol=1e-5 * scale,
                                       err_msg=name)


def test_dp_lm_dropout_step_matches_one_process(runs):
    res, single = runs
    assert single["lm"][0] != single["lm_no_dropout"]
    _hold(res["dp_lm_drop"], single["lm"])


def test_dp_am_dropout_step_matches_one_process(runs):
    """Dropout 0.3 after the noise and the SpecAugment masks, all drawn
    for the global batch from one generator."""
    res, single = runs
    _hold(res["dp_am_drop"], single["am"])


def test_dp_e2e_dropout_step_matches_one_process(runs):
    res, single = runs
    _hold(res["dp_e2e_drop"], single["e2e"])


def test_dp_tp_lm_dropout_step_matches_one_process(runs):
    """data 2 x model 2: each rank keeps its rows, then its heads."""
    res, single = runs
    _hold(res["dp_tp_lm_drop"], single["lm"])


def _gen(seed=4):
    return torch.Generator().manual_seed(seed)


def test_keep_mask_under_data_rows_is_rows_of_the_global_draw():
    """keep_mask, Dropout and the attention's head-split _keep on rank r
    of 2 give exactly rows r of the one-process draw; without the context
    keep_mask is today's draw, ``torch.rand(shape) < keep_prob``."""
    kp, shape = 0.7, (3, 5, 7)
    whole = keep_mask((6, 5, 7), kp, "cpu", _gen())
    assert torch.equal(
        keep_mask(shape, kp, "cpu", _gen()),
        torch.rand(shape, generator=_gen()) < kp)
    x = torch.randn(6, 5, 8, generator=_gen(9))
    drop = Dropout(0.3).train()
    out = drop(x, _gen())
    mha = MultiHeadAttention(16, 4, dropout_rate=0.5, dtype=torch.float32,
                             device="cpu", generator=_gen(1))
    heads = {}
    for m in range(2):
        mha.split = Split(None, m, 2)
        heads[m] = mha._keep(6, 5, 5, "cpu", _gen())
    mha.split = None
    all_heads = mha._keep(6, 5, 5, "cpu", _gen())
    assert torch.equal(torch.cat([heads[0], heads[1]], 1), all_heads)
    for r in range(2):
        rows = slice(3 * r, 3 * r + 3)
        with data_rows(r, 2):
            assert torch.equal(keep_mask(shape, kp, "cpu", _gen()),
                               whole[rows])
            assert torch.equal(drop(x[rows], _gen()), out[rows])
            for m in range(2):
                mha.split = Split(None, m, 2)
                got = mha._keep(3, 5, 5, "cpu", _gen())
                assert got.is_contiguous()
                assert torch.equal(got, heads[m][rows])
            mha.split = None
    # the context ends with its block
    assert torch.equal(keep_mask(shape, kp, "cpu", _gen()), whole[:3])
