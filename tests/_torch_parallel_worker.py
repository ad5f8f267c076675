"""One rank of the port's multi-process CPU tests
(tests/test_torch_parallel.py, tests/test_torch_parallel_tp.py,
tests/test_torch_parallel_dropout.py):

    python tests/_torch_parallel_worker.py RANK WORLD STORE INPUTS OUTDIR \
        SCENARIO...

Joins a gloo group through the ``file://`` STORE (every wait bounded),
runs the named scenarios on the inputs that the test wrote to INPUTS, and
saves each scenario's results as OUTDIR/<scenario>_<rank>.pt. It imports
torch and the port, and nothing of JAX.
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from asr_dfcnn_transformer_torch import models  # noqa: E402
from asr_dfcnn_transformer_torch.data import AMBatch, LMBatch  # noqa: E402
from asr_dfcnn_transformer_torch.infer import Pipeline  # noqa: E402
from asr_dfcnn_transformer_torch.models.layers import BatchNorm  # noqa: E402
from asr_dfcnn_transformer_torch.parallel import (destroy,  # noqa: E402
                                                  init_distributed,
                                                  make_mesh,
                                                  param_shardings)
from asr_dfcnn_transformer_torch.parallel import tensor as tp  # noqa: E402
from asr_dfcnn_transformer_torch.train import (AMTrainer,  # noqa: E402
                                               E2ETrainer, LMTrainer)

CPU = torch.device("cpu")


def am_model(inputs, **kw):
    am = models.SEDFCNN(models.SEDFCNNConfig(**dict(inputs["am_cfg"], **kw)),
                        device="cpu")
    am.load_state_dict(inputs["am_sd"])
    return am


def lm_model(inputs, **kw):
    lm = models.TransformerLM(models.TransformerLMConfig(
        **dict(inputs["lm_cfg"], **kw)), device="cpu")
    lm.load_state_dict(inputs["lm_sd"])
    return lm


def dp_am(inputs, mesh, out, workdir):
    """One AMTrainer step on (data 2, model 1), the JAX features of this
    rank's rows in place of the fbank."""
    tr = AMTrainer(am_model(inputs), workdir, feature_dim=200, mesh=mesh)
    feats = torch.from_numpy(inputs["am_feats"])
    rows = tr._rows(feats)
    tr.features = lambda *a, **k: rows[:, None]
    m = tr.train_step(AMBatch(**inputs["am_batch"]))
    out.update(loss=float(m["loss"]),
               grads={n: p.grad.clone() for n, p in
                      tr.model.named_parameters()},
               params={k: v.clone() for k, v in
                       tr.model.state_dict().items()})


def tp_lm(inputs, mesh, out, workdir):
    """One LMTrainer step on (data 1, model 2): the shards each rank holds,
    its loss, its gradients with the shards gathered, its parameters after
    the step, then the checkpoint the step saves and a tensor-parallel
    restore of it."""
    tr = LMTrainer(lm_model(inputs), workdir, mesh=mesh)
    tr.restore_or_init()
    specs = param_shardings(mesh, lm_model(inputs).named_parameters(),
                            tensor_parallel=True)
    out["specs"] = specs
    out["shapes"] = {n: tuple(p.shape) for n, p in
                     tr.model.named_parameters()}
    m = tr.train_step(LMBatch(**inputs["lm_batch"]))
    out["loss"] = float(m["loss"])
    out["grads"] = tp.full_state(
        {n: p.grad for n, p in tr.model.named_parameters()}, {"state": {}},
        tr.shards, mesh)[0]
    out["params"] = {k: v.clone() for k, v in tr.model.state_dict().items()}
    tr.save(0)
    out["full"] = tr.state_dict()["model"]
    again = LMTrainer(lm_model(inputs), workdir, mesh=mesh)
    again.restore_or_init()
    out["restored_equal"] = all(
        torch.equal(a, b) for a, b in zip(tr.model.state_dict().values(),
                                          again.model.state_dict().values()))
    out["restored_step"] = again.step
    # the same step through the fused_ffn kernel's twin, zero b2 per rank
    pal = LMTrainer(lm_model(inputs, fused_ffn="pallas"), workdir + "_pal",
                    mesh=mesh)
    out["pallas_loss"] = float(
        pal.train_step(LMBatch(**inputs["lm_batch"]))["loss"])
    # dropout 0.5: each rank cuts its heads from the whole layer's masks
    drop = LMTrainer(lm_model(inputs, dropout_rate=0.5), workdir + "_drop",
                     mesh=mesh)
    out["dropout_loss"] = float(drop.train_step(
        LMBatch(**inputs["lm_batch"]),
        torch.Generator().manual_seed(3))["loss"])


def dp_tp_lm(inputs, mesh, out, workdir):
    tr = LMTrainer(lm_model(inputs), workdir, mesh=mesh)
    out["loss"] = float(tr.train_step(LMBatch(**inputs["lm_batch"]))["loss"])


def pipeline(inputs, mesh, out, workdir):
    from asr_dfcnn_transformer_torch.core import vocab
    kw = dict(acoustic_vocab=vocab.acoustic_vocab(), decode="greedy")
    am, lm = am_model(inputs), lm_model(inputs)
    sig, lens = inputs["pipe_signals"], inputs["pipe_lengths"]
    out["meshed"] = Pipeline(am, lm, mesh=mesh, **kw).recognize_batch(
        sig, lens, 128)
    out["single"] = Pipeline(am, lm, **kw).recognize_batch(sig, lens, 128)


def batchnorm(inputs, mesh, out, workdir):
    """Training-mode BatchNorm over this rank's rows with global
    statistics: outputs, input and parameter gradients, running stats."""
    bn = BatchNorm(3, dtype=torch.float32, device="cpu")
    bn.group = mesh.data_group
    bn.train()
    x = torch.from_numpy(inputs["bn_x"])
    r = torch.from_numpy(inputs["bn_r"])
    x, r = (t.chunk(2)[mesh.data_rank].clone() for t in (x, r))
    x.requires_grad_(True)
    y = bn(x)
    (y * r).sum().backward()
    out.update(y=y.detach(), x_grad=x.grad, w_grad=bn.weight.grad,
               b_grad=bn.bias.grad, mean=bn.running_mean.clone(),
               var=bn.running_var.clone())


def nan_abort(inputs, mesh, out, workdir):
    """Rank 1's rows hold NaNs: the summed loss is NaN on every rank, and
    the guard aborts every rank at the same step."""
    tr = AMTrainer(am_model(inputs), workdir, feature_dim=200, mesh=mesh)
    arrays = dict(inputs["am_batch"])
    sig = arrays["signals"].copy()
    sig[1] = np.nan
    arrays["signals"] = sig
    for i in range(10):
        loss = float(tr.train_step(AMBatch(**arrays))["loss"])
        try:
            tr.nan_guard(loss)
        except RuntimeError:
            out["aborted_at"] = i
            return
    out["aborted_at"] = None


def _step_out(tr, m, out, mesh=None):
    """A dropout step's loss and gradients (a split model's gathered)."""
    out["loss"] = float(m["loss"])
    grads = {n: p.grad for n, p in tr.model.named_parameters()}
    if tr.shards is not None:
        grads = tp.full_state(grads, {"state": {}}, tr.shards, mesh)[0]
    out["grads"] = {n: g.clone() for n, g in grads.items()}


def _drop_gen(inputs):
    return torch.Generator().manual_seed(inputs["drop_seed"])


def dp_lm_drop(inputs, mesh, out, workdir):
    """One LMTrainer step at dropout 0.5 on this rank's rows."""
    tr = LMTrainer(lm_model(inputs, dropout_rate=0.5), workdir, mesh=mesh)
    _step_out(tr, tr.train_step(LMBatch(**inputs["lm_batch"]),
                                _drop_gen(inputs)), out, mesh)


def dp_am_drop(inputs, mesh, out, workdir):
    """One AMTrainer step at dropout 0.3 with noise and SpecAugment."""
    tr = AMTrainer(am_model(inputs, dropout_rate=0.3), workdir,
                   feature_dim=200, augment_noise=True, augment_spec=True,
                   mesh=mesh)
    _step_out(tr, tr.train_step(AMBatch(**inputs["am_drop_batch"]),
                                _drop_gen(inputs)), out)


def dp_e2e_drop(inputs, mesh, out, workdir):
    """One E2ETrainer step at dropout 0.1 with SpecAugment."""
    e2e = models.SpeechTransformer(
        models.SpeechTransformerConfig(**inputs["e2e_cfg"]),
        feature_dim=4 * inputs["e2e_nfilt"], device="cpu")
    e2e.load_state_dict(inputs["e2e_sd"])
    tr = E2ETrainer(e2e, workdir, feature_dim=inputs["e2e_nfilt"],
                    augment_spec=True, mesh=mesh)
    _step_out(tr, tr.train_step(AMBatch(**inputs["am_drop_batch"]),
                                _drop_gen(inputs)), out)


SCENARIOS = {"dp_am": (2, 1, dp_am), "tp_lm": (1, 2, tp_lm),
             "dp_tp_lm": (2, 2, dp_tp_lm), "pipeline": (2, 1, pipeline),
             "batchnorm": (2, 1, batchnorm), "nan_abort": (2, 1, nan_abort),
             "dp_lm_drop": (2, 1, dp_lm_drop),
             "dp_am_drop": (2, 1, dp_am_drop),
             "dp_e2e_drop": (2, 1, dp_e2e_drop),
             "dp_tp_lm_drop": (2, 2, dp_lm_drop)}


def main():
    rank, world, store, inputs_path, outdir = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    inputs = torch.load(inputs_path, weights_only=False)
    init_distributed(CPU, init_method="file://" + store, world_size=world,
                     rank=rank, timeout=120)
    try:
        for name in sys.argv[6:]:
            dp, mp, fn = SCENARIOS[name]
            out = {}
            fn(inputs, make_mesh(dp, mp, CPU), out,
               os.path.join(outdir, name))
            torch.save(out, os.path.join(outdir, f"{name}_{rank}.pt"))
    finally:
        destroy()


if __name__ == "__main__":
    main()
