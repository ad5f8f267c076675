"""Train loops for the AM, the LM, CTC-attention, the joint AM -> LM and the
e2e speech Transformer: the port of ``train/trainer.py`` (``AMTrainer``
:236, ``AttenTrainer`` :394, ``LMTrainer`` :524, ``JointTrainer`` :621,
``E2ETrainer`` :753). The BiGRU trains through ``AMTrainer``, as in JAX.

One step: batch to the device, (AM, when asked for) colored noise on the
raw signals, (AM, e2e) fbank through the ``log_mel`` / ``cmvn`` kernels,
SpecAugment when asked for (e2e: then LFR), the
model's training forward, the loss (CTC through the ``ctc_alpha`` /
``ctc_beta_xi`` kernels, or a label-smoothed cross entropy), ``backward``
(attention through the backward kernels), then Adam. As
``optax.adam(schedule)`` does, the learning rate of a step is
``schedule(step)`` with the step count before the update, and the returned
metrics carry that ``lr``.

Around the steps: JSONL metrics, a non-finite-loss guard, per-epoch dev
sweeps with a metric-gated best checkpoint, and resume from the latest
checkpoint (the e2e trainer: step-numbered checkpoints and an epoch
marker), with the model's identity stamp written beside the checkpoints
and checked before a restore. ``enable_tensorboard`` tees the numeric
metrics into TensorBoard event files under ``<workdir>/tb/<name>``
(``utils/tb_events.py``), and the e2e trainer then writes each dev sweep's
attention maps as images; ``profile_steps`` > 0 traces the first steps of
``AMTrainer.fit`` with ``torch.profiler`` into ``<workdir>/profile``.

``mesh`` (``parallel.make_mesh``; default: the process group's data mesh,
a mesh of one without a group) keeps JAX's global semantics under
``pjit`` by hand. Every process feeds the same global batch and takes its
rows (``parallel.shard_batch``); each loss and metric is this rank's
numerator over the denominator summed across ``data``, the gradients are
summed over ``data``, and a step reports the summed loss, so the
non-finite-loss guard, the dev gates and the best-checkpoint decision take
the same branch on every rank. BatchNorm statistics are global. The AM's
noise, the SpecAugment masks and every dropout mask are drawn for the
global batch from the step's generator on every rank, then cut to the
rank's rows (dropout through ``models.layers.data_rows``), so a meshed
step with dropout is the one-process step, as under ``pjit``. Rank 0
alone writes checkpoints (of the whole model), the identity stamp,
metrics, TensorBoard files and traces; the others wait at a barrier.
``LMTrainer`` splits the LM over ``model`` (``parallel/tensor.py``).
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist

from asr_dfcnn_transformer_torch.audio.fbank import FbankConfig, batched_fbank
from asr_dfcnn_transformer_torch.audio.lfr import batched_lfr
from asr_dfcnn_transformer_torch.audio.noise import (add_noise_from_draws,
                                                     noise_draws)
from asr_dfcnn_transformer_torch.audio.specaugment import (SpecAugmentConfig,
                                                           mask_features,
                                                           spec_draws)
from asr_dfcnn_transformer_torch.core import constants
from asr_dfcnn_transformer_torch.data.batches import AMBatch, LMBatch
from asr_dfcnn_transformer_torch.models.dfcnn import (frames_from_samples,
                                                      logit_lengths)
from asr_dfcnn_transformer_torch.models.layers import BatchNorm, data_rows
from asr_dfcnn_transformer_torch.models.speech_transformer import e2e_loss
from asr_dfcnn_transformer_torch.models.transformer_lm import lm_loss_and_acc
from asr_dfcnn_transformer_torch.ops.ctc import ctc_loss
from asr_dfcnn_transformer_torch.ops.ctc_decode import ctc_greedy_decode
from asr_dfcnn_transformer_torch.ops.edit_distance import (
    batched_edit_distance)
from asr_dfcnn_transformer_torch.parallel import make_mesh, shard_batch
from asr_dfcnn_transformer_torch.parallel import tensor as tp
from asr_dfcnn_transformer_torch.train import identity
from asr_dfcnn_transformer_torch.train.checkpoint import CheckpointManager
from asr_dfcnn_transformer_torch.train.schedule import (
    polynomial_decay_with_cycle)


class MetricWriter:
    """Appends one JSON line per record to ``<workdir>/<name>_metrics.jsonl``.

    :meth:`enable_tensorboard` also tees every finite float metric of each
    later record into TensorBoard event files (``utils/tb_events.py``),
    tagged ``<name>/<split>/<key>`` (``<name>/<key>`` without a split), so
    ``tensorboard --logdir <workdir>/tb`` reads them."""

    def __init__(self, workdir: str, name: str, enabled: bool = True):
        os.makedirs(workdir, exist_ok=True)
        self.path = os.path.join(workdir, f"{name}_metrics.jsonl")
        self._workdir = workdir
        self._name = name
        self.enabled = enabled      # False: writes nothing (ranks but 0)
        self.tb = None

    def enable_tensorboard(self, logdir: Optional[str] = None):
        """Create (or return) the event-file writer, under
        ``<workdir>/tb/<name>`` unless ``logdir`` is given (None where the
        writer is disabled)."""
        if self.tb is None and self.enabled:
            from asr_dfcnn_transformer_torch.utils.tb_events import (
                TBEventWriter)
            self.tb = TBEventWriter(
                logdir or os.path.join(self._workdir, "tb", self._name))
        return self.tb

    def write(self, step: int, **metrics):
        if not self.enabled:
            return
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: (float(v) if hasattr(v, "__float__") else v)
                    for k, v in metrics.items()})
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self.tb is not None:
            split = metrics.get("split")
            prefix = f"{self._name}/{split}/" if split else f"{self._name}/"
            for k, v in rec.items():
                if k in ("step", "time", "split", "epoch"):
                    continue
                if isinstance(v, float) and np.isfinite(v):
                    self.tb.scalar(prefix + k, v, rec["step"])
            self.tb.flush()


def _weighted_mean(values: torch.Tensor, weights: torch.Tensor,
                   total: Optional[torch.Tensor] = None):
    """sum(values * weights) / max(total, 1); ``total`` (default
    ``weights.sum()``) is the global batch's weight under a mesh."""
    total = weights.sum() if total is None else total
    return torch.sum(values * weights) / torch.clamp_min(total, 1.0)


def _dev_mean(evals, key: str) -> float:
    """Weight-aware mean of a per-batch dev metric (each eval carries the
    ``weight`` its metric averaged over)."""
    if not evals:
        return float("nan")
    w = np.array([float(e.get("weight", 1.0)) for e in evals])
    v = np.array([float(e[key]) for e in evals])
    return float(np.sum(v * w) / max(w.sum(), 1.0))


class _TrainerBase:
    def __init__(self, model: torch.nn.Module, workdir: str, name: str,
                 lr: float, decay_steps: int, min_lr: float,
                 max_to_keep: int = 5, mesh=None):
        self.model = model
        self.workdir = workdir
        self.mesh = mesh if mesh is not None else make_mesh(
            device=self.device)
        for mod in model.modules():
            if isinstance(mod, BatchNorm):
                mod.group = self.mesh.data_group
        #: {parameter: split axis or None} of a tensor-parallel model
        self.shards: Optional[Dict[str, Optional[int]]] = None
        self.schedule = polynomial_decay_with_cycle(lr, decay_steps, min_lr)
        self.opt = torch.optim.Adam(model.parameters(), lr=self.schedule(0),
                                    betas=(0.9, 0.999), eps=1e-8)
        self.ckpt = CheckpointManager(os.path.join(workdir, f"ckpt_{name}"),
                                      max_to_keep)
        self.metrics = MetricWriter(workdir, name,
                                    enabled=self.mesh.is_writer)
        self.step = 0
        self._nan_count = 0

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    # ---- the global batch under a mesh ----------------------------------

    def _rows(self, batch):
        """This rank's rows of a global batch (or of draws made for it)."""
        return None if batch is None else shard_batch(self.mesh, batch)

    def _sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the mesh's ``data`` group (no autograd)."""
        if self.mesh.data_group is None:
            return t.detach()
        t = t.detach().clone()
        dist.all_reduce(t, group=self.mesh.data_group)
        return t

    def _global_draws(self):
        """The context of a forward on this rank's rows: its dropout masks
        are the global batch's, cut to the rank's rows."""
        return data_rows(self.mesh.data_rank, self.mesh.shape["data"])

    def _ctc_eval(self, losses, logits, in_len, labels, label_len, w):
        """The dev metrics of a CTC model: the weighted loss and label error
        rate of the greedy decode over the global batch, and its weight."""
        decoded, dec_len = ctc_greedy_decode(logits, in_len, blank_id=-1,
                                             max_output_len=labels.shape[1])
        d = batched_edit_distance(decoded, dec_len, labels, label_len)
        ler = d.float() / torch.clamp_min(label_len.float(), 1.0)
        total = self._sum(w.sum())
        return {"loss": self._sum(_weighted_mean(losses, w, total)),
                "ler": self._sum(_weighted_mean(ler, w, total)),
                "weight": total}

    def _sum_gradients(self):
        """Sum every parameter's gradient over ``data`` (one flat
        all-reduce; a missing gradient counts as zeros, as in JAX)."""
        if self.mesh.data_group is None:
            return
        params = list(self.model.parameters())
        flat = torch.cat([(p.grad if p.grad is not None
                           else torch.zeros_like(p)).reshape(-1)
                          for p in params])
        dist.all_reduce(flat, group=self.mesh.data_group)
        for p, g in zip(params, flat.split([p.numel() for p in params])):
            p.grad = g.view_as(p)

    def _to_device(self, *arrays):
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                     for a in arrays)

    def enable_tensorboard(self):
        """Tee the metrics into TensorBoard event files under
        ``<workdir>/tb/<name>`` (CLI ``--tensorboard``)."""
        return self.metrics.enable_tensorboard()

    #: > 0: trace the first ``profile_steps`` steps of a ``fit`` with
    #: ``torch.profiler`` (CPU, and CUDA where present)
    profile_steps: int = 0
    _profiler = None

    def maybe_profile(self, global_count: int):
        """Start the trace before step 1, stop it after step
        ``profile_steps`` and write it as a Chrome trace
        (``<workdir>/profile/trace.json``, for chrome://tracing or
        Perfetto)."""
        if not self.profile_steps or not self.mesh.is_writer:
            return
        if global_count == 1 and self._profiler is None:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self._profiler = profile(activities=acts)
            self._profiler.__enter__()
        elif global_count == 1 + self.profile_steps and \
                self._profiler is not None:
            prof, self._profiler = self._profiler, None
            prof.__exit__(None, None, None)
            out = os.path.join(self.workdir, "profile")
            os.makedirs(out, exist_ok=True)
            prof.export_chrome_trace(os.path.join(out, "trace.json"))
            self.profile_steps = 0

    def nan_guard(self, loss: float, limit: int = 5):
        """Abort after ``limit`` consecutive non-finite losses instead of
        training on NaNs."""
        if np.isfinite(loss):
            self._nan_count = 0
            return
        self._nan_count += 1
        if self._nan_count >= limit:
            raise RuntimeError(f"{self._nan_count} consecutive non-finite "
                               "losses; aborting (the last checkpoint is "
                               "resumable)")

    def _backward_and_update(self, loss: torch.Tensor) -> float:
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        self._sum_gradients()
        return self.apply_gradients()

    def apply_gradients(self) -> float:
        """One Adam update from the parameters' ``.grad`` at the learning
        rate ``schedule(step)``; returns that rate."""
        lr = self.schedule(self.step)
        for group in self.opt.param_groups:
            group["lr"] = lr
        self.opt.step()
        self.step += 1
        return lr

    def state_dict(self) -> dict:
        """The whole model's state (a tensor-parallel model's shards
        gathered: every rank of its group takes part)."""
        model_sd, opt_sd = self.model.state_dict(), self.opt.state_dict()
        if self.shards is not None:
            model_sd, opt_sd = tp.full_state(model_sd, opt_sd, self.shards,
                                             self.mesh)
        return {"step": self.step, "model": model_sd, "optimizer": opt_sd}

    #: set True (CLI --force-model-mismatch) to downgrade a structural
    #: identity mismatch at restore from an error to a warning
    allow_model_mismatch: bool = False

    def restore_or_init(self) -> int:
        """Restore the latest checkpoint if there is one (else keep the
        model's weights and stamp the checkpoint directory); returns the
        step. The model is checked against the directory's identity stamp
        first (``train/identity.py``); an unstamped checkpoint is stamped
        on this first restore. A checkpoint that holds only ``"model"``
        (``convert.flax_checkpoint_to_port``) keeps the fresh optimizer and
        step 0. Under a mesh every rank restores the same checkpoint (a
        tensor-parallel one cut to the rank's shards) after a barrier, and
        rank 0 alone writes the stamp."""
        writer = self.mesh.is_writer
        self.mesh.barrier()
        if self.ckpt.latest_step() is None:
            if writer:
                identity.write_identity(self.ckpt.directory, self.model)
            self.mesh.barrier()
            return self.step
        identity.check_identity(self.ckpt.directory, self.model,
                                override=self.allow_model_mismatch)
        state = self.ckpt.restore_latest()
        model_sd, opt_sd = state["model"], state.get("optimizer")
        if self.shards is not None:
            model_sd, opt_sd = tp.local_state(model_sd, opt_sd, self.shards,
                                              self.mesh)
        self.model.load_state_dict(model_sd)
        if opt_sd is not None:
            self.opt.load_state_dict(opt_sd)
        self.step = int(state.get("step", 0))
        self.mesh.barrier()
        if writer and identity.read_identity(self.ckpt.directory) is None:
            print(f"# identity: stamping the unstamped checkpoint under "
                  f"{self.ckpt.directory!r} with the model it was restored "
                  f"into", file=sys.stderr)
            identity.write_identity(self.ckpt.directory, self.model)
        self.mesh.barrier()
        return self.step

    def save(self, epoch: int):
        state = self.state_dict()
        if self.mesh.is_writer:
            self.ckpt.save(epoch, state)
        self.mesh.barrier()

    def save_best(self, metric: Optional[float] = None):
        state = self.state_dict()
        if self.mesh.is_writer:
            self.ckpt.save_best(state, metric=metric)
        self.mesh.barrier()

    def _best_gate(self, mode: str) -> float:
        """The persisted metric of the best checkpoint on disk, so a resumed
        run never overwrites a better historical best."""
        stored = self.ckpt.best_metric()
        if stored is not None:
            return stored
        return float("inf") if mode == "min" else -float("inf")


class AMTrainer(_TrainerBase):
    """SE-DFCNN CTC trainer (train_acoustic_model semantics).

    ``augment_noise``: mix colored noise into the raw signals of each train
    step (``audio/noise.py``). ``augment_spec``: None (off), True (the
    default ``SpecAugmentConfig``) or a config; it masks the fbank features
    of each train step within their valid frames. A step draws from its
    generator in the JAX step's key order: the noise, then the masks, then
    dropout. Eval steps stay clean."""

    def __init__(self, model, workdir: str, lr: float = 7e-4,
                 decay_steps: int = 5000, min_lr: float = 1e-6,
                 feature_dim: int = 200, augment_noise: bool = False,
                 augment_spec=None, max_to_keep: int = 5, mesh=None):
        super().__init__(model, workdir, "am", lr, decay_steps, min_lr,
                         max_to_keep, mesh)
        self.fbank_cfg = FbankConfig(nfilt=feature_dim)
        self.augment_noise = augment_noise
        if augment_spec is True:
            augment_spec = SpecAugmentConfig()
        self.augment_spec = augment_spec or None

    def features(self, signals: torch.Tensor, signal_lengths: torch.Tensor,
                 bucket_frames: int, masks=None) -> torch.Tensor:
        """Normalised fbank features [B, 1, T, F] (NCHW) of a batch, through
        the ``log_mel`` and ``cmvn`` kernels; with ``masks`` (SpecAugment's
        draws) masked within their valid frames."""
        feats, valid = batched_fbank(signals, signal_lengths,
                                     cfg=self.fbank_cfg,
                                     out_frames=bucket_frames)
        if masks is not None:
            feats = mask_features(feats, valid, self.augment_spec, masks)
        return feats[:, None]

    def augment_draws(self, batch_size: int, num_samples: int,
                      generator: Optional[torch.Generator] = None):
        """A train step's random draws, noise first, then the masks: (the
        noise draws or None, the SpecAugment draws or None), on the
        generator's device (the model's without one)."""
        noise = spec = None
        if self.augment_noise:
            noise = noise_draws(batch_size, num_samples, generator,
                                device=self.device)
        if self.augment_spec is not None:
            spec = spec_draws(batch_size, self.augment_spec, generator,
                              device=self.device)
        return noise, spec

    def _forward(self, batch: AMBatch, generator=None, augment=False):
        """(per-example CTC losses, logits, logit lengths, pinyin, pinyin
        lengths, weights) of this rank's rows, on the device."""
        b_global = batch.signals.shape[0]
        batch = self._rows(batch)
        sig, sig_len, pny, pny_len, w = self._to_device(
            batch.signals, batch.signal_lengths, batch.pinyin,
            batch.pinyin_lengths, batch.weights)
        noise = spec = None
        if augment:
            noise, spec = map(self._rows, self.augment_draws(
                b_global, sig.shape[1], generator))
        if noise is not None:
            sig = add_noise_from_draws(sig, sig_len, noise)
        feats = self.features(sig, sig_len, batch.bucket_frames, spec)
        with self._global_draws():
            logits = self.model(feats, generator=generator)
        in_len = logit_lengths(frames_from_samples(sig_len), logits.shape[1])
        losses = ctc_loss(logits, in_len, pny, pny_len, blank_id=-1)
        return losses, logits, in_len, pny, pny_len, w

    def train_step(self, batch: AMBatch,
                   generator: Optional[torch.Generator] = None
                   ) -> Dict[str, object]:
        self.model.train()
        losses, _, _, _, _, w = self._forward(batch, generator, augment=True)
        loss = _weighted_mean(losses, w, self._sum(w.sum()))
        lr = self._backward_and_update(loss)
        return {"loss": self._sum(loss), "lr": lr}

    @torch.no_grad()
    def eval_step(self, batch: AMBatch) -> Dict[str, torch.Tensor]:
        self.model.eval()
        losses, logits, in_len, pny, pny_len, w = self._forward(batch)
        return self._ctc_eval(losses, logits, in_len, pny, pny_len, w)

    def fit(self, train_batches: Callable[[], Iterator[AMBatch]],
            dev_batches: Callable[[], Iterator[AMBatch]], epochs: int,
            generator: Optional[torch.Generator] = None,
            log_every: int = 2) -> Dict[str, float]:
        """Epoch loop with the dev-LER-gated best save."""
        best_ler = self._best_gate("min")
        last = {}
        start_epoch = (self.ckpt.latest_step() or -1) + 1
        for epoch in range(start_epoch, epochs):
            t0 = time.time()
            for i, batch in enumerate(train_batches()):
                self.maybe_profile(self.step + 1)
                m = self.train_step(batch, generator)
                if i % log_every == 0:
                    self.nan_guard(float(m["loss"]))
                    self.metrics.write(self.step, epoch=epoch,
                                       split="train", **m)
            evals = [self.eval_step(b) for b in dev_batches()]
            ler = _dev_mean(evals, "ler")
            loss = _dev_mean(evals, "loss")
            dt = time.time() - t0
            self.metrics.write(self.step, epoch=epoch, split="dev",
                               loss=loss, wer=ler, seconds=dt)
            print(f"[am] epoch {epoch}: dev_loss {loss:.3f} "
                  f"dev_wer {ler:.3f} ({dt:.1f}s)", flush=True)
            self.save(epoch)
            if evals and ler < best_ler:
                best_ler = ler
                self.save_best(metric=ler)
            last = {"epoch": epoch, "dev_loss": loss, "dev_wer": ler}
        return last


class AttenTrainer(_TrainerBase):
    """CTC-attention trainer (train_atten.py semantics): the AM trainer's
    loop on LFR features (fbank, then LFR with ``lfr_m`` / ``lfr_n``, then
    a trailing channel) and hanzi CTC targets; the eval step's greedy
    decode gives the hanzi ``ler``, and ``fit`` keeps the best checkpoint
    by the lowest dev ``wer``."""

    def __init__(self, model, workdir: str, lr: float = 7e-4,
                 decay_steps: int = 5000, min_lr: float = 1e-6,
                 feature_dim: int = 200, lfr_m: int = 4, lfr_n: int = 3,
                 max_to_keep: int = 5, mesh=None):
        super().__init__(model, workdir, "atten", lr, decay_steps, min_lr,
                         max_to_keep, mesh)
        self.fbank_cfg = FbankConfig(nfilt=feature_dim)
        self.lfr_m, self.lfr_n = lfr_m, lfr_n

    def features(self, signals: torch.Tensor, signal_lengths: torch.Tensor,
                 bucket_frames: int):
        """(LFR features [B, T', m*F, 1], valid LFR rows [B]) of a batch,
        the fbank through the ``log_mel`` / ``cmvn`` kernels."""
        feats, valid = batched_fbank(signals, signal_lengths,
                                     cfg=self.fbank_cfg,
                                     out_frames=bucket_frames)
        lfr, lfr_valid = batched_lfr(feats, valid, self.lfr_m, self.lfr_n)
        return lfr[..., None], lfr_valid

    def _forward(self, batch: AMBatch, generator=None):
        """(per-example CTC losses, logits, logit lengths, hanzi, hanzi
        lengths, weights) of this rank's rows, on the device."""
        batch = self._rows(batch)
        sig, sig_len, hz, hz_len, w = self._to_device(
            batch.signals, batch.signal_lengths, batch.hanzi,
            batch.hanzi_lengths, batch.weights)
        feats, valid = self.features(sig, sig_len, batch.bucket_frames)
        with self._global_draws():
            logits, in_len = self.model(feats, valid, generator=generator)
        losses = ctc_loss(logits, in_len, hz, hz_len, blank_id=-1)
        return losses, logits, in_len, hz, hz_len, w

    def train_step(self, batch: AMBatch,
                   generator: Optional[torch.Generator] = None
                   ) -> Dict[str, object]:
        self.model.train()
        losses, _, _, _, _, w = self._forward(batch, generator)
        loss = _weighted_mean(losses, w, self._sum(w.sum()))
        lr = self._backward_and_update(loss)
        return {"loss": self._sum(loss), "lr": lr}

    @torch.no_grad()
    def eval_step(self, batch: AMBatch) -> Dict[str, torch.Tensor]:
        self.model.eval()
        return self._ctc_eval(*self._forward(batch))

    def fit(self, train_batches: Callable[[], Iterator[AMBatch]],
            dev_batches: Callable[[], Iterator[AMBatch]], epochs: int,
            generator: Optional[torch.Generator] = None,
            log_every: int = 2) -> Dict[str, float]:
        """Epoch loop with the dev-``wer``-gated best save."""
        best_wer = self._best_gate("min")
        last = {}
        start_epoch = (self.ckpt.latest_step() or -1) + 1
        for epoch in range(start_epoch, epochs):
            for i, batch in enumerate(train_batches()):
                m = self.train_step(batch, generator)
                if i % log_every == 0:
                    self.nan_guard(float(m["loss"]))
                    self.metrics.write(self.step, epoch=epoch,
                                       split="train", **m)
            evals = [self.eval_step(b) for b in dev_batches()]
            wer = _dev_mean(evals, "ler")
            self.metrics.write(self.step, epoch=epoch, split="dev", wer=wer)
            print(f"[atten] epoch {epoch}: dev_wer {wer:.3f}", flush=True)
            self.save(epoch)
            if evals and wer < best_wer:
                best_wer = wer
                self.save_best(metric=wer)
            last = {"epoch": epoch, "dev_wer": wer}
        return last


class LMTrainer(_TrainerBase):
    """Transformer LM trainer (train_language_model semantics):
    label-smoothed CE, PAD-masked accuracy, acc-gated best save."""

    def __init__(self, model, workdir: str, lr: float = 5e-5,
                 decay_steps: int = 5000, min_lr: float = 1e-6,
                 max_to_keep: int = 5, mesh=None):
        """A ``mesh`` with a ``model`` axis above 1 splits the LM over it
        by ``param_shardings(..., tensor_parallel=True)``
        (``parallel.tensor.shard_model``)."""
        super().__init__(model, workdir, "lm", lr, decay_steps, min_lr,
                         max_to_keep, mesh)
        if self.mesh.shape["model"] > 1:
            self.shards = tp.shard_model(model, self.mesh)

    def _forward(self, batch: LMBatch, generator=None):
        batch = self._rows(batch)
        pny, hz, w = self._to_device(batch.pinyin, batch.hanzi, batch.weights)
        with self._global_draws():
            logits = self.model(pny.long(), generator=generator)
        # back-filled rows drop out: their targets become PAD
        tgt = torch.where(w[:, None] > 0, hz.long(), constants.PAD)
        loss, acc = lm_loss_and_acc(logits, tgt, reduce=self._sum)
        return loss, acc, tgt

    def train_step(self, batch: LMBatch,
                   generator: Optional[torch.Generator] = None
                   ) -> Dict[str, object]:
        self.model.train()
        loss, acc, _ = self._forward(batch, generator)
        lr = self._backward_and_update(loss)
        return {"loss": self._sum(loss), "acc": self._sum(acc), "lr": lr}

    @torch.no_grad()
    def eval_step(self, batch: LMBatch) -> Dict[str, torch.Tensor]:
        self.model.eval()
        loss, acc, tgt = self._forward(batch)
        ntok = self._sum(torch.sum((tgt != constants.PAD).float()))
        return {"loss": self._sum(loss), "acc": self._sum(acc),
                "weight": ntok}

    def fit(self, train_batches, dev_batches, epochs: int,
            generator: Optional[torch.Generator] = None,
            log_every: int = 10) -> Dict[str, float]:
        best_acc = self._best_gate("max")
        last = {}
        start_epoch = (self.ckpt.latest_step() or -1) + 1
        for epoch in range(start_epoch, epochs):
            for i, batch in enumerate(train_batches()):
                m = self.train_step(batch, generator)
                if i % log_every == 0:
                    self.nan_guard(float(m["loss"]))
                    self.metrics.write(self.step, epoch=epoch,
                                       split="train", **m)
            evals = [self.eval_step(b) for b in dev_batches()]
            acc = _dev_mean(evals, "acc")
            loss = _dev_mean(evals, "loss")
            self.metrics.write(self.step, epoch=epoch, split="dev",
                               loss=loss, acc=acc)
            print(f"[lm] epoch {epoch}: dev_loss {loss:.3f} "
                  f"dev_acc {acc:.3f}", flush=True)
            self.save(epoch)
            if evals and acc > best_acc:
                best_acc = acc
                self.save_best(metric=acc)
            last = {"epoch": epoch, "dev_loss": loss, "dev_acc": acc}
        return last


class JointTrainer(_TrainerBase):
    """Trainer for ``models.AMLMJoint`` (the working form of the reference's
    am_lm_train.py): one step optimises CTC(AM) + CE(LM on the AM's greedy
    pinyin). The AM reads fbank of ``feature_dim`` filters; the lengths
    are ``frames_from_samples`` of the signal lengths. ``fit`` keeps the
    best checkpoint by the highest dev ``lm_acc`` and saves each epoch."""

    def __init__(self, model, workdir: str, lr: float = 7e-4,
                 decay_steps: int = 5000, min_lr: float = 1e-6,
                 feature_dim: int = 200, max_to_keep: int = 5, mesh=None):
        super().__init__(model, workdir, "joint", lr, decay_steps, min_lr,
                         max_to_keep, mesh)
        self.fbank_cfg = FbankConfig(nfilt=feature_dim)

    def features(self, signals: torch.Tensor, signal_lengths: torch.Tensor,
                 bucket_frames: int) -> torch.Tensor:
        """Normalised fbank features [B, 1, T, F] (NCHW)."""
        feats, _ = batched_fbank(signals, signal_lengths, cfg=self.fbank_cfg,
                                 out_frames=bucket_frames)
        return feats[:, None]

    def _forward(self, batch: AMBatch, generator=None):
        batch = self._rows(batch)
        sig, sig_len, pny, pny_len, hz, w = self._to_device(
            batch.signals, batch.signal_lengths, batch.pinyin,
            batch.pinyin_lengths, batch.hanzi, batch.weights)
        feats = self.features(sig, sig_len, batch.bucket_frames)
        with self._global_draws():
            out = self.model(feats, frames_from_samples(sig_len), pny,
                             pny_len, hz.long(), w, generator=generator,
                             reduce=self._sum)
        return out, w

    def train_step(self, batch: AMBatch,
                   generator: Optional[torch.Generator] = None
                   ) -> Dict[str, object]:
        self.model.train()
        out, _ = self._forward(batch, generator)
        lr = self._backward_and_update(out["loss"])
        m = {k: self._sum(out[k]) for k in ("loss", "am_loss", "lm_loss",
                                            "lm_acc")}
        m["lr"] = lr
        return m

    @torch.no_grad()
    def eval_step(self, batch: AMBatch) -> Dict[str, torch.Tensor]:
        self.model.eval()
        out, w = self._forward(batch)
        m = {k: self._sum(out[k])
             for k in ("loss", "am_loss", "lm_loss", "lm_acc")}
        m["weight"] = self._sum(w.sum())
        return m

    def fit(self, train_batches: Callable[[], Iterator[AMBatch]],
            epochs: int, generator: Optional[torch.Generator] = None,
            dev_batches: Optional[Callable[[], Iterator[AMBatch]]] = None,
            log_every: int = 2) -> Dict[str, float]:
        """Epoch loop; with ``dev_batches`` a dev sweep and the
        ``lm_acc``-gated best save."""
        best_acc = self._best_gate("max")
        last = {}
        start_epoch = (self.ckpt.latest_step() or -1) + 1
        for epoch in range(start_epoch, epochs):
            for i, batch in enumerate(train_batches()):
                m = self.train_step(batch, generator)
                if i % log_every == 0:
                    self.nan_guard(float(m["loss"]))
                    self.metrics.write(self.step, epoch=epoch,
                                       split="train", **m)
                last = {"epoch": epoch, "loss": float(m["loss"]),
                        "lm_acc": float(m["lm_acc"])}
            if dev_batches is not None:
                evals = [self.eval_step(b) for b in dev_batches()]
                acc = _dev_mean(evals, "lm_acc")
                loss = _dev_mean(evals, "loss")
                self.metrics.write(self.step, epoch=epoch, split="dev",
                                   loss=loss, lm_acc=acc)
                print(f"[joint] epoch {epoch}: dev_loss {loss:.3f} "
                      f"dev_lm_acc {acc:.3f}", flush=True)
                last.update(dev_loss=loss, dev_lm_acc=acc)
                if evals and acc > best_acc:
                    best_acc = acc
                    self.save_best(metric=acc)
            self.save(epoch)
        return last


class E2ETrainer(_TrainerBase):
    """Speech-Transformer trainer: the LFR front end on the device, a
    teacher-forced decoder with [SOS]+y inputs and y+[EOS] targets padded
    with IGNORE_ID, ``e2e_loss``. ``augment_spec``: None (off), True (the
    default ``SpecAugmentConfig``) or a config; it masks the fbank features
    before LFR, in the train step only."""

    def __init__(self, model, workdir: str, lr: float = 3e-4,
                 decay_steps: int = 5000, min_lr: float = 1e-6,
                 feature_dim: int = 80, lfr_m: int = 4, lfr_n: int = 3,
                 augment_spec=None, max_to_keep: int = 5, mesh=None):
        super().__init__(model, workdir, "e2e", lr, decay_steps, min_lr,
                         max_to_keep, mesh)
        self.fbank_cfg = FbankConfig(nfilt=feature_dim)
        self.lfr_m, self.lfr_n = lfr_m, lfr_n
        if augment_spec is True:
            augment_spec = SpecAugmentConfig()
        self.augment_spec = augment_spec or None

    def features(self, signals: torch.Tensor, signal_lengths: torch.Tensor,
                 bucket_frames: int, masks=None):
        """(LFR features [B, T', m*F, 1], valid LFR rows [B]) of a batch:
        fbank through the ``log_mel`` / ``cmvn`` kernels, masked within the
        valid frames with ``masks`` (SpecAugment's draws) when given, then
        LFR."""
        feats, valid = batched_fbank(signals, signal_lengths,
                                     cfg=self.fbank_cfg,
                                     out_frames=bucket_frames)
        if masks is not None:
            feats = mask_features(feats, valid, self.augment_spec, masks)
        lfr, lfr_valid = batched_lfr(feats, valid, self.lfr_m, self.lfr_n)
        return lfr[..., None], lfr_valid

    @staticmethod
    def make_decoder_io(hanzi: np.ndarray, hanzi_lengths: np.ndarray):
        """[SOS]+y decoder inputs (PAD past each label) and y+[EOS] targets
        (IGNORE_ID past it), both [B, L+1] int32."""
        b, l = hanzi.shape
        dec_in = np.full((b, l + 1), constants.PAD, np.int32)
        dec_in[:, 0] = constants.SOS
        dec_in[:, 1:] = hanzi
        targets = np.full((b, l + 1), constants.IGNORE_ID, np.int32)
        for i in range(b):
            n = int(hanzi_lengths[i])
            targets[i, :n] = hanzi[i, :n]
            targets[i, n] = constants.EOS
            dec_in[i, n + 1:] = constants.PAD
        return dec_in, targets

    def _forward(self, batch: AMBatch, dec_in: np.ndarray,
                 targets: np.ndarray, augment=False, generator=None):
        """(loss, accuracy, targets) of this rank's rows of a global batch
        and its decoder inputs / targets."""
        b_global = batch.signals.shape[0]
        batch = self._rows(batch)
        dec_in, targets = self._rows((dec_in, targets))
        sig, sig_len, dec_in, tgt = self._to_device(
            batch.signals, batch.signal_lengths, dec_in, targets)
        masks = None
        if augment and self.augment_spec is not None:
            masks = self._rows(spec_draws(b_global, self.augment_spec,
                                          generator, sig.device))
        feats, valid = self.features(sig, sig_len, batch.bucket_frames,
                                     masks)
        with self._global_draws():
            logits = self.model(feats, valid, dec_in, generator=generator)
        loss, acc = e2e_loss(logits, tgt, reduce=self._sum)
        return loss, acc, tgt

    def train_step(self, batch: AMBatch,
                   generator: Optional[torch.Generator] = None
                   ) -> Dict[str, object]:
        self.model.train()
        dec_in, targets = self.make_decoder_io(batch.hanzi,
                                               batch.hanzi_lengths)
        loss, acc, _ = self._forward(batch, dec_in, targets, True, generator)
        lr = self._backward_and_update(loss)
        return {"loss": self._sum(loss), "acc": self._sum(acc), "lr": lr}

    @torch.no_grad()
    def eval_step(self, batch: AMBatch) -> Dict[str, torch.Tensor]:
        """Teacher-forced dev metrics; the targets of weight-0 (back-filled)
        rows become IGNORE_ID, so they drop out of the token-normalised
        loss and accuracy. ``weight`` is the count of scored targets."""
        self.model.eval()
        dec_in, targets = self.make_decoder_io(batch.hanzi,
                                               batch.hanzi_lengths)
        targets[np.asarray(batch.weights) == 0] = constants.IGNORE_ID
        loss, acc, tgt = self._forward(batch, dec_in, targets)
        return {"loss": self._sum(loss), "acc": self._sum(acc),
                "weight": self._sum(torch.sum(tgt != constants.IGNORE_ID))}

    def _epoch_marker_path(self) -> str:
        return os.path.join(self.workdir, "e2e_epochs_completed.json")

    def _write_attention_images(self, batch: AMBatch, step: int):
        """One dev batch's attention maps as TensorBoard images, tagged
        ``e2e/attention/<module path>``: each attention module's first
        utterance and first head, from an evaluation-mode forward with the
        probabilities captured (the reference's heatmap summary,
        end2end/transformer.py:105-106)."""
        from asr_dfcnn_transformer_torch.utils.introspect import (
            attention_maps)
        self.model.eval()
        dec_in, _ = self.make_decoder_io(batch.hanzi, batch.hanzi_lengths)
        sig, sig_len, dec_in = self._to_device(batch.signals,
                                               batch.signal_lengths, dec_in)
        with torch.no_grad():
            feats, valid = self.features(sig, sig_len, batch.bucket_frames)
        maps = attention_maps(self.model, feats, valid, dec_in)
        for path, probs in maps.items():
            img = probs[0, 0].float().cpu().numpy()
            self.metrics.tb.image(f"e2e/attention/{path}", img, step)

    def fit(self, train_batches: Callable[[], Iterator[AMBatch]],
            epochs: int, generator: Optional[torch.Generator] = None,
            log_every: int = 10, ckpt_every: int = 1000,
            dev_batches: Optional[Callable[[], Iterator[AMBatch]]] = None
            ) -> Dict[str, float]:
        """Step loop with step-numbered checkpoints every ``ckpt_every``
        steps and at each epoch's end; resume reads the epoch marker written
        at each epoch's end, when a checkpoint exists. ``dev_batches`` adds
        a per-epoch teacher-forced dev sweep with an acc-gated best save."""
        last = {}
        best_acc = self._best_gate("max")
        start_epoch = 0
        if self.ckpt.latest_step() is not None and \
                os.path.exists(self._epoch_marker_path()):
            with open(self._epoch_marker_path()) as f:
                start_epoch = int(json.load(f)["epochs_completed"])
        for epoch in range(start_epoch, epochs):
            for i, batch in enumerate(train_batches()):
                m = self.train_step(batch, generator)
                if i % log_every == 0:
                    self.nan_guard(float(m["loss"]))
                    self.metrics.write(self.step, epoch=epoch, split="train",
                                       **m)
                if self.step % ckpt_every == 0:
                    self.save(self.step)
                last = {"epoch": epoch, "loss": float(m["loss"]),
                        "acc": float(m["acc"])}
            if dev_batches is not None:
                evals = [self.eval_step(b) for b in dev_batches()]
                acc = _dev_mean(evals, "acc")
                loss = _dev_mean(evals, "loss")
                self.metrics.write(self.step, epoch=epoch, split="dev",
                                   loss=loss, acc=acc)
                print(f"[e2e] epoch {epoch}: dev_loss {loss:.3f} "
                      f"dev_acc {acc:.3f}", flush=True)
                last.update(dev_loss=loss, dev_acc=acc)
                if self.metrics.tb is not None:
                    first_dev = next(iter(dev_batches()), None)
                    if first_dev is not None:
                        self._write_attention_images(first_dev, self.step)
                if evals and acc > best_acc:
                    best_acc = acc
                    self.save_best(metric=acc)
            self.save(self.step)
            if self.mesh.is_writer:
                with open(self._epoch_marker_path(), "w") as f:
                    json.dump({"epochs_completed": epoch + 1}, f)
            self.mesh.barrier()
        return last
