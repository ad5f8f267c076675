"""Train loops for the AM, the LM and the e2e speech Transformer: the port
of ``train/trainer.py`` (``AMTrainer`` :236, ``LMTrainer`` :524,
``E2ETrainer`` :753).

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
and checked before a restore. Not ported yet: the device mesh,
``remat_stages``, TensorBoard (with the e2e attention images) and
profiling.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from asr_dfcnn_transformer_torch.audio.fbank import FbankConfig, batched_fbank
from asr_dfcnn_transformer_torch.audio.lfr import batched_lfr
from asr_dfcnn_transformer_torch.audio.noise import (add_noise_from_draws,
                                                     noise_draws)
from asr_dfcnn_transformer_torch.audio.specaugment import (SpecAugmentConfig,
                                                           mask_features,
                                                           spec_augment,
                                                           spec_draws)
from asr_dfcnn_transformer_torch.core import constants
from asr_dfcnn_transformer_torch.data.batches import AMBatch, LMBatch
from asr_dfcnn_transformer_torch.models.dfcnn import (frames_from_samples,
                                                      logit_lengths)
from asr_dfcnn_transformer_torch.models.speech_transformer import e2e_loss
from asr_dfcnn_transformer_torch.models.transformer_lm import lm_loss_and_acc
from asr_dfcnn_transformer_torch.ops.ctc import ctc_loss
from asr_dfcnn_transformer_torch.ops.ctc_decode import ctc_greedy_decode
from asr_dfcnn_transformer_torch.ops.edit_distance import (
    batched_edit_distance)
from asr_dfcnn_transformer_torch.train import identity
from asr_dfcnn_transformer_torch.train.checkpoint import CheckpointManager
from asr_dfcnn_transformer_torch.train.schedule import (
    polynomial_decay_with_cycle)


class MetricWriter:
    """Appends one JSON line per record to ``<workdir>/<name>_metrics.jsonl``."""

    def __init__(self, workdir: str, name: str):
        os.makedirs(workdir, exist_ok=True)
        self.path = os.path.join(workdir, f"{name}_metrics.jsonl")

    def write(self, step: int, **metrics):
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: (float(v) if hasattr(v, "__float__") else v)
                    for k, v in metrics.items()})
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")


def _weighted_mean(values: torch.Tensor, weights: torch.Tensor):
    return torch.sum(values * weights) / torch.clamp_min(weights.sum(), 1.0)


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
                 max_to_keep: int = 5):
        self.model = model
        self.workdir = workdir
        self.schedule = polynomial_decay_with_cycle(lr, decay_steps, min_lr)
        self.opt = torch.optim.Adam(model.parameters(), lr=self.schedule(0),
                                    betas=(0.9, 0.999), eps=1e-8)
        self.ckpt = CheckpointManager(os.path.join(workdir, f"ckpt_{name}"),
                                      max_to_keep)
        self.metrics = MetricWriter(workdir, name)
        self.step = 0
        self._nan_count = 0

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def _to_device(self, *arrays):
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                     for a in arrays)

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
        return {"step": self.step, "model": self.model.state_dict(),
                "optimizer": self.opt.state_dict()}

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
        step 0."""
        if self.ckpt.latest_step() is None:
            identity.write_identity(self.ckpt.directory, self.model)
            return self.step
        identity.check_identity(self.ckpt.directory, self.model,
                                override=self.allow_model_mismatch)
        state = self.ckpt.restore_latest()
        self.model.load_state_dict(state["model"])
        if "optimizer" in state:
            self.opt.load_state_dict(state["optimizer"])
        self.step = int(state.get("step", 0))
        if identity.read_identity(self.ckpt.directory) is None:
            print(f"# identity: stamping the unstamped checkpoint under "
                  f"{self.ckpt.directory!r} with the model it was restored "
                  f"into", file=sys.stderr)
            identity.write_identity(self.ckpt.directory, self.model)
        return self.step

    def save(self, epoch: int):
        self.ckpt.save(epoch, self.state_dict())

    def save_best(self, metric: Optional[float] = None):
        self.ckpt.save_best(self.state_dict(), metric=metric)

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
                 augment_spec=None, max_to_keep: int = 5):
        super().__init__(model, workdir, "am", lr, decay_steps, min_lr,
                         max_to_keep)
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
        lengths, weights) on the device."""
        sig, sig_len, pny, pny_len, w = self._to_device(
            batch.signals, batch.signal_lengths, batch.pinyin,
            batch.pinyin_lengths, batch.weights)
        noise = spec = None
        if augment:
            noise, spec = self.augment_draws(sig.shape[0], sig.shape[1],
                                             generator)
        if noise is not None:
            sig = add_noise_from_draws(sig, sig_len, noise)
        feats = self.features(sig, sig_len, batch.bucket_frames, spec)
        logits = self.model(feats, generator=generator)
        in_len = logit_lengths(frames_from_samples(sig_len), logits.shape[1])
        losses = ctc_loss(logits, in_len, pny, pny_len, blank_id=-1)
        return losses, logits, in_len, pny, pny_len, w

    def train_step(self, batch: AMBatch,
                   generator: Optional[torch.Generator] = None
                   ) -> Dict[str, object]:
        self.model.train()
        losses, _, _, _, _, w = self._forward(batch, generator, augment=True)
        loss = _weighted_mean(losses, w)
        lr = self._backward_and_update(loss)
        return {"loss": loss.detach(), "lr": lr}

    @torch.no_grad()
    def eval_step(self, batch: AMBatch) -> Dict[str, torch.Tensor]:
        self.model.eval()
        losses, logits, in_len, pny, pny_len, w = self._forward(batch)
        decoded, dec_len = ctc_greedy_decode(logits, in_len, blank_id=-1,
                                             max_output_len=pny.shape[1])
        dist = batched_edit_distance(decoded, dec_len, pny, pny_len)
        ler = dist.float() / torch.clamp_min(pny_len.float(), 1.0)
        return {"loss": _weighted_mean(losses, w),
                "ler": _weighted_mean(ler, w), "weight": w.sum()}

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


class LMTrainer(_TrainerBase):
    """Transformer LM trainer (train_language_model semantics):
    label-smoothed CE, PAD-masked accuracy, acc-gated best save."""

    def __init__(self, model, workdir: str, lr: float = 5e-5,
                 decay_steps: int = 5000, min_lr: float = 1e-6,
                 max_to_keep: int = 5):
        super().__init__(model, workdir, "lm", lr, decay_steps, min_lr,
                         max_to_keep)

    def _forward(self, batch: LMBatch, generator=None):
        pny, hz, w = self._to_device(batch.pinyin, batch.hanzi, batch.weights)
        logits = self.model(pny.long(), generator=generator)
        # back-filled rows drop out: their targets become PAD
        tgt = torch.where(w[:, None] > 0, hz.long(), constants.PAD)
        loss, acc = lm_loss_and_acc(logits, tgt)
        return loss, acc, tgt

    def train_step(self, batch: LMBatch,
                   generator: Optional[torch.Generator] = None
                   ) -> Dict[str, object]:
        self.model.train()
        loss, acc, _ = self._forward(batch, generator)
        lr = self._backward_and_update(loss)
        return {"loss": loss.detach(), "acc": acc.detach(), "lr": lr}

    @torch.no_grad()
    def eval_step(self, batch: LMBatch) -> Dict[str, torch.Tensor]:
        self.model.eval()
        loss, acc, tgt = self._forward(batch)
        ntok = torch.sum((tgt != constants.PAD).float())
        return {"loss": loss, "acc": acc, "weight": ntok}

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


class E2ETrainer(_TrainerBase):
    """Speech-Transformer trainer: the LFR front end on the device, a
    teacher-forced decoder with [SOS]+y inputs and y+[EOS] targets padded
    with IGNORE_ID, ``e2e_loss``. ``augment_spec``: None (off), True (the
    default ``SpecAugmentConfig``) or a config; it masks the fbank features
    before LFR, in the train step only."""

    def __init__(self, model, workdir: str, lr: float = 3e-4,
                 decay_steps: int = 5000, min_lr: float = 1e-6,
                 feature_dim: int = 80, lfr_m: int = 4, lfr_n: int = 3,
                 augment_spec=None, max_to_keep: int = 5):
        super().__init__(model, workdir, "e2e", lr, decay_steps, min_lr,
                         max_to_keep)
        self.fbank_cfg = FbankConfig(nfilt=feature_dim)
        self.lfr_m, self.lfr_n = lfr_m, lfr_n
        if augment_spec is True:
            augment_spec = SpecAugmentConfig()
        self.augment_spec = augment_spec or None

    def features(self, signals: torch.Tensor, signal_lengths: torch.Tensor,
                 bucket_frames: int, augment: bool = False,
                 generator: Optional[torch.Generator] = None):
        """(LFR features [B, T', m*F, 1], valid LFR rows [B]) of a batch:
        fbank through the ``log_mel`` / ``cmvn`` kernels, SpecAugment when
        ``augment`` and the trainer has a policy, then LFR."""
        feats, valid = batched_fbank(signals, signal_lengths,
                                     cfg=self.fbank_cfg,
                                     out_frames=bucket_frames)
        if augment and self.augment_spec is not None:
            feats = spec_augment(feats, valid, self.augment_spec, generator)
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
        sig, sig_len, dec_in, tgt = self._to_device(
            batch.signals, batch.signal_lengths, dec_in, targets)
        feats, valid = self.features(sig, sig_len, batch.bucket_frames,
                                     augment, generator)
        logits = self.model(feats, valid, dec_in, generator=generator)
        loss, acc = e2e_loss(logits, tgt)
        return loss, acc, tgt

    def train_step(self, batch: AMBatch,
                   generator: Optional[torch.Generator] = None
                   ) -> Dict[str, object]:
        self.model.train()
        dec_in, targets = self.make_decoder_io(batch.hanzi,
                                               batch.hanzi_lengths)
        loss, acc, _ = self._forward(batch, dec_in, targets, True, generator)
        lr = self._backward_and_update(loss)
        return {"loss": loss.detach(), "acc": acc.detach(), "lr": lr}

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
        return {"loss": loss, "acc": acc,
                "weight": torch.sum(tgt != constants.IGNORE_ID)}

    def _epoch_marker_path(self) -> str:
        return os.path.join(self.workdir, "e2e_epochs_completed.json")

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
                if evals and acc > best_acc:
                    best_acc = acc
                    self.save_best(metric=acc)
            self.save(self.step)
            with open(self._epoch_marker_path(), "w") as f:
                json.dump({"epochs_completed": epoch + 1}, f)
        return last
