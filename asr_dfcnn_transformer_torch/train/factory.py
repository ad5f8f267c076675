"""Config tree -> models and trainers: the port of ``train/factory.py``.

``core.config.Config`` is the one construction surface, as in the JAX
package: ``build_lm_model(Config(lm=LmConfig(fused_ffn="pallas")))`` is how
a user selects the ``fused_ffn`` kernel. Every builder takes ``device``
(default ``cuda``, raising without CUDA) and an optional ``generator`` for
the initial weights. ``build_loader`` gives the configured corpus's
``DataLoader``. ``build_mesh`` lays ``cfg.mesh``'s ``(data, model)`` grid
over the process group (a mesh of one in a single process), and the trainer
builders take it as ``mesh=`` (default: ``build_mesh(cfg)``), as in JAX.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

import torch

from asr_dfcnn_transformer_torch.core import config as cmod
from asr_dfcnn_transformer_torch.core import vocab as vocab_mod
from asr_dfcnn_transformer_torch.core.config import Config

def _dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def am_architecture(name: str) -> dict:
    """The ``SEDFCNN`` fields that an SE-DFCNN name (``AmConfig.model``,
    the CLI's ``--model``) selects; any other name raises, as the JAX
    factory does for a name it does not build."""
    if name == "se_dfcnn_fast":       # SEDFCNN.fast: space-to-depth
        return dict(stage_pool=(True, True, False, False, False),
                    space_to_depth=True)
    if name in ("se_dfcnn", "se_dfcnn_pre"):
        return dict(se_first=name == "se_dfcnn_pre")
    raise ValueError(f"unknown am model {name!r}")


def build_am_model(cfg: Config, device=None,
                   generator: Optional[torch.Generator] = None,
                   logits_matmul: str = "f32"):
    """The AM that ``cfg.am.model`` names, as the JAX factory builds it
    (``bigru``: ``BiGRUCTC`` at its own defaults, the config's dropout rate
    unused, as in JAX); ``logits_matmul`` selects the logits head's product
    (the JAX CLI's ``--logits-matmul``; the JAX factory leaves it at
    "f32")."""
    from asr_dfcnn_transformer_torch import models
    av = vocab_mod.acoustic_vocab()
    am = cfg.am
    kw = dict(dropout_rate=am.dropout_rate, logits_matmul=logits_matmul,
              dtype=_dtype(am.dtype))
    if am.model == "bigru":
        model, config = models.BiGRUCTC, models.BiGRUCTCConfig(
            av.size, logits_matmul=logits_matmul, dtype=_dtype(am.dtype))
    elif am.model == "dfcnn":
        model, config = models.DFCNN, models.DFCNNConfig(av.size, **kw)
    elif am.model == "keras_dfcnn":
        model, config = models.KerasDFCNN, models.KerasDFCNNConfig(
            av.size, dense_units=am.dense_units, **kw)
    else:
        model, config = models.SEDFCNN, models.SEDFCNNConfig(
            av.size, se_ratio=tuple(am.se_ratio),
            **am_architecture(am.model), **kw)
    return model(config, feature_dim=am.feature_dim, device=device,
                 generator=generator)


def build_lm_model(cfg: Config, device=None,
                   generator: Optional[torch.Generator] = None):
    from asr_dfcnn_transformer_torch.models import (TransformerLM,
                                                    TransformerLMConfig)
    av, lv = vocab_mod.acoustic_vocab(), vocab_mod.language_vocab()
    return TransformerLM(TransformerLMConfig(
        av.size, lv.size, d_model=cfg.lm.d_model,
        num_heads=cfg.lm.num_heads, num_blocks=cfg.lm.num_blocks,
        position_max_length=cfg.lm.position_max_length,
        dropout_rate=cfg.lm.dropout_rate,
        parity_attention=cfg.lm.parity_attention,
        fused_attention=cfg.lm.fused_attention,
        fused_ffn=cfg.lm.fused_ffn,
        dtype=_dtype(cfg.lm.dtype)), device=device, generator=generator)


def build_e2e_model(cfg: Config, device=None,
                    generator: Optional[torch.Generator] = None):
    """The e2e model over LFR rows of ``lfr_m`` x ``feature_dim`` (the Flax
    module infers that width from its first input)."""
    from asr_dfcnn_transformer_torch.models import (SpeechTransformer,
                                                    SpeechTransformerConfig)
    e = cfg.e2e
    return SpeechTransformer(SpeechTransformerConfig(
        vocab_mod.e2e_language_vocab().size, d_model=e.d_model,
        num_heads=e.num_heads, num_enc_blocks=e.num_enc_blocks,
        num_dec_blocks=e.num_dec_blocks, dropout_rate=e.dropout_rate,
        position_max_length=e.position_max_length,
        fused_attention=e.fused_attention, fused_ffn=e.fused_ffn,
        dtype=_dtype(e.dtype)), feature_dim=e.lfr_m * e.feature_dim,
        device=device, generator=generator)


def build_mesh(cfg: Config, device=None):
    """``parallel.make_mesh(cfg.mesh.data_parallel,
    cfg.mesh.model_parallel)`` for this process's ``device`` (default:
    the current CUDA device)."""
    from asr_dfcnn_transformer_torch.parallel import make_mesh
    return make_mesh(cfg.mesh.data_parallel, cfg.mesh.model_parallel,
                     device)


def _device_of(model) -> torch.device:
    return next(model.parameters()).device


def build_loader(cfg: Config, mode: str, shuffle: Optional[bool] = None,
                 e2e_vocab: bool = False):
    """The ``DataLoader`` over ``cfg.data``'s manifests of ``mode``
    (train / dev / test); ``e2e_vocab`` takes the e2e model's hanzi ids
    (PAD / SOS / EOS first) instead of the LM's."""
    from asr_dfcnn_transformer_torch.data import DataLoader, load_manifests
    av = vocab_mod.acoustic_vocab()
    lv = vocab_mod.e2e_language_vocab() if e2e_vocab \
        else vocab_mod.language_vocab()
    m = load_manifests(cfg.data.data_dir, mode,
                       corpora=tuple(cfg.data.corpora),
                       use_noise=cfg.data.use_noise_manifest,
                       shuffle=cfg.data.shuffle if shuffle is None
                       else shuffle,
                       seed=cfg.train.seed,
                       data_length=cfg.data.data_length)
    return DataLoader(m, av, lv, speech_root=cfg.data.speech_data_root,
                      noise_root=cfg.data.noise_data_root,
                      feature_max_length=cfg.am.feature_max_length,
                      bucket_bounds=tuple(cfg.data.bucket_bounds))


def build_am_trainer(cfg: Config, workdir: str, augment_noise: bool = False,
                     augment_spec=None, device=None,
                     generator: Optional[torch.Generator] = None,
                     mesh=None):
    from asr_dfcnn_transformer_torch.train import AMTrainer
    model = build_am_model(cfg, device, generator)
    return AMTrainer(model, workdir,
                     lr=cfg.am.lr, decay_steps=cfg.train.decay_steps,
                     min_lr=cfg.train.min_lr, feature_dim=cfg.am.feature_dim,
                     augment_noise=augment_noise, augment_spec=augment_spec,
                     max_to_keep=cfg.train.max_to_keep,
                     mesh=mesh or build_mesh(cfg, _device_of(model)))


def build_lm_trainer(cfg: Config, workdir: str, device=None,
                     generator: Optional[torch.Generator] = None,
                     mesh=None):
    """A ``model`` axis above 1 makes the LM tensor-parallel."""
    from asr_dfcnn_transformer_torch.train import LMTrainer
    model = build_lm_model(cfg, device, generator)
    return LMTrainer(model, workdir,
                     lr=cfg.lm.lr, decay_steps=cfg.train.decay_steps,
                     min_lr=cfg.train.min_lr,
                     max_to_keep=cfg.train.max_to_keep,
                     mesh=mesh or build_mesh(cfg, _device_of(model)))


def build_e2e_trainer(cfg: Config, workdir: str, augment_spec=None,
                      device=None,
                      generator: Optional[torch.Generator] = None,
                      mesh=None):
    from asr_dfcnn_transformer_torch.train import E2ETrainer
    model = build_e2e_model(cfg, device, generator)
    return E2ETrainer(model, workdir,
                      lr=cfg.e2e.lr, decay_steps=cfg.train.decay_steps,
                      min_lr=cfg.train.min_lr,
                      feature_dim=cfg.e2e.feature_dim, lfr_m=cfg.e2e.lfr_m,
                      lfr_n=cfg.e2e.lfr_n, augment_spec=augment_spec,
                      max_to_keep=cfg.train.max_to_keep,
                      mesh=mesh or build_mesh(cfg, _device_of(model)))


# ---- (de)serialization ---------------------------------------------------

def config_to_json(cfg: Config) -> str:
    return json.dumps(dataclasses.asdict(cfg), indent=2)


def config_from_json(text: str) -> Config:
    """The inverse of :func:`config_to_json` (the JAX package's JSON too);
    keys a dataclass does not have are dropped, sequences stay lists."""
    raw = json.loads(text)

    def mk(cls, d):
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    return Config(
        am=mk(cmod.AmConfig, raw.get("am", {})),
        lm=mk(cmod.LmConfig, raw.get("lm", {})),
        e2e=mk(cmod.E2EConfig, raw.get("e2e", {})),
        data=mk(cmod.DataConfig, raw.get("data", {})),
        train=mk(cmod.TrainConfig, raw.get("train", {})),
        mesh=mk(cmod.MeshConfig, raw.get("mesh", {})))
