"""Single dataclass config tree: the port's own copy of the JAX package's
``core/config.py`` (the port imports nothing of that package). Field names,
defaults and types are the same, dtypes stay strings, and
``train/factory.py``'s ``config_to_json`` writes the JSON the JAX package
writes; ``tests/test_torch_factory.py`` holds the two copies equal.

Replaces the reference's four argparse-at-import classes
(``util/hparams.py:5-91``: ``AmLmHparams``, ``AmDataHparams``,
``LmDataHparams``, ``TransDataHparams``) and the standalone argparse block of
the end-to-end model (``end2end/model.py:15-54``) with one composable,
immutable tree. Defaults match the reference's hyperparameters exactly so a
like-for-like training run is one ``Config()`` away.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

from asr_dfcnn_transformer_torch.core import constants


@dataclasses.dataclass(frozen=True)
class AmConfig:
    """Acoustic-model hyperparameters (reference util/hparams.py:9-19)."""

    model: str = "se_dfcnn"          # dfcnn | se_dfcnn | se_dfcnn_pre | bigru | ctc_attention
    lr: float = 7e-4                  # am_lr
    batch_size: int = 16              # am_batch_size
    feature_dim: int = constants.FEATURE_DIM
    feature_max_length: int = constants.FEATURE_MAX_LENGTH
    dropout_rate: float = 0.3         # Keras model dropout (cnn_ctc.py:44-47)
    dense_units: int = 128            # cnn_ctc.py:45 post-reshape Dense width
    se_ratio: Tuple[int, ...] = (1, 2, 2, 2, 2)  # SE squeeze ratios per stage (acoustic_model2.py:41-59)
    dtype: str = "bfloat16"           # compute dtype; params stay float32


@dataclasses.dataclass(frozen=True)
class LmConfig:
    """Transformer LM hyperparameters (reference util/hparams.py:20-29)."""

    lr: float = 5e-5                  # lm_lr
    batch_size: int = 64              # lm_batch_size
    num_heads: int = 8
    num_blocks: int = 12
    d_model: int = 512                # hidden_units
    position_max_length: int = 100
    dropout_rate: float = 0.5
    label_smoothing: float = 0.1      # end2end/transformer.py:332-340
    # Reference quirk (end2end/transformer.py:139-141): Q/K/V projections are
    # ReLU-activated and bias-free. parity=True reproduces that; False uses
    # standard linear projections (recommended for fresh training).
    parity_attention: bool = True
    # Pallas backend selectors ("auto" = measured v5e policy; "pallas" /
    # "einsum" force — see MultiHeadAttention.fused / FeedForward.fused)
    fused_attention: str = "auto"
    fused_ffn: str = "auto"
    dtype: str = "bfloat16"


@dataclasses.dataclass(frozen=True)
class E2EConfig:
    """End-to-end speech Transformer (reference end2end/model.py:15-54)."""

    batch_size: int = 8
    feature_dim: int = 80
    d_model: int = 512
    num_heads: int = 8
    num_enc_blocks: int = 6
    num_dec_blocks: int = 6
    dropout_rate: float = 0.1
    lr: float = 3e-4
    beam_size: int = 3                # declared-but-unused in the reference (:38)
    lp_alpha: float = 0.6             # length penalty (reference :39) — we implement it
    position_max_length: int = 512
    label_smoothing: float = 0.1
    lfr_m: int = 4
    lfr_n: int = 3
    fused_attention: str = "auto"     # see MultiHeadAttention.fused
    fused_ffn: str = "auto"           # see FeedForward.fused
    dtype: str = "bfloat16"


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Corpus manifests & front-end knobs (util/hparams.py:37-91)."""

    data_dir: str = "data"            # directory containing {corpus}_{mode}.txt TSVs
    speech_data_root: str = ""        # prefix for wav paths (Const.SpeechDataPath)
    noise_data_root: str = ""         # prefix for augmented wavs (Const.NoiseOutPath)
    corpora: Sequence[str] = ("thchs", "aishell", "aidatatang", "stcmd", "prime")
    use_noise_manifest: bool = False  # include data/noise_data.txt rows
    data_length: Optional[int] = None  # truncate to first N utterances (None = all)
    shuffle: bool = True
    lfr_m: int = 4                    # LFR stack (util/utils.py:7-31)
    lfr_n: int = 3                    # LFR skip
    sample_rate: int = 16000
    # Length bucketing (the replacement for the fixed [B,1600,200,1]
    # zero-pad at data_loader.py:107): buckets are frame-count upper bounds;
    # each bucket is a distinct static shape.
    bucket_bounds: Sequence[int] = (400, 800, 1200, 1600)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimizer / loop knobs (util/hparams.py:9-19, train.py:54-96)."""

    epochs: int = 100
    decay_steps: int = 5000           # 'dacay_step' poly decay horizon
    min_lr: float = 1e-6
    decay_power: float = 0.5
    decay_cycle: bool = True          # tf.train.polynomial_decay(cycle=True)
    log_every: int = 2                # loss print cadence (train.py:72)
    ckpt_dir: str = "checkpoints"
    max_to_keep: int = 5              # tf.train.Saver(max_to_keep=5) (train.py:38)
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device mesh layout: a (data, model) mesh; batch sharded over
    ``data``, the LM/e2e attention heads, FFN and vocab projection over
    ``model``. ``train.factory.build_mesh`` lays it over the process group,
    one process per device."""

    data_axis: str = "data"
    model_axis: str = "model"
    data_parallel: int = -1           # -1 = all remaining devices
    model_parallel: int = 1


@dataclasses.dataclass(frozen=True)
class Config:
    am: AmConfig = dataclasses.field(default_factory=AmConfig)
    lm: LmConfig = dataclasses.field(default_factory=LmConfig)
    e2e: E2EConfig = dataclasses.field(default_factory=E2EConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)
