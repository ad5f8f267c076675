"""The system under test: the port's models, ``Pipeline`` and ``AMTrainer``,
built from a configuration file and loaded with the benchmark's seeded
weights. This is the one module of the benchmark that imports
``asr_dfcnn_transformer_torch``.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import weights

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def vocabs():
    from asr_dfcnn_transformer_torch.core import vocab
    return vocab.acoustic_vocab(), vocab.language_vocab()


def _build(make, device):
    """Build a port model on ``device``. Its own initial draws run on the
    device (a generator there, the device as the default for new tensors),
    since the benchmark's weights replace them."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    with dev:
        return make(dev, gen)


def build_am(cfg: dict, seed: int, device):
    from asr_dfcnn_transformer_torch import models
    a = cfg["am"]
    dtype = DTYPES[cfg["dtype"]]
    if a["family"] == "se_dfcnn":
        conf = models.SEDFCNNConfig(
            a["vocab_size"], stage_features=tuple(a["stage_features"]),
            stage_pool=tuple(a["stage_pool"]), se_ratio=tuple(a["se_ratio"]),
            head_features=a["head_features"], dropout_rate=a["dropout_rate"],
            logits_matmul=a["logits_matmul"], dtype=dtype)
        cls = models.SEDFCNN
    elif a["family"] == "keras_dfcnn":
        conf = models.KerasDFCNNConfig(
            a["vocab_size"], dense_units=a["dense_units"],
            dropout_rate=a["dropout_rate"], logits_matmul=a["logits_matmul"],
            dtype=dtype)
        cls = models.KerasDFCNN
    else:
        raise ValueError(f"unknown acoustic model family {a['family']!r}")
    model = _build(lambda dev, gen: cls(conf, feature_dim=a["feature_dim"],
                                        device=dev, generator=gen), device)
    model.load_state_dict(weights.for_model(cfg, "am", seed, device))
    return model


def build_lm(cfg: dict, seed: int, device):
    from asr_dfcnn_transformer_torch import models
    m = cfg["lm"]
    conf = models.TransformerLMConfig(
        m["input_vocab_size"], m["output_vocab_size"], d_model=m["d_model"],
        num_heads=m["num_heads"], num_blocks=m["num_blocks"],
        position_max_length=m["position_max_length"],
        dropout_rate=m["dropout_rate"], causal=m["causal"],
        parity_attention=m["parity_attention"],
        logits_matmul=m["logits_matmul"], dtype=DTYPES[cfg["dtype"]])
    model = _build(lambda dev, gen: models.TransformerLM(
        conf, device=dev, generator=gen), device)
    model.load_state_dict(weights.for_model(cfg, "lm", seed, device))
    return model


def pipeline(cfg: dict, seed: int, device, decode: str):
    from asr_dfcnn_transformer_torch.infer.pipeline import Pipeline
    av, lv = vocabs()
    return Pipeline(build_am(cfg, seed, device), build_lm(cfg, seed, device),
                    acoustic_vocab=av, language_vocab=lv,
                    feature_dim=cfg["am"]["feature_dim"], decode=decode)


def trainer(cfg: dict, model, workdir: str):
    from asr_dfcnn_transformer_torch.train.trainer import AMTrainer
    tr = cfg["train"]
    return AMTrainer(model, workdir, lr=tr["lr"],
                     decay_steps=tr["decay_steps"], min_lr=tr["min_lr"],
                     feature_dim=cfg["am"]["feature_dim"])


def am_batch(b):
    """A traffic ``Batch`` as the trainers' ``AMBatch``."""
    from asr_dfcnn_transformer_torch.data.batches import AMBatch
    from portbench.traffic import frames_for
    frames = np.array([frames_for(int(x)) for x in b.lengths], np.int32)
    return AMBatch(b.signals, b.lengths, frames, b.labels, b.label_lengths,
                   b.labels, b.label_lengths,
                   np.ones(len(b.lengths), np.float32), b.bucket)
