"""The port's config tree and model / trainer builders against the JAX
package's: the same JSON both ways, models whose config fields equal the
JAX builders' modules' field for field (every AM name, bigru included;
unknown names, ctc_attention among them, raise as in JAX), the card as
the default device, and a trainer built from ``LmConfig(fused_ffn="pallas")``
that takes a step."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_dfcnn_transformer_tpu.core import config as jax_config
from asr_dfcnn_transformer_tpu.train import factory as jax_factory
from asr_dfcnn_transformer_torch.core import config
from asr_dfcnn_transformer_torch.data import LMBatch
from asr_dfcnn_transformer_torch.train import factory
from tests._torch_cpu import use_two_threads

use_two_threads()

JAX_DTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
SMALL = dict(
    am=dict(dtype="float32"),
    lm=dict(d_model=64, num_heads=4, num_blocks=2, fused_ffn="pallas",
            fused_attention="einsum", dtype="float32"),
    e2e=dict(d_model=32, num_heads=4, num_enc_blocks=1, num_dec_blocks=1,
             fused_ffn="pallas", dtype="float32"))


SECTIONS = {"am": "AmConfig", "lm": "LmConfig", "e2e": "E2EConfig"}


def _configs(**over):
    """(port Config, JAX Config) with the same section overrides."""
    return [mod.Config(**{name: getattr(mod, SECTIONS[name])(**vals)
                          for name, vals in over.items()})
            for mod in (config, jax_config)]


@pytest.mark.parametrize("over", [{}, SMALL])
def test_config_json_matches_jax(over):
    port, jax_cfg = _configs(**over)
    text = factory.config_to_json(port)
    assert text == jax_factory.config_to_json(jax_cfg)
    # each package reads the other's JSON back to the same JSON
    assert factory.config_to_json(factory.config_from_json(
        jax_factory.config_to_json(jax_cfg))) == text
    assert jax_factory.config_to_json(jax_factory.config_from_json(text)) \
        == text


def test_config_fields_match_jax():
    for name in ("AmConfig", "LmConfig", "E2EConfig", "DataConfig",
                 "TrainConfig", "MeshConfig", "Config"):
        ours = {f.name: f.default for f in dataclasses.fields(
            getattr(config, name))}
        theirs = {f.name: f.default for f in dataclasses.fields(
            getattr(jax_config, name))}
        assert ours == theirs, name


def _same_fields(model, jax_module):
    for f in dataclasses.fields(model.config):
        want = getattr(jax_module, f.name)
        got = getattr(model.config, f.name)
        if f.name == "dtype":
            got = JAX_DTYPE[got]
        elif isinstance(got, (tuple, list)):
            got, want = tuple(got), tuple(want)
        assert got == want, f.name


@pytest.mark.parametrize("am", ["se_dfcnn", "se_dfcnn_pre", "se_dfcnn_fast"])
def test_am_builder_matches_jax(am):
    port, jax_cfg = _configs(am=dict(model=am, dtype="float32"))
    model = factory.build_am_model(port, device="cpu")
    _same_fields(model, jax_factory.build_am_model(jax_cfg))


@pytest.mark.parametrize("which", ["lm", "e2e"])
def test_lm_and_e2e_builders_match_jax(which):
    port, jax_cfg = _configs(**{which: SMALL[which]})
    model = getattr(factory, f"build_{which}_model")(port, device="cpu")
    _same_fields(model, getattr(jax_factory, f"build_{which}_model")(jax_cfg))
    assert model.config.fused_ffn == "pallas"
    assert all(m.fused == "pallas" for name, m in model.named_modules()
               if "ffn" in name and hasattr(m, "fused"))
    if which == "e2e":      # the enc_proj input: LFR rows of 4 x 80 bins
        assert model.enc_proj.weight.shape[1] == 80 * 64  # F' 80 x C 64


@pytest.mark.parametrize("am,item", [("dfcnn", "ROADMAP Queue A 4"),
                                     ("keras_dfcnn", "ROADMAP Queue A 4"),
                                     ("bigru", "ROADMAP Queue A 11")])
def test_unported_am_names_their_roadmap_item(am, item):
    """``item``: the ROADMAP item that ported the model. dfcnn and
    keras_dfcnn (Queue A 4) and bigru (Queue A 11) build with the JAX
    factory's fields and class; unknown names raise, ctc_attention among
    them (the JAX factory builds no CTC-attention AM either)."""
    port, jax_cfg = _configs(am=dict(model=am, dtype="float32"))
    model = factory.build_am_model(port, device="cpu")
    _same_fields(model, jax_factory.build_am_model(jax_cfg))
    assert type(model).__name__ == type(
        jax_factory.build_am_model(jax_cfg)).__name__
    if am == "bigru":                 # BiGRUCTC's own dropout, as in JAX
        assert model.config.dropout_rate == 0.2
        assert model.Dense_0.weight.shape[1] == port.am.feature_dim
    for name in ("ctc_attention", "nope"):
        port, jax_cfg = _configs(am=dict(model=name))
        with pytest.raises(ValueError, match="unknown am model"):
            jax_factory.build_am_model(jax_cfg)
        with pytest.raises(ValueError, match="unknown am model"):
            factory.build_am_model(port, device="cpu")
    port, _ = _configs(am=dict(model="nope"))
    with pytest.raises(ValueError, match="unknown am model"):
        factory.build_am_model(port, device="cpu")


def test_builders_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    port, _ = _configs(**SMALL)
    for build in (factory.build_am_model, factory.build_lm_model,
                  factory.build_e2e_model):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build(port)


def test_trainers_from_config(tmp_path):
    """The three trainers take their rates and widths from the config; the
    LM trainer built with ``fused_ffn="pallas"`` takes a step through the
    ``FusedFFN`` Function (its twin here) with finite gradients."""
    port, _ = _configs(**SMALL)
    am = factory.build_am_trainer(port, str(tmp_path / "am"), device="cpu")
    assert am.opt.param_groups[0]["lr"] == pytest.approx(port.am.lr)
    e2e = factory.build_e2e_trainer(port, str(tmp_path / "e2e"),
                                    augment_spec=True, device="cpu")
    assert (e2e.lfr_m, e2e.lfr_n, e2e.fbank_cfg.nfilt) == (4, 3, 80)
    assert e2e.augment_spec is not None
    lm = factory.build_lm_trainer(port, str(tmp_path / "lm"), device="cpu",
                                  generator=torch.Generator().manual_seed(1))
    rng = np.random.default_rng(0)
    ids = rng.integers(1, 1536, (2, 8)).astype(np.int32)
    hanzi = rng.integers(1, 6345, (2, 8)).astype(np.int32)
    out = lm.train_step(LMBatch(ids, hanzi, np.full(2, 8, np.int32),
                                np.ones(2, np.float32)))
    assert np.isfinite(float(out["loss"]))
    grad = lm.model.block0_0_ffn.Dense_0.weight.grad
    assert grad is not None and bool(torch.isfinite(grad).all())
