"""The port's CLI (``train/cli.py``) driven end to end on the synthetic
corpus with small models on the CPU (``--platform cpu``): the counterparts
of tests/test_cli.py's drives, then the JAX CLI's trained workdir and TF1
exports evaluated by the port's CLI."""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from asr_dfcnn_transformer_torch.convert import state_dict_to_flax
from asr_dfcnn_transformer_torch.infer import Pipeline
from asr_dfcnn_transformer_torch.infer import tf_ckpt
from asr_dfcnn_transformer_torch.train import cli
from asr_dfcnn_transformer_torch.train.identity import ModelIdentityError
from tests._torch_cpu import use_two_threads

use_two_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--synthetic", "16", "--small", "--batch-size", "8",
         "--platform", "cpu"]
TRAIN = SMALL + ["--epochs", "1", "--lr", "1e-3"]
ACC = re.compile(r"^\*\[Test Result\] .*accuracy ratio: .*$", re.M)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("torchcliwork"))


def _n_logged(path):
    with open(path, encoding="utf-8") as f:
        lines = f.read().splitlines()
    return len(lines), sum(line.startswith("原文拼音结果") for line in lines)


def _flat(tree, prefix=()):
    if not isinstance(tree, dict):
        return {prefix: tree}
    return {k2: v2 for k, v in tree.items()
            for k2, v2 in _flat(v, prefix + (k,)).items()}


def test_cli_am_train(workdir):
    cli.main(["am", "--workdir", workdir] + TRAIN)
    assert os.path.exists(os.path.join(workdir, "am_metrics.jsonl"))
    assert os.path.exists(os.path.join(workdir, "ckpt_am", "0.pt"))
    with open(os.path.join(workdir, "ckpt_am", "identity.json")) as f:
        stamp = json.load(f)
    assert stamp["class"] == "SEDFCNN"
    assert stamp["fields"]["stage_features"] == [4, 4, 8, 8, 8]


def test_cli_lm_train(workdir):
    cli.main(["lm", "--workdir", workdir] + TRAIN)
    assert os.path.exists(os.path.join(workdir, "lm_metrics.jsonl"))
    assert os.path.exists(os.path.join(workdir, "ckpt_lm", "identity.json"))


@pytest.mark.parametrize("decode", ["greedy", "beam"])
def test_cli_eval(workdir, capsys, decode):
    cli.main(["eval", "--workdir", workdir, "--decode", decode] + SMALL)
    out = capsys.readouterr().out
    assert len(ACC.findall(out)) == 2
    assert "拼音 word accuracy ratio" in out and "汉字 word" in out
    n_lines, n_utts = _n_logged(os.path.join(workdir, "pred", "pred_log"))
    assert n_utts > 0 and n_lines == 4 * n_utts + 2


def test_cli_eval_wrong_model_fails_loudly(workdir):
    """eval --model must match what `am` trained (the identity stamp), and
    names the port does not build fail naming their ROADMAP item."""
    with pytest.raises(ModelIdentityError, match="se_first"):
        cli.main(["eval", "--workdir", workdir, "--model", "se_dfcnn_pre"]
                 + SMALL)
    for name in ("dfcnn", "bigru", "keras_dfcnn"):
        with pytest.raises(ValueError, match="ROADMAP"):
            cli.main(["eval", "--workdir", workdir, "--model", name] + SMALL)


def test_cli_infer(workdir, capsys):
    wav = os.path.join(workdir, "synthetic", "wav", "test", "utt_0.wav")
    cli.main(["infer", "--workdir", workdir, "--wav", wav] + SMALL)
    out = capsys.readouterr().out
    assert "拼音:" in out and "汉字:" in out


def test_cli_eval_lm(workdir, capsys):
    cli.main(["eval-lm", "--workdir", workdir] + SMALL)
    out = capsys.readouterr().out
    assert "汉字 word accuracy ratio" in out
    assert os.path.exists(os.path.join(workdir, "pred", "pred_lm_log"))


def test_cli_e2e_train(workdir):
    cli.main(["e2e", "--workdir", workdir] + TRAIN)
    assert os.path.exists(os.path.join(workdir, "e2e_metrics.jsonl"))
    assert os.path.exists(os.path.join(workdir, "ckpt_e2e",
                                       "identity.json"))


@pytest.mark.parametrize("decode", ["greedy", "beam"])
def test_cli_eval_e2e(workdir, capsys, decode):
    cli.main(["eval-e2e", "--workdir", workdir, "--decode", decode,
              "--beam-width", "3"] + SMALL)
    out = capsys.readouterr().out
    assert "e2e 汉字 word accuracy ratio" in out
    assert f"decode={decode}" in out


def test_cli_export_tf1(workdir):
    """export --format tf1 writes the checkpoint's exact parameters."""
    for what in ("am", "lm"):
        prefix = os.path.join(workdir, "export", f"{what}.ckpt")
        cli.main(["export", "--workdir", workdir, "--what", what,
                  "--out", prefix])
        state = Pipeline._restore(workdir, what, use_best=True)
        want = state_dict_to_flax(state["model"], what)
        got = (tf_ckpt.load_tf1_sedfcnn(prefix, 1536) if what == "am"
               else tf_ckpt.load_tf1_lm(prefix, 1536, 6345, num_blocks=1))
        fw, fg = _flat(want), _flat(got)
        assert set(fw) == set(fg)
        for k in fw:
            np.testing.assert_array_equal(np.asarray(fg[k], np.float32),
                                          fw[k], err_msg=str(k))
    with pytest.raises(SystemExit, match="Queue A 4"):
        cli.main(["export", "--workdir", workdir, "--format", "hdf5",
                  "--out", os.path.join(workdir, "x.hdf5")])


def test_cli_eval_with_tf1_checkpoints(workdir, capsys):
    """eval --am-tf-ckpt (a full-width f32 SE-DFCNN bundle) and
    --lm-tf-ckpt (the exported small LM)."""
    from asr_dfcnn_transformer_torch.models import SEDFCNN, SEDFCNNConfig
    am = SEDFCNN(SEDFCNNConfig(1536, dtype=torch.float32), device="cpu",
                 generator=torch.Generator().manual_seed(0))
    prefix = os.path.join(workdir, "tf1_am", "final_model.ckpt")
    tf_ckpt.write_tf_checkpoint(prefix, tf_ckpt.export_tf1_sedfcnn(
        state_dict_to_flax(am.state_dict(), "am")))
    capsys.readouterr()
    cli.main(["eval", "--workdir", workdir, "--am-tf-ckpt", prefix,
              "--lm-tf-ckpt", os.path.join(workdir, "export", "lm.ckpt")]
             + SMALL)
    assert len(ACC.findall(capsys.readouterr().out)) == 2
    assert os.path.exists(os.path.join(workdir, "pred", "pred_log"))


def test_cli_eval_preserves_config_snapshot(workdir, capsys):
    """eval / infer resolve config defaults but must not overwrite the
    training-time <workdir>/config.json."""
    cfg_path = os.path.join(workdir, "config.json")
    sentinel = '{"_sentinel": "written by the training run"}'
    with open(cfg_path, "w", encoding="utf-8") as f:
        f.write(sentinel)
    cli.main(["eval-lm", "--workdir", workdir] + SMALL)
    capsys.readouterr()
    with open(cfg_path, encoding="utf-8") as f:
        assert f.read() == sentinel


def test_cli_config_file(tmp_path, capsys):
    import dataclasses

    from asr_dfcnn_transformer_torch.core.config import Config
    from asr_dfcnn_transformer_torch.train.factory import config_to_json
    cfg = Config()
    cfg = cfg.replace(am=dataclasses.replace(cfg.am, lr=2e-3))
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(config_to_json(cfg))
    wd = str(tmp_path / "w")
    cli.main(["am", "--workdir", wd, "--synthetic", "8", "--small",
              "--epochs", "1", "--batch-size", "8", "--platform", "cpu",
              "--config", str(cfg_path)])
    snap = json.loads(open(os.path.join(wd, "config.json")).read())
    assert abs(snap["am"]["lr"] - 2e-3) < 1e-9
    lines = [json.loads(line) for line in
             open(os.path.join(wd, "am_metrics.jsonl"))]
    train_lines = [line for line in lines if line.get("split") == "train"]
    assert abs(train_lines[0]["lr"] - 2e-3) < 1e-4


def test_cli_config_reaches_full_width_models(tmp_path, monkeypatch):
    """Without --small the models come from the resolved config: its
    fused_ffn selector reaches the LM."""
    import dataclasses

    from asr_dfcnn_transformer_torch.core.config import Config
    from asr_dfcnn_transformer_torch.train.factory import config_to_json
    cfg = Config()
    cfg = cfg.replace(lm=dataclasses.replace(cfg.lm, fused_ffn="pallas"))
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(config_to_json(cfg))
    seen = {}

    def fake(args):
        seen["lm"] = cli._lm_model(args, 1536, 6345).config
        seen["am"] = cli._am_model(args, args.model, 1536).config
    monkeypatch.setitem(cli.COMMANDS, "eval", fake)
    cli.main(["eval", "--workdir", str(tmp_path / "w"), "--platform", "cpu",
              "--model", "se_dfcnn_fast", "--config", str(cfg_path)])
    assert seen["lm"].fused_ffn == "pallas" and seen["lm"].num_blocks == 12
    assert seen["am"].space_to_depth and seen["am"].dtype == torch.bfloat16


def test_cli_eval_refuses_missing_checkpoint(tmp_path):
    empty = str(tmp_path / "nothing_here")
    with pytest.raises(SystemExit, match="no LM checkpoint"):
        cli.main(["eval", "--workdir", empty] + SMALL)
    with pytest.raises(SystemExit, match="no end-to-end checkpoint"):
        cli.main(["eval-e2e", "--workdir", empty] + SMALL)
    with pytest.raises(SystemExit, match="no AM checkpoint"):
        cli.main(["export", "--workdir", empty, "--out", empty + "/x"])


def test_cli_needs_cuda_unless_told_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["eval", "--workdir", str(tmp_path), "--synthetic", "4",
                  "--small"])


def test_cli_module_entry_point():
    r = subprocess.run([sys.executable, "-m",
                        "asr_dfcnn_transformer_torch.train.cli", "--help"],
                       env=dict(os.environ, PYTHONPATH=REPO),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    for cmd in ("am", "lm", "e2e", "eval", "eval-lm", "eval-e2e", "infer",
                "export"):
        assert cmd in r.stdout


def test_jax_cli_workdir_evaluated_by_the_port_cli(tmp_path, capsys):
    """The JAX CLI trains a small AM and LM and exports both as TF1
    bundles. The port takes the LM from its bundle (--lm-tf-ckpt) and the
    AM from the JAX checkpoint through convert.flax_checkpoint_to_port
    (--am-tf-ckpt builds the full-width AM in both CLIs); its eval prints
    the JAX CLI eval's accuracy lines on the same weights and writes the
    same pred_log, and its own export of the converted checkpoints is the
    JAX CLI's export, byte for byte."""
    from asr_dfcnn_transformer_tpu.train import cli as jax_cli
    from asr_dfcnn_transformer_tpu.train import identity as jax_identity
    from asr_dfcnn_transformer_tpu.train.checkpoint import (
        CheckpointManager as JaxCheckpointManager)
    from asr_dfcnn_transformer_torch.convert import flax_checkpoint_to_port
    jwd, pwd = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_train = ["--synthetic", "16", "--small", "--batch-size", "8",
                 "--epochs", "1", "--lr", "1e-3"]
    jax_cli.main(["am", "--workdir", jwd] + jax_train)
    jax_cli.main(["lm", "--workdir", jwd] + jax_train)
    for what in ("am", "lm"):
        jax_cli.main(["export", "--workdir", jwd, "--what", what, "--out",
                      os.path.join(jwd, "export", what)])
    lm_bundle = os.path.join(jwd, "export", "lm")
    capsys.readouterr()
    jax_cli.main(["eval", "--workdir", jwd, "--synthetic", "16", "--small",
                  "--batch-size", "8", "--lm-tf-ckpt", lm_bundle])
    want = capsys.readouterr().out

    src = os.path.join(jwd, "ckpt_am")
    flax_checkpoint_to_port(JaxCheckpointManager(src).restore_raw_latest(),
                            jax_identity.read_identity(src),
                            os.path.join(pwd, "ckpt_am"))
    cli.main(["eval", "--workdir", pwd, "--lm-tf-ckpt", lm_bundle] + SMALL)
    got = capsys.readouterr().out
    assert ACC.findall(got) == ACC.findall(want)
    assert len(ACC.findall(got)) == 2
    with open(os.path.join(jwd, "pred", "pred_log"), encoding="utf-8") as a, \
            open(os.path.join(pwd, "pred", "pred_log"),
                 encoding="utf-8") as b:
        assert a.read() == b.read()

    src = os.path.join(jwd, "ckpt_lm")
    flax_checkpoint_to_port(JaxCheckpointManager(src).restore_raw_latest(),
                            jax_identity.read_identity(src),
                            os.path.join(pwd, "ckpt_lm"))
    for what in ("am", "lm"):
        out = os.path.join(pwd, "export", what)
        cli.main(["export", "--workdir", pwd, "--what", what, "--out", out])
        ref = os.path.join(jwd, "export", what)
        for ext in (".index", ".data-00000-of-00001"):
            with open(out + ext, "rb") as a, open(ref + ext, "rb") as b:
                assert a.read() == b.read(), what + ext
