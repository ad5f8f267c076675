"""The JAX CLI's trained workdir and TF1 exports evaluated by the port's CLI
(split from tests/test_torch_cli.py, whose flags it shares)."""

import os

from asr_dfcnn_transformer_torch.train import cli
from tests._torch_cpu import use_two_threads
from tests.test_torch_cli import ACC, SMALL

use_two_threads()


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
