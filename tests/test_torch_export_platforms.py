"""AM -> LM serving artifacts exported on the CPU for both platforms
(``platforms=("cpu", "cuda")``): the counterpart of the JAX package's
``test_export_cross_platform_lowering``. On the small fixture of
tests/test_torch_export_serving.py (f32, and bf16 with the bf16 logits
head), greedy and beam (the e2e artifact:
tests/test_torch_export_platforms_e2e.py):

- the artifact records both platforms and serves on the CPU the live ids
  exactly, and the JAX artifact's on shared weights by the margin rule;
- every program is device-neutral (``_check_device_neutral``): moved to
  ``meta`` it keeps no tensor, constant or device argument on the CPU and
  runs there to its output shapes, and its graph is the one the same
  entry point traces on ``meta`` weights and inputs, so no Python branch
  on the device was taken while it was traced on the CPU. Two programs
  built to take a CPU route (the bf16 head's old device branch, a CPU-only
  constant) fail that check;
- loading refuses a device the artifact was not exported for and ``cuda``
  where there is none.
"""

import copy
import io
import json
import zipfile
from unittest import mock

import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree
from torch.export.passes import move_to_device_pass

from asr_dfcnn_transformer_tpu.infer import export_serving as jes
from asr_dfcnn_transformer_torch.core import vocab
from asr_dfcnn_transformer_torch.infer import (Pipeline, ServingPipeline,
                                               export_pipeline, load_artifact)
from asr_dfcnn_transformer_torch.infer import export_serving as es
from asr_dfcnn_transformer_torch.kernels import _build
from asr_dfcnn_transformer_torch.models import (SEDFCNN, SEDFCNNConfig,
                                                TransformerLM,
                                                TransformerLMConfig, layers)
from tests._torch_cpu import use_two_threads
from tests.test_torch_export_serving import AM_KW, LM_KW, _margins_ok

use_two_threads()

BOTH = ("cpu", "cuda")
#: name -> (model dtype, logits head, decode)
PIPELINES = {"f32_greedy": (torch.float32, "f32", "greedy"),
             "bf16_beam_bf16_head": (torch.bfloat16, "bf16", "beam")}
BEAM_WIDTH = 4


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The synthetic batch of tests/test_torch_export_serving.py and each
    of ``PIPELINES`` on its seeded weights."""
    from asr_dfcnn_transformer_torch.data import (DataLoader, load_manifests,
                                                  make_synthetic_corpus)
    root = tmp_path_factory.mktemp("platformcorpus")
    data_dir, wav_root, _, _ = make_synthetic_corpus(
        str(root), num_utts=8, num_classes=4, syllables_per_utt=(2, 3),
        tone_ms=200, seed=3)
    av, lv = vocab.acoustic_vocab(), vocab.language_vocab()
    m = load_manifests(data_dir, "test", corpora=("thchs",))
    dl = DataLoader(m, av, lv, speech_root=wav_root, bucket_bounds=(128,))
    batch = next(dl.am_batches(4, shuffle=False))
    pipes = {}
    for name, (dtype, head, decode) in PIPELINES.items():
        gen = torch.Generator().manual_seed(0)
        am = SEDFCNN(SEDFCNNConfig(av.size, dtype=dtype, logits_matmul=head,
                                   **AM_KW), device="cpu", generator=gen)
        lm = TransformerLM(TransformerLMConfig(av.size, lv.size, dtype=dtype,
                                               **LM_KW),
                           device="cpu", generator=gen)
        pipes[name] = Pipeline(am, lm, acoustic_vocab=av, language_vocab=lv,
                               decode=decode, beam_width=BEAM_WIDTH)
    return batch, pipes


@pytest.fixture(scope="module")
def exported(setup, tmp_path_factory):
    """name -> (path, meta) of each pipeline exported on the CPU for both
    platforms, once."""
    _, pipes = setup
    out = {}
    for name, pipe in pipes.items():
        path = str(tmp_path_factory.mktemp("xplat") / f"{name}.zip")
        out[name] = path, export_pipeline(pipe, path, batch_sizes=(4,),
                                          buckets=(128,), platforms=BOTH)
    return out


# ---- the device-neutral check -------------------------------------------

def _programs(path):
    """{file: ExportedProgram} of an artifact, deserialised and not moved."""
    with zipfile.ZipFile(path) as z:
        meta = json.loads(z.read("meta.json"))
        return {p[part]: torch.export.load(io.BytesIO(z.read(p[part])))
                for p in meta["programs"]
                for part in ("file", "step", "finish") if part in p}


def _sig(ep):
    """The graph op by op, its devices left out."""
    def norm(x):
        if isinstance(x, torch.fx.Node):
            return x.name
        if isinstance(x, torch.device):
            return "device"
        if isinstance(x, (list, tuple)):
            return type(x)(norm(y) for y in x)
        if isinstance(x, dict):
            return {k: "device" if k == "device" else norm(v)
                    for k, v in x.items()}
        return x
    return [(n.op, str(n.target), norm(n.args), norm(n.kwargs))
            for n in ep.graph.nodes]


def _on_cpu(x) -> bool:
    if isinstance(x, torch.Tensor):
        return x.device.type == "cpu"
    if isinstance(x, torch.device):
        return x.type == "cpu"
    return isinstance(x, str) and x.split(":")[0] == "cpu"


def _cpu_places(ep):
    """Every place of ``ep`` that names the CPU: state, constants, node
    arguments and values, tensors that get_attr nodes read."""
    found = [k for k, v in [*ep.state_dict.items(), *ep.constants.items()]
             if _on_cpu(v)]
    for gm in ep.graph_module.modules():
        if not isinstance(gm, torch.fx.GraphModule):
            continue
        for n in gm.graph.nodes:
            leaves = pytree.tree_leaves((n.args, n.kwargs, n.meta.get("val")))
            if n.op == "get_attr":
                leaves.append(getattr(gm, n.target))
            if any(_on_cpu(x) for x in leaves):
                found.append(f"{n.name} ({n.target})")
    return found


def _trace(programs_fn):
    """``programs_fn()`` -> (models, entries, meta) traced: every entry
    point's programs, {file: ExportedProgram}."""
    models, entries, _ = programs_fn()
    weights = es._weights(models)
    return {entry[part]: es.trace(body, models, weights, args)
            for entry, parts in entries
            for part, (body, args) in parts.items()}


def _meta_trace(programs_fn):
    """``_trace`` of entry points whose models and inputs lie on ``meta``.
    The wrappers refuse a meta tensor, so their device check is lifted for
    the trace; each op gives its outputs' shapes there through its
    fake."""
    with mock.patch.object(_build, "check_device", lambda *a: None):
        return _trace(programs_fn)


def _check_device_neutral(programs, meta_traced):
    """Each program exported on the CPU: moved to meta, nothing of it is
    on the CPU and it runs on meta inputs to the shapes its trace gave;
    its graph is the one traced on meta (``meta_traced``)."""
    assert set(programs) == set(meta_traced)
    for name, ep in programs.items():
        assert _sig(ep) == _sig(meta_traced[name]), \
            f"{name}: the CPU trace differs from the meta trace"
        want = [tuple(a.meta["val"].shape)
                for a in pytree.tree_leaves(ep.graph.output_node().args)]
        moved = move_to_device_pass(ep, "meta")
        left = _cpu_places(moved)
        assert not left, f"{name}: on the CPU after the move: {left}"
        user = set(moved.graph_signature.user_inputs)
        flat = [torch.empty(n.meta["val"].shape, dtype=n.meta["val"].dtype,
                            device="meta")
                for n in moved.graph.nodes
                if n.op == "placeholder" and n.name in user]
        args, kwargs = pytree.tree_unflatten(flat, moved.call_spec.in_spec)
        outs = pytree.tree_leaves(moved.module()(*args, **kwargs))
        assert [tuple(o.shape) for o in outs] == want, name
        assert all(o.device.type == "meta" for o in outs), name


def _meta_pipeline(pipe):
    return Pipeline(copy.deepcopy(pipe.am_model).to("meta"),
                    copy.deepcopy(pipe.lm_model).to("meta"),
                    acoustic_vocab=pipe.av, language_vocab=pipe.lv,
                    decode=pipe.decode, beam_width=pipe.beam_width)


# ---- the AM -> LM artifact ----------------------------------------------

@pytest.mark.parametrize("name", PIPELINES)
def test_both_platforms_recorded_and_served_on_cpu_exactly(setup, exported,
                                                          name):
    batch, pipes = setup
    path, meta = exported[name]
    assert meta["platforms"] == ["cpu", "cuda"] and meta["device"] == "cpu"
    served = load_artifact(path, device="cpu")
    assert isinstance(served, ServingPipeline)
    assert served.device == torch.device("cpu")
    want = pipes[name].recognize_batch(batch.signals, batch.signal_lengths,
                                       batch.bucket_frames)
    got = served.recognize_batch(batch.signals, batch.signal_lengths)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_cross_platform_artifact_agrees_with_jax_artifact(setup, exported,
                                                         tmp_path):
    """The f32 greedy artifact for both platforms, served on the CPU, and
    the JAX package's cross-lowered artifact of the same weights
    (``platforms=("cpu", "tpu")``, served on its CPU lowering) give the
    same ids wherever the AM's top-2 margin >= 1e-3."""
    from asr_dfcnn_transformer_tpu import models as jm
    from asr_dfcnn_transformer_tpu.core import vocab as jax_vocab
    from asr_dfcnn_transformer_tpu.infer import Pipeline as JaxPipeline
    from tests.test_torch_export_serving import _flax
    import jax.numpy as jnp
    batch, pipes = setup
    pipe = pipes["f32_greedy"]
    jpipe = JaxPipeline(
        jm.SEDFCNN(vocab_size=pipe.av.size, dtype=jnp.float32, **AM_KW),
        _flax(pipe.am_model, "am"),
        jm.TransformerLM(pipe.av.size, pipe.lv.size, dtype=jnp.float32,
                         **LM_KW),
        _flax(pipe.lm_model, "lm"),
        acoustic_vocab=jax_vocab.acoustic_vocab(),
        language_vocab=jax_vocab.language_vocab())
    jpath = str(tmp_path / "jax.asrx")
    jmeta = jes.export_pipeline(jpipe, jpath, batch_sizes=(4,),
                                buckets=(128,), platforms=("cpu", "tpu"))
    assert jmeta["platforms"] == ["cpu", "tpu"]
    want = jes.load_artifact(jpath).recognize_batch(batch.signals,
                                                    batch.signal_lengths)
    got = load_artifact(exported["f32_greedy"][0], device="cpu") \
        .recognize_batch(batch.signals, batch.signal_lengths)
    ok = _margins_ok(pipe, batch)
    assert ok.sum() >= 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[ok], np.asarray(w)[ok])


@pytest.mark.parametrize("name", PIPELINES)
def test_pipeline_programs_are_device_neutral(setup, exported, name):
    """Also: the bf16 logits head's product is ``asr_port::bf16_matmul``
    in the program (cuBLAS on the card), not the CPU's f32 product."""
    _, pipes = setup
    programs = _programs(exported[name][0])
    (ep,) = programs.values()
    ops = {str(n.target) for n in ep.graph.nodes}
    assert ("asr_port.bf16_matmul.default" in ops) == (
        PIPELINES[name][1] == "bf16")
    meta_pipe = _meta_pipeline(pipes[name])
    _check_device_neutral(programs, _meta_trace(
        lambda: es.pipeline_programs(meta_pipe, (4,), (128,))))


def _cpu_route(xb, wb):
    """The bf16 head's product as it was before it became one op: a
    Python branch on the device."""
    if xb.device.type == "cpu":
        return xb.float() @ wb.float().t()
    return torch.mm(xb, wb.t(), out_dtype=torch.float32)


def test_check_catches_a_cpu_route(setup):
    """A program traced on the CPU while the bf16 head branched on the
    device runs on meta and leaves nothing on the CPU once moved, but its
    graph is not the one meta traces: the check fails."""
    _, pipes = setup
    pipe = pipes["bf16_beam_bf16_head"]
    meta_pipe = _meta_pipeline(pipe)
    with mock.patch.object(layers, "bf16_matmul", _cpu_route):
        programs = _trace(lambda: es.pipeline_programs(pipe, (4,), (128,)))
        traced = _meta_trace(
            lambda: es.pipeline_programs(meta_pipe, (4,), (128,)))
    with pytest.raises(AssertionError, match="differs from the meta trace"):
        _check_device_neutral(programs, traced)


def _with_cpu_constant(pipe):
    """``pipeline_programs(pipe)`` whose programs add a tensor made on the
    CPU (no ``device=``) to their hanzi ids."""
    models, entries, meta = es.pipeline_programs(pipe, (4,), (128,))
    for _, parts in entries:
        body, args = parts["file"]

        def body2(am, lm, signals, lengths, body=body):
            pny, pny_len, han = body(am, lm, signals, lengths)
            return pny, pny_len, han + torch.zeros(han.shape, dtype=han.dtype)
        parts["file"] = (body2, args)
    return models, entries, meta


def test_check_catches_a_cpu_only_constant(setup):
    """A program that adds a CPU-only constant traces and runs on the CPU,
    but the check fails: the same entry point cannot be traced on another
    device."""
    batch, pipes = setup
    pipe = pipes["f32_greedy"]
    (ep,) = _trace(lambda: _with_cpu_constant(pipe)).values()
    got = ep.module()(es._weights({"am": pipe.am_model, "lm": pipe.lm_model}),
                      torch.from_numpy(batch.signals),
                      torch.from_numpy(batch.signal_lengths))
    want = pipe.recognize_batch(batch.signals, batch.signal_lengths, 128)
    np.testing.assert_array_equal(got[2].numpy(), want[2])
    meta_pipe = _meta_pipeline(pipe)
    with pytest.raises(RuntimeError, match="device"):
        _check_device_neutral({"prog_b4_f128.pt2": ep}, _meta_trace(
            lambda: _with_cpu_constant(meta_pipe)))


def test_loading_refusals(setup, exported, tmp_path, monkeypatch):
    """An artifact for the CPU alone refuses cuda; one for both loads on
    cuda by default and refuses it where there is no CUDA device, as it
    does when cuda is asked for; no path falls back to the CPU."""
    _, pipes = setup
    pipe = pipes["f32_greedy"]
    cpu_only = str(tmp_path / "cpu.zip")
    meta = export_pipeline(Pipeline(pipe.am_model, acoustic_vocab=pipe.av),
                           cpu_only, batch_sizes=(4,), buckets=(128,))
    assert meta["platforms"] == ["cpu"]
    with pytest.raises(ValueError, match="runs on cpu, the platforms"):
        load_artifact(cpu_only, device="cuda")
    assert load_artifact(cpu_only).device == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    both = exported["f32_greedy"][0]
    for device in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            load_artifact(both, device=device)
    with pytest.raises(ValueError, match="runs on cpu and cuda"):
        load_artifact(both, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda, not on tpu"):
        export_pipeline(pipes["f32_greedy"], str(tmp_path / "x.zip"),
                        batch_sizes=(4,), buckets=(128,),
                        platforms=("cpu", "tpu"))
