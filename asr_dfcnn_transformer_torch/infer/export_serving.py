"""Serving export: inference programs serialised to self-contained
artifacts (the port of ``infer/export_serving.py``).

The live ``Pipeline`` and ``E2EServing`` need the model code, the
checkpoint layout and the vocabulary assets. A serving fleet wants a
versioned artifact that runs the program the model was validated with.
This module traces the inference programs with ``torch.export`` and writes
them, the weights and the vocabularies into one ``.zip``:

    meta.json             format version, artifact kind, decode config,
                          program table, parameter groups, vocab lists,
                          the device the programs were exported on
    params.npz            every weight (stored once, shared by all entry
                          points)
    prog_b{B}_f{F}.pt2    one ``torch.export.save`` blob per (batch,
                          bucket_frames)

The weights are INPUTS of each program, never constants: each entry point
is traced as ``fn(params, signals [B, samples] f32, lengths [B] i32)``
through ``torch.func.functional_call``, so six entry points do not hold
six copies of the LM.

Two artifact kinds:

- ``am_lm`` (``export_pipeline``): fbank -> AM -> CTC decode -> LM argmax
  (``pipeline.pipeline_program``, the body the live ``Pipeline`` runs).
  Served by :class:`ServingPipeline`.
- ``e2e`` (``export_e2e``): fbank -> LFR -> SpeechTransformer encoder ->
  KV-cached decode, greedy or beam (``e2e_serving.e2e_program``). Served
  by :class:`E2EServing` (``infer.ArtifactE2EServing``: ``infer``'s own
  ``E2EServing`` is the live e2e server).

The kernels on these programs (``log_mel``, ``cmvn``,
``masked_attention``, ``topk_last``, ``beam_search``,
``dual_axis_attention``, ``fused_ffn``) are ``torch.library`` custom ops
(``kernels.OPS``): the programs call them, so loading an artifact imports
the port's kernel op library (``asr_dfcnn_transformer_torch.kernels``),
and nothing of ``models/`` or ``train/``; no checkpoint and no asset file.
A program bakes the device of the tensors it creates, so an artifact runs
on the device it was exported on (``meta["device"]``); there is no
cross-lowering to another device.

Larger batches are served in chunks of the largest exported batch size;
frame counts pick the smallest exported bucket that fits (the largest
bucket truncates longer signals, like the live ``recognize_signal``).
"""

from __future__ import annotations

import io
import json
import os
import time
import zipfile
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

import asr_dfcnn_transformer_torch.kernels  # noqa: F401  (registers the ops)
from asr_dfcnn_transformer_torch.audio.fbank import (frames_for_samples,
                                                     samples_for_frames)
from asr_dfcnn_transformer_torch.core.vocab import Vocab, build_vocab

_FORMAT_VERSION = 1
#: parameter types that params.npz holds as themselves
_NPZ_DTYPES = (torch.float32, torch.float64, torch.float16, torch.int64,
               torch.int32, torch.int16, torch.int8, torch.uint8, torch.bool)
#: tensors of the e2e decode state that each step program carries
STATE_SIZES = {"greedy": 4, "beam": 5}


class _Program(torch.nn.Module):
    """``body(*models, *args)`` with the models as submodules, so that
    ``functional_call`` can put a parameter dict in their place."""

    def __init__(self, body, **models):
        super().__init__()
        self._body = body
        self._names = tuple(models)
        for name, model in models.items():
            if model is not None:
                self.add_module(name, model)

    def forward(self, *args):
        models = [getattr(self, n, None) for n in self._names]
        return self._body(*models, *args)


class _Traced(torch.nn.Module):
    """What ``torch.export`` traces: the program's weights come in as a
    dict argument. The program is held outside the module tree, so none
    of its parameters is lifted into the exported program's state."""

    def __init__(self, program: _Program):
        super().__init__()
        self._program = [program]

    def forward(self, params: Dict[str, torch.Tensor], *args):
        return torch.func.functional_call(self._program[0], params, args)


def _weights(models: dict) -> Dict[str, torch.Tensor]:
    """Every parameter and buffer of the models by name, model by model:
    the order of ``params.npz``, in which ``_read_artifact`` rebuilds the
    dict (a program checks its inputs' order). A type that ``np.savez``
    would keep only as raw bytes (bfloat16) is refused here, at export,
    not at some later load."""
    out = {}
    for group, model in models.items():
        if model is None:
            continue
        for name, t in [*model.named_parameters(), *model.named_buffers()]:
            if t.dtype not in _NPZ_DTYPES:
                raise ValueError(
                    f"param {group}.{name} has non-npz-portable dtype "
                    f"{t.dtype}; cast params to float32 before export")
            out[f"{group}.{name}"] = t.detach()
    return out


def _check_platforms(platforms: Optional[Sequence[str]],
                     device: torch.device) -> List[str]:
    """The JAX exporter's ``platforms``: here only the exporting device's
    own type can be named."""
    if platforms and list(platforms) != [device.type]:
        raise ValueError(
            f"--serve-platforms {','.join(platforms)}: a torch.export "
            f"program runs on the device it was exported on; this export "
            f"runs on {device.type}, so the only platform is "
            f"{device.type!r} (export on a {'/'.join(platforms)} host "
            f"for that device)")
    return [device.type]


def _export(body, models: dict, weights, args) -> Tuple[bytes, float]:
    """One program ``body(*models, *args)`` with the weights as its first
    argument -> (its ``torch.export.save`` blob, the export's wall
    seconds: trace + serialise)."""
    t0 = time.perf_counter()
    with torch.no_grad():
        ep = torch.export.export(_Traced(_Program(body, **models)),
                                 (weights, *args), strict=False)
    # save would keep the example inputs, the weights among them: one
    # more copy of them in every program
    ep.example_inputs = None
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue(), time.perf_counter() - t0


def _entry_points(batch_sizes, buckets, win, hop):
    """(batch, bucket, samples) for every exported pair."""
    for bucket in sorted(set(int(b) for b in buckets)):
        if bucket % 8:
            raise ValueError(f"bucket_frames must be multiples of 8, "
                             f"got {bucket}")
        for batch in sorted(set(int(b) for b in batch_sizes)):
            yield batch, bucket, samples_for_frames(bucket, win, hop)


def _example(batch: int, samples: int, device: torch.device):
    return (torch.zeros((batch, samples), dtype=torch.float32,
                        device=device),
            torch.full((batch,), samples, dtype=torch.int32, device=device))


def _write_artifact(path, meta, weights: Dict[str, torch.Tensor], blobs):
    """weights {"<group>.<name>": tensor} -> params.npz keys
    ``{group}/{i:04d}``; meta["param_groups"] holds the counts and
    meta["param_names"] the names, in that order."""
    groups: Dict[str, List[str]] = {}
    for key in weights:
        groups.setdefault(key.split(".", 1)[0], []).append(key)
    arrays = {}
    for g, keys in groups.items():
        for i, key in enumerate(keys):
            arrays[f"{g}/{i:04d}"] = weights[key].cpu().numpy()
    meta = dict(meta, version=_FORMAT_VERSION,
                param_groups={g: len(k) for g, k in groups.items()},
                param_names={g: [k.split(".", 1)[1] for k in keys]
                             for g, keys in groups.items()})
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    npz = io.BytesIO()
    np.savez(npz, **arrays)
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as z:
        z.writestr("meta.json", json.dumps(meta, ensure_ascii=False))
        z.writestr("params.npz", npz.getvalue())
        for name, blob in blobs.items():
            z.writestr(name, blob)
    return meta


def _resolve_device(meta, device) -> torch.device:
    """The artifact's device; a ``device`` that differs raises, as does an
    artifact exported on CUDA where there is none."""
    dev = torch.device(meta["device"])
    if device is not None and torch.device(device).type != dev.type:
        raise ValueError(f"this artifact runs on {dev.type}, where it was "
                         f"exported, not on {torch.device(device).type}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("this artifact was exported on cuda and there is "
                           "no CUDA device")
    return dev


def _read_artifact(path, kind: str, device=None):
    """(meta, weights on the artifact's device, {(batch, bucket): {part:
    the program's saved bytes}}); parts are "file" (the program, for e2e
    its start), "step" and "finish" (e2e only). A program is deserialised
    at its first call (``_ArtifactBase._call``)."""
    with zipfile.ZipFile(path, "r") as z:
        meta = json.loads(z.read("meta.json"))
        if meta["version"] != _FORMAT_VERSION:
            raise ValueError(
                f"unsupported artifact version {meta['version']}")
        if meta.get("kind", "am_lm") != kind:
            raise ValueError(f"artifact kind {meta.get('kind')!r} is not "
                             f"{kind}; use load_artifact()")
        dev = _resolve_device(meta, device)
        npz = np.load(io.BytesIO(z.read("params.npz")))
        params = {}
        for g, names in meta["param_names"].items():
            for i, name in enumerate(names):
                params[f"{g}.{name}"] = torch.from_numpy(
                    npz[f"{g}/{i:04d}"]).to(dev)
        blobs = {(p["batch"], p["bucket"]):
                 {part: z.read(p[part])
                  for part in ("file", "step", "finish") if part in p}
                 for p in meta["programs"]}
    return meta, params, blobs


def export_pipeline(pipeline, path: str, *,
                    batch_sizes: Sequence[int] = (1, 8),
                    buckets: Sequence[int] = (128, 512, 1600),
                    platforms: Optional[Sequence[str]] = None) -> dict:
    """Write ``pipeline``'s inference programs + weights + vocabs to
    ``path`` (a zip), one entry point per (batch, bucket) pair, on the
    pipeline's device. Returns the meta dict that was written; its
    ``export_seconds`` holds each program's export wall (trace +
    serialise)."""
    from asr_dfcnn_transformer_torch.infer.pipeline import pipeline_program

    cfg = pipeline.fbank_cfg
    platforms = _check_platforms(platforms, pipeline.device)

    def body_for_bucket(bucket):
        def body(am, lm, signals, lengths):
            pny, pny_len, han = pipeline_program(
                am, lm, signals, lengths, bucket, fbank_cfg=cfg,
                decode=pipeline.decode, beam_width=pipeline.beam_width,
                lm_max_len=pipeline.lm_max_len)
            if han is None:  # an exported signature is static
                han = torch.zeros_like(pny)
            return pny, pny_len, han
        return body

    models = {"am": pipeline.am_model, "lm": pipeline.lm_model}
    weights = _weights(models)
    programs, blobs, walls = [], {}, {}
    for batch, bucket, samples in _entry_points(batch_sizes, buckets,
                                                cfg.win_len, cfg.hop):
        name = f"prog_b{batch}_f{bucket}.pt2"
        blobs[name], walls[name] = _export(
            body_for_bucket(bucket), models, weights,
            _example(batch, samples, pipeline.device))
        programs.append({"batch": batch, "bucket": bucket,
                         "samples": samples, "file": name})
    meta = {
        "kind": "am_lm",
        "decode": pipeline.decode,
        "beam_width": pipeline.beam_width,
        "feature_dim": cfg.nfilt,
        "win_len": cfg.win_len,
        "hop": cfg.hop,
        "lm_max_len": pipeline.lm_max_len,
        "has_lm": pipeline.lm_model is not None,
        "platforms": platforms,
        "device": pipeline.device.type,
        "programs": programs,
        "acoustic_vocab": list(pipeline.av.symbols),
        "language_vocab": (list(pipeline.lv.symbols)
                           if pipeline.lv is not None else None),
    }
    out = _write_artifact(path, meta, weights, blobs)
    return dict(out, export_seconds=walls)


def export_e2e(model, path: str, *, vocab: Vocab, feature_dim: int = 80,
               lfr_m: int = 4, lfr_n: int = 3, decode: str = "greedy",
               beam_width: int = 3, lp_alpha: float = 0.6, max_len: int = 64,
               batch_sizes: Sequence[int] = (1, 8),
               buckets: Sequence[int] = (128, 512, 1600),
               platforms: Optional[Sequence[str]] = None) -> dict:
    """Write the end-to-end SpeechTransformer's recognition program:
    fbank -> LFR -> encoder -> KV-cached decode (greedy, or the
    length-penalised beam of ``beam_width``), on the model's device.
    ``vocab`` is the e2e hanzi vocab (pad / sos / eos first).

    Each entry point is three programs: the start (fbank -> encoder ->
    the decode state before step 0; ``file``), one decode ``step`` whose
    position is a tensor argument, run ``max_len`` times by the loader,
    and the ``finish`` (ids and lengths). Tracing the decode as one
    program would unroll its ``max_len`` steps into one graph."""
    from asr_dfcnn_transformer_torch.audio.fbank import FbankConfig
    from asr_dfcnn_transformer_torch.infer.e2e_serving import (e2e_finish,
                                                                e2e_start,
                                                                e2e_step)

    cfg = FbankConfig(nfilt=feature_dim)
    device = next(model.parameters()).device
    platforms = _check_platforms(platforms, device)
    model.eval()
    kw = dict(fbank_cfg=cfg, lfr_m=lfr_m, lfr_n=lfr_n, decode=decode,
              beam_width=beam_width, max_len=max_len)
    n_state = STATE_SIZES[decode]

    def start_for_bucket(bucket):
        def start(e2e, signals, lengths):
            state, consts = e2e_start(e2e, signals, lengths, bucket, **kw)
            return (*state, *consts)
        return start

    def step(e2e, *args):
        state, consts, i = args[:n_state], args[n_state:-1], args[-1]
        return e2e_step(e2e, state, consts, i, decode=decode)

    def finish(e2e, *state):
        return e2e_finish(state, decode=decode, lp_alpha=lp_alpha)

    models = {"e2e": model}
    weights = _weights(models)
    programs, blobs, walls = [], {}, {}
    for batch, bucket, samples in _entry_points(batch_sizes, buckets,
                                                cfg.win_len, cfg.hop):
        start = start_for_bucket(bucket)
        args = _example(batch, samples, device)
        with torch.no_grad():
            flat = start(model, *args)
        entry = {"batch": batch, "bucket": bucket, "samples": samples}
        for part, body, ex in (
                ("file", start, args),
                ("step", step, (*flat, torch.zeros((), dtype=torch.int64,
                                                   device=device))),
                ("finish", finish, flat[:n_state])):
            name = (f"prog_b{batch}_f{bucket}.pt2" if part == "file"
                    else f"prog_b{batch}_f{bucket}_{part}.pt2")
            blobs[name], walls[name] = _export(body, models, weights, ex)
            entry[part] = name
        programs.append(entry)
    meta = {
        "kind": "e2e",
        "decode": decode,
        "beam_width": beam_width,
        "lp_alpha": lp_alpha,
        "max_len": max_len,
        "feature_dim": feature_dim,
        "win_len": cfg.win_len,
        "hop": cfg.hop,
        "lfr_m": lfr_m,
        "lfr_n": lfr_n,
        "state_size": n_state,
        "platforms": platforms,
        "device": device.type,
        "programs": programs,
        "language_vocab": list(vocab.symbols),
    }
    out = _write_artifact(path, meta, weights, blobs)
    return dict(out, export_seconds=walls)


class _ArtifactBase:
    """Shared program selection, padding and chunking."""

    def __init__(self, meta, blobs, params: Dict[str, torch.Tensor]):
        self.meta = meta
        self.device = torch.device(meta["device"])
        self._blobs = blobs                  # (batch, bucket) -> {part: bytes}
        self._params = params
        self._calls = {}
        self._batches = sorted({b for b, _ in blobs})
        self._buckets = sorted({f for _, f in blobs})

    def _pick_bucket(self, frames: int) -> int:
        for f in self._buckets:
            if frames <= f:
                return f
        return self._buckets[-1]             # truncate overlong signals

    def exported(self, batch: int, bucket: int) -> dict:
        """{part: ExportedProgram} of one entry point, deserialised."""
        return {part: torch.export.load(io.BytesIO(blob))
                for part, blob in self._blobs[(batch, bucket)].items()}

    def _call(self, batch: int, bucket: int) -> dict:
        key = (batch, bucket)
        if key not in self._calls:
            self._calls[key] = {part: ep.module() for part, ep in
                                self.exported(batch, bucket).items()}
        return self._calls[key]

    def _run(self, programs: dict, signals: torch.Tensor,
             lengths: torch.Tensor):
        return programs["file"](self._params, signals, lengths)

    def _run_padded(self, signals: np.ndarray, lengths: np.ndarray):
        """Pad / bucket one sub-batch (n <= the largest exported batch)
        and run it -> (numpy outputs, the true row count)."""
        n = signals.shape[0]
        # framing from the artifact (the exported fbank's): the bucket
        # choice must match the program's framing
        win = self.meta.get("win_len", 400)
        hop = self.meta.get("hop", 160)
        bucket = self._pick_bucket(frames_for_samples(int(lengths.max()),
                                                      win, hop))
        samples = samples_for_frames(bucket, win, hop)
        batch = next(b for b in self._batches if b >= n)
        buf = np.zeros((batch, samples), np.float32)
        m = min(signals.shape[1], samples)
        buf[:n, :m] = signals[:, :m]
        lens = np.zeros((batch,), np.int32)
        lens[:n] = np.minimum(lengths, samples)
        programs = self._call(batch, bucket)
        with torch.inference_mode():
            outs = self._run(programs, torch.from_numpy(buf).to(self.device),
                             torch.from_numpy(lens).to(self.device))
        # the inputs are checked against the program's signature at its
        # first call; every later call has the same layout (the check
        # walks every weight: ~5 ms a call at 300 of them)
        for module in programs.values():
            module.validate_inputs = False
        return tuple(o.cpu().numpy() for o in outs), n

    def _chunked(self, signals: np.ndarray, lengths: np.ndarray):
        """Yield (outputs, n) per chunk over the whole batch."""
        signals = np.asarray(signals, np.float32)
        lengths = np.asarray(lengths, np.int32)
        if signals.shape[0] == 0:
            raise ValueError("empty batch")
        max_b = self._batches[-1]
        for i in range(0, signals.shape[0], max_b):
            yield self._run_padded(signals[i:i + max_b],
                                   lengths[i:i + max_b])


class ServingPipeline(_ArtifactBase):
    """Artifact-only AM -> LM inference: ``load`` + ``recognize_*`` with no
    model code, checkpoint or vocabulary asset."""

    def __init__(self, meta, blobs, params):
        super().__init__(meta, blobs, params)
        self.acoustic_vocab = build_vocab(meta["acoustic_vocab"])
        self.language_vocab = (build_vocab(meta["language_vocab"])
                               if meta["language_vocab"] is not None
                               else None)

    @classmethod
    def load(cls, path: str, device=None) -> "ServingPipeline":
        meta, params, blobs = _read_artifact(path, "am_lm", device)
        return cls(meta, blobs, params)

    def recognize_batch(self, signals: np.ndarray, lengths: np.ndarray
                        ) -> Tuple[np.ndarray, np.ndarray,
                                   Optional[np.ndarray]]:
        """signals [B, S] float32 + lengths [B] -> (pinyin ids [B, L],
        pinyin lengths [B], hanzi ids [B, L] or None). Batches above the
        largest exported size are served in chunks; smaller ones are
        zero-padded to the smallest exported size that fits."""
        has_lm = self.meta["has_lm"]
        pny, pln, han = [], [], []
        for (p, l, h), n in self._chunked(signals, lengths):
            pny.append(p[:n])
            pln.append(l[:n])
            han.append(h[:n])
        return (np.concatenate(pny), np.concatenate(pln),
                np.concatenate(han) if has_lm else None)

    def recognize_signal(self, signal: np.ndarray
                         ) -> Tuple[List[str], str]:
        """One utterance -> (pinyin syllables, hanzi string), the
        artifact-only counterpart of ``Pipeline.recognize_signal``."""
        sig = np.asarray(signal, np.float32)[None, :]
        pny, pln, han = self.recognize_batch(
            sig, np.array([sig.shape[1]], np.int32))
        k = int(pln[0])
        pinyin = self.acoustic_vocab.decode(pny[0][:k])
        hanzi = ""
        if han is not None and self.language_vocab is not None:
            hanzi = "".join(self.language_vocab.decode(han[0][:k]))
        return pinyin, hanzi


class E2EServing(_ArtifactBase):
    """Artifact-only end-to-end SpeechTransformer recognition."""

    def __init__(self, meta, blobs, params):
        super().__init__(meta, blobs, params)
        self.language_vocab = build_vocab(meta["language_vocab"])
        self._steps = [torch.tensor(i, dtype=torch.int64, device=self.device)
                       for i in range(meta["max_len"])]

    def _run(self, programs, signals, lengths):
        """The start program, every decode step, then the finish."""
        n_state = self.meta["state_size"]
        flat = programs["file"](self._params, signals, lengths)
        state, consts = tuple(flat[:n_state]), tuple(flat[n_state:])
        for i in self._steps:
            state = tuple(programs["step"](self._params, *state, *consts, i))
        return programs["finish"](self._params, *state)

    @classmethod
    def load(cls, path: str, device=None) -> "E2EServing":
        meta, params, blobs = _read_artifact(path, "e2e", device)
        return cls(meta, blobs, params)

    def recognize_batch(self, signals: np.ndarray, lengths: np.ndarray
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """signals [B, S] float32 + lengths [B] -> (hanzi ids [B, L],
        lengths [B])."""
        ids, lens = [], []
        for (i, l), n in self._chunked(signals, lengths):
            ids.append(i[:n])
            lens.append(l[:n])
        return np.concatenate(ids), np.concatenate(lens)

    def recognize_signal(self, signal: np.ndarray) -> str:
        """One utterance -> hanzi string."""
        sig = np.asarray(signal, np.float32)[None, :]
        ids, lens = self.recognize_batch(
            sig, np.array([sig.shape[1]], np.int32))
        return "".join(self.language_vocab.decode(ids[0][:int(lens[0])]))


def load_artifact(path: str, device=None):
    """Open either artifact kind: ServingPipeline (am_lm) or E2EServing
    (e2e), on the device it was exported on (``device``, when given, must
    name that device's type)."""
    with zipfile.ZipFile(path, "r") as z:
        kind = json.loads(z.read("meta.json")).get("kind", "am_lm")
    return (E2EServing if kind == "e2e" else ServingPipeline).load(
        path, device)
