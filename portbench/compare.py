"""The comparison that decides ``correct``: the program's outputs against the
plain reference, each number beside its limit.

Served and offline cells (front end, AM, CTC decode, LM): for a sample of
finished requests, the reference computes the features and the AM's logits
from the same signals at the same bucket, and the LM's logits over the
served pinyin as its prompt. ``am_gap`` is the widest ``served_gap`` of a
served pinyin sequence (``reference/ctc.py``); ``lm_gap`` the widest gap by
which a served hanzi's logit lies below the reference's best at its
position. Both in logits (nats).

Training cell (CTC loss, gradients, Adam): the reference follows the
program's first three steps from the same weights, batches and dropout
draws. Per leaf, the gap between the program's norm of the first gradient
(from Adam's first moment after one step) and the reference's, over the
larger of the reference's norm of that leaf and the median leaf's; the
same of the parameters' change after three steps. Leaves whose reference
gradient norm is under a thousandth of the median leaf's (moved by
round-off alone) are left out. Compared: ``logit_gap``, the widest gap by
which the logit of the class the program's first training forward puts
first at a frame lies below the reference's best there; ``loss_gap``, the
first step's relative loss gap; ``update_gap``, the median leaf's change
gap. ``grad_gap``, the median leaf's gradient gap, is read and not
compared: no control or fault of this cell reads three times its sound
readings (``PERF.md``). The worst leaf's gaps and the largest loss gap of the three steps
are read beside them (``*_worst``, ``loss_gap_steps``): in bf16 they swing
from seed to seed with the rounding of the squeeze-excite and BatchNorm
leaves' gradients, sums over whole feature maps that mostly cancel, and
with Adam's sign-like first steps (``PERF.md``).

With ``control`` the reference in fp8 stands in the program's place and is
read the same way (``calibrate.py``).
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench import weights
from portbench.reference import ctc as rctc
from portbench.reference import fbank as rfbank
from portbench.reference import models as rm
from portbench.reference.precision import CONTROL, F32, Precision, no_tf32

BLOCK = 8


def served(cfg: dict, seed: int, samples: List[dict], device,
           control: bool = False) -> Dict[str, float]:
    """``samples``: dicts of ``signal`` (the utterance's samples),
    ``bucket``, ``pinyin`` and ``hanzi`` (served id lists). Returns the
    readings; with ``control``, the fp8 reference's in the program's
    place."""
    cap = cfg["lm"]["position_max_length"]
    dt = cfg["dtype"]
    am_fn = rm.acoustic_model(cfg["am"]["family"])
    w_am = weights.for_model(cfg, "am", seed, device)
    w_lm = weights.for_model(cfg, "lm", seed, device)
    am_gap = lm_gap = 0.0
    tokens = 0
    with no_tf32(), torch.no_grad():
        order = sorted(range(len(samples)), key=lambda i: samples[i]["bucket"])
        for j in range(0, len(order), BLOCK):
            block = [samples[i] for i in order[j:j + BLOCK]]
            by_bucket: Dict[int, list] = {}
            for s in block:
                by_bucket.setdefault(s["bucket"], []).append(s)
            for bucket, group in by_bucket.items():
                width = rfbank.samples_for_frames(bucket)
                sig = torch.zeros((len(group), width), device=device)
                lens = torch.tensor([len(s["signal"]) for s in group],
                                    device=device)
                for i, s in enumerate(group):
                    sig[i, :len(s["signal"])] = torch.as_tensor(
                        s["signal"], device=device)
                feats = rfbank.fbank(sig, lens, bucket,
                                     cfg["am"]["feature_dim"])[:, None]
                logits = am_fn(w_am, cfg["am"], feats, F32, dtype=dt)
                in_len = rfbank.logit_lengths(lens, logits.shape[1])
                pinyin = [s["pinyin"] for s in group]
                if control:
                    pinyin = rctc.greedy(am_fn(w_am, cfg["am"], feats,
                                               CONTROL, dtype=dt), in_len, cap)
                for i, y in enumerate(pinyin):
                    lg = logits[i, :int(in_len[i])].double().cpu().numpy()
                    am_gap = max(am_gap, rctc.served_gap(lg, y, cap))
                    tokens += len(y)
                ids = torch.zeros((len(group), cap), dtype=torch.long,
                                  device=device)
                for i, y in enumerate(pinyin):
                    ids[i, :len(y)] = torch.as_tensor(y, device=device)
                ref = rm.lm(w_lm, cfg["lm"], ids, F32, dt)
                if control:
                    served_h = rm.lm(w_lm, cfg["lm"], ids, CONTROL,
                                     dt).argmax(-1)
                else:
                    served_h = torch.zeros_like(ids)
                    for i, s in enumerate(group):
                        served_h[i, :len(s["hanzi"])] = torch.as_tensor(
                            s["hanzi"], device=device)
                gap = ref.max(-1).values - ref.gather(
                    -1, served_h[..., None])[..., 0]
                for i, y in enumerate(pinyin):
                    if len(y):
                        lm_gap = max(lm_gap, float(gap[i, :len(y)].max()))
                        tokens += len(y)
    return {"am_gap": am_gap, "lm_gap": lm_gap, "served_tokens": tokens}


def dropout_keep(cfg: dict, batch: int, bucket: int, gen_seed: int,
                 device) -> torch.Tensor:
    """The keep mask of the SE-DFCNN's dropout before its head, drawn as
    the configuration's training step draws it: uniform [0, 1) of the
    head's input [B, T', F' x C] from a generator on the device seeded for
    the step, kept below 1 - rate."""
    a = cfg["am"]
    pools = sum(bool(p) for p in a["stage_pool"])
    shape = (batch, bucket >> pools,
             (a["feature_dim"] >> pools) * a["head_features"])
    g = torch.Generator(device=torch.device(device)).manual_seed(gen_seed)
    u = torch.rand(shape, generator=g, device=device)
    return u < 1.0 - a["dropout_rate"]


def lr_at(tr: dict, step: int) -> float:
    """``tf.train.polynomial_decay(cycle=True, power=0.5)`` at ``step``."""
    d = tr["decay_steps"]
    horizon = d * max(1.0, np.ceil((step + 1e-8) / d))
    return (tr["lr"] - tr["min_lr"]) * (1 - step / horizon) ** 0.5 + \
        tr["min_lr"]


def _names(cfg: dict) -> List[str]:
    """The trained leaves (the BatchNorm statistics are buffers)."""
    return [n for n, _, kind, _ in rm.param_spec(cfg["am"]["family"],
                                                 cfg["am"])
            if not kind.startswith(("bn_mean", "bn_var"))]


def _head(cfg: dict) -> str:
    """The leaf that makes the logits: the model's last dense kernel."""
    return [n for n, _, kind, _ in rm.param_spec(cfg["am"]["family"],
                                                 cfg["am"])
            if kind == "dense"][-1]


def _step(cfg: dict, w: dict, p: dict, m: dict, v: dict, b, gen_seed: int,
          k: int, device, pr: Precision) -> tuple:
    """The reference's step ``k + 1`` (Adam after ``k`` steps) on batch
    ``b``, updating ``p``, ``m`` and ``v`` in place -> (loss, gradients,
    logits, logit lengths)."""
    tr = cfg["train"]
    b1, b2 = tr["betas"]
    names = list(p)
    sig = torch.as_tensor(b.signals, device=device)
    lens = torch.as_tensor(b.lengths, device=device).long()
    feats = rfbank.fbank(sig, lens, b.bucket, cfg["am"]["feature_dim"])[:, None]
    keep = dropout_keep(cfg, len(b.lengths), b.bucket, gen_seed, device)
    logits = rm.se_dfcnn({**w, **p}, cfg["am"], feats, pr, train=True,
                         keep=keep, dtype=cfg["dtype"])
    in_len = rfbank.logit_lengths(lens, logits.shape[1])
    loss = rctc.ctc_losses(
        logits, in_len, torch.as_tensor(b.labels, device=device),
        torch.as_tensor(b.label_lengths, device=device)).mean()
    grads = dict(zip(names, torch.autograd.grad(loss, [p[n] for n in names])))
    lr = lr_at(tr, k)
    with torch.no_grad():
        for n, g in grads.items():
            m[n].mul_(b1).add_(g, alpha=1 - b1)
            v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
            mh = m[n] / (1 - b1 ** (k + 1))
            vh = v[n] / (1 - b2 ** (k + 1))
            p[n].sub_(lr * mh / (vh.sqrt() + tr["eps"]))
    return float(loss.detach()), grads, logits.detach(), in_len


def train_reference(cfg: dict, seed: int, batches, gen_seeds, device,
                    pr: Precision = F32) -> dict:
    """The reference's first steps from the seed's weights: per-step
    losses, the first gradient, the parameters' change after the steps,
    and the first step's logits."""
    w0 = weights.for_model(cfg, "am", seed, device)
    p = {n: w0[n].clone().requires_grad_(True) for n in _names(cfg)}
    m = {n: torch.zeros_like(x) for n, x in p.items()}
    v = {n: torch.zeros_like(x) for n, x in p.items()}
    losses = []
    with no_tf32():
        for k, (b, gs) in enumerate(zip(batches, gen_seeds)):
            loss, grads, logits, in_len = _step(cfg, w0, p, m, v, b, gs, k,
                                                device, pr)
            losses.append(loss)
            if k == 0:
                g1, first = grads, (logits.cpu(), in_len.cpu())
            del grads, logits
    with torch.no_grad():
        dp = {n: p[n].detach() - w0[n] for n in p}
    return {"losses": losses, "grad": g1, "update": dp,
            "logits": first[0], "in_len": first[1], "head": _head(cfg)}


def train_reference_next(cfg: dict, seed: int, state: dict, steps, k: int,
                         device, pr: Precision = F32) -> dict:
    """The reference's steps ``k + 1``, ``k + 2``, ... (``steps``: their
    (batch, dropout seed)) from the program's parameters and Adam moments
    after ``k`` steps (``state``: ``params``, ``exp_avg``, ``exp_avg_sq``),
    with the learning rate and bias corrections of its own count: the first
    step's loss, gradient and parameters' change, and the second's loss."""
    w0 = weights.for_model(cfg, "am", seed, device)
    p = {n: x.detach().clone().requires_grad_(True)
         for n, x in state["params"].items()}
    m = {n: x.clone() for n, x in state["exp_avg"].items()}
    v = {n: x.clone() for n, x in state["exp_avg_sq"].items()}
    losses = []
    with no_tf32():
        for j, (batch, gen_seed) in enumerate(steps):
            loss, grads, _, _ = _step(cfg, w0, p, m, v, batch, gen_seed,
                                      k + j, device, pr)
            losses.append(loss)
            if j == 0:
                first = grads
                with torch.no_grad():
                    dp = {n: p[n].detach() - state["params"][n] for n in p}
            del grads
    return {"loss": losses[0], "grad": first, "update": dp,
            "fresh_loss": losses[1]}


def _norms(t: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(x.double().norm()) for n, x in t.items()}


def _leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
               leaves: List[str]) -> np.ndarray:
    """Per leaf, the gap of the program's norm to the reference's over the
    larger of the reference's norm and the median leaf's."""
    pn, rn = _norms({n: prog[n] for n in leaves}), _norms(
        {n: ref[n] for n in leaves})
    med = float(np.median(list(rn.values())))
    return np.array([abs(pn[n] - rn[n]) / max(rn[n], med) for n in leaves])


def _dir_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              leaves: List[str]) -> np.ndarray:
    """Per leaf, 1 - the cosine between the program's tensor and the
    reference's (0 alike, 1 orthogonal or either zero)."""
    out = []
    for n in leaves:
        b = ref[n].double().flatten()
        a = prog[n].to(b.device, torch.float64).flatten()
        den = float(a.norm() * b.norm())
        out.append(1.0 - float(a @ b) / den if den > 0 else 1.0)
    return np.array(out)


def frame_gap(ref_logits: torch.Tensor, best: torch.Tensor,
              in_len: torch.Tensor) -> float:
    """The widest gap by which the logit of a frame's chosen class lies
    below the reference's best class of that frame, over valid frames."""
    gap = ref_logits.max(-1).values - ref_logits.gather(
        -1, best.long()[..., None])[..., 0]
    valid = torch.arange(gap.shape[1])[None, :] < in_len[:, None]
    return float(gap[valid].max())


def train_gaps(prog: dict, ref: dict) -> Dict[str, float]:
    """The training numbers of the program's (or the control's) readings
    against the reference's: the first steps (``prog``/``ref`` ``grad``,
    ``update``, ``losses``, and the program's first ``argmax`` or the
    control's ``logits``) and the step after the window (``next``)."""
    rg = _norms(ref["grad"])
    med = float(np.median(list(rg.values())))
    leaves = [n for n, g in rg.items() if g >= 1e-3 * med]
    grad = _leaf_gaps(prog["grad"], ref["grad"], leaves)
    update = _leaf_gaps(prog["update"], ref["update"], leaves)
    loss = [abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                ref["losses"])]
    best = prog["argmax"] if "argmax" in prog else prog["logits"].argmax(-1)
    out = {
        "logit_gap": frame_gap(ref["logits"], best, ref["in_len"]),
        "loss_gap": loss[0],
        "grad_dir_gap": float(np.median(_dir_gaps(prog["grad"], ref["grad"],
                                                  leaves))),
        "update_gap": float(np.median(update)),
        "grad_gap": float(np.median(grad)), "loss_gap_steps": max(loss),
        "grad_gap_worst": float(grad.max()),
        "update_gap_worst": float(update.max()),
        "leaves_compared": len(leaves),
    }
    head = [ref["head"]] if "head" in ref else []
    if head:
        out["head_grad_dir_gap"] = float(_dir_gaps(prog["grad"], ref["grad"],
                                                   head)[0])
    pn, rnx = prog.get("next"), ref.get("next")
    if pn is not None and rnx is not None:
        out.update({
            "window_unmoved": sum(bool(pn["unmoved"][n]) for n in leaves),
            "next_loss_gap": abs(pn["loss"] - rnx["loss"]) / abs(rnx["loss"]),
            "fresh_loss_gap": abs(pn["fresh_loss"] - rnx["fresh_loss"])
            / abs(rnx["fresh_loss"]),
            "next_grad_dir_gap": float(np.median(_dir_gaps(
                pn["grad"], rnx["grad"], leaves))),
            "next_update_gap": float(np.median(_leaf_gaps(
                pn["update"], rnx["update"], leaves))),
        })
        if head:
            out["next_head_grad_dir_gap"] = float(_dir_gaps(
                pn["grad"], rnx["grad"], head)[0])
    return out


def judge(readings: Dict[str, float], limits: Dict[str, float],
          missing: int = 0, failed: int = 0) -> tuple:
    """(correct, {name: {"value", "limit"}}). Every number the cell's
    limits name is compared; a request or step that never came or failed
    (a non-finite loss), and a number that is not finite, fail."""
    checks = {}
    ok = missing == 0 and failed == 0
    for name, limit in limits.items():
        value = readings.get(name)
        good = value is not None and np.isfinite(value) and value <= limit
        ok = ok and bool(good)
        checks[name] = {"value": value, "limit": limit}
    checks["missing"] = {"value": missing, "limit": 0}
    checks["failed"] = {"value": failed, "limit": 0}
    return ok, checks


def check_lines(checks: Dict[str, dict]) -> List[str]:
    return [f"{k} {v['value']} limit {v['limit']}" for k, v in checks.items()]


def limits_for(root, cell: str) -> Optional[Dict[str, float]]:
    """The cell's limits (``limits/<cell>.json``), None without a file."""
    path = root / "limits" / f"{cell}.json"
    if not path.is_file():
        return None
    return {k: float(v) for k, v in json.loads(path.read_text())[
        "limits"].items()}
