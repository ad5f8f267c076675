"""The one traffic generator: a traffic file's parameters and a seed -> the
utterances and labels of a run.

Every seed gets the same set of sizes, in another order, so that two seeds
do the same work: durations are the midpoint quantiles of the file's
mixture of corpora (each a log-normal whose mean is the corpus's published
hours over its utterances, weighted by its utterances; restricted to
``[min_s, max_s]``), spread over the buckets by each bucket's share. The
seed draws the order, the voiced syllables, the noise and the labels.

Signals are tone utterances voiced as the port's synthetic corpus voices
them (``data/synthetic.py``): each syllable a ``tone_ms`` pure tone of
class ``i`` at ``base_hz * ratio ** i`` with a linear ramp over
``ramp`` of its length at both ends, amplitude ``amplitude``, plus white
noise of deviation ``noise``; the last tone is cut at the duration.
"""

from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np
import torch

SAMPLE_RATE = 16000
WIN, HOP = 400, 160


def derive(seed: int, what: str) -> int:
    """A 63-bit seed for one use of the run's seed."""
    h = hashlib.sha256(f"{int(seed)}:{what}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def rng(seed: int, what: str) -> np.random.Generator:
    return np.random.default_rng(derive(seed, what))


def frames_for(samples: int) -> int:
    return 1 if samples <= WIN else 1 + -(-(samples - WIN) // HOP)


def samples_for_frames(frames: int) -> int:
    return (frames - 1) * HOP + WIN


def bucket_of(samples: int, bounds: Sequence[int]) -> int:
    f = frames_for(samples)
    for b in bounds:
        if f <= b:
            return b
    return bounds[-1]


def components(spec: dict) -> List[tuple]:
    """(weight, median_s) of each corpus of ``spec``: a log-normal of the
    spec's ``sigma`` whose mean is the corpus's published hours over its
    utterances, weighted by its utterances."""
    total = sum(c["utterances"] for c in spec["corpora"])
    shrink = math.exp(-spec["sigma"] ** 2 / 2)
    return [(c["utterances"] / total,
             c["hours"] * 3600.0 / c["utterances"] * shrink)
            for c in spec["corpora"]]


def cdf(spec: dict, x_s) -> np.ndarray:
    """The mixture's distribution function at ``x_s`` seconds (before the
    clip)."""
    x = torch.as_tensor(np.asarray(x_s, np.float64))
    out = torch.zeros_like(x)
    for w, med in components(spec):
        out += w * torch.special.ndtr(torch.log(x / med) / spec["sigma"])
    return out.numpy()


def _ppf(spec: dict, q: np.ndarray, lo: float, hi: float) -> np.ndarray:
    """The mixture's quantiles ``q`` within [lo, hi] s, by bisection in
    log time."""
    a = np.full(len(q), math.log(lo))
    b = np.full(len(q), math.log(hi))
    for _ in range(64):
        mid = (a + b) / 2
        below = cdf(spec, np.exp(mid)) < q
        a, b = np.where(below, mid, a), np.where(below, b, mid)
    return np.exp((a + b) / 2)


def durations(spec: dict, n: int, lo_s: float = None,
              hi_s: float = None) -> np.ndarray:
    """``n`` sample counts at the midpoint quantiles of the mixture
    ``spec`` restricted to [lo_s, hi_s] (default: its clip range), in
    ascending order."""
    lo = max(spec["min_s"], lo_s if lo_s is not None else spec["min_s"])
    hi = min(spec["max_s"], hi_s if hi_s is not None else spec["max_s"])
    c_lo, c_hi = cdf(spec, [lo, hi])
    q = c_lo + (np.arange(n) + 0.5) / n * (c_hi - c_lo)
    d = np.clip(_ppf(spec, q, lo, hi), lo, hi)
    return np.round(d * SAMPLE_RATE).astype(np.int64)


def _bucket_edges(bounds: Sequence[int]) -> List[tuple]:
    """(bucket, lowest s, highest s) of each bucket's utterances."""
    out, prev = [], 0
    for b in bounds:
        lo = (samples_for_frames(prev) + 1) / SAMPLE_RATE if prev else None
        out.append((b, lo, samples_for_frames(b) / SAMPLE_RATE))
        prev = b
    return out


def bucket_batches(spec: dict, bounds: Sequence[int],
                   cycle: int) -> Dict[int, int]:
    """Batches of each bucket in a cycle of ``cycle`` batches: each
    bucket's share of the clipped mixture, rounded by largest remainder."""
    lo, hi = spec["min_s"], spec["max_s"]
    edges = _bucket_edges(bounds)
    c = cdf(spec, [min(max(e if e is not None else lo, lo), hi)
                   for _, e, _ in edges] + [min(edges[-1][2], hi)])
    share = np.diff(c) / (c[-1] - c[0])
    raw = share * cycle
    n = np.floor(raw).astype(int)
    for i in np.argsort(-(raw - n), kind="stable")[:cycle - n.sum()]:
        n[i] += 1
    return {b: int(k) for (b, _, _), k in zip(edges, n)}


def bucket_durations(spec: dict, bounds: Sequence[int],
                     counts: Dict[int, int]) -> Dict[int, np.ndarray]:
    """Per bucket, ``counts[bucket]`` sample counts of utterances that
    fall in it (the distribution restricted to the bucket's frames)."""
    out = {}
    for b, lo, hi in _bucket_edges(bounds):
        n = int(counts.get(b, 0))
        if n:
            d = durations(spec, n, lo, hi)
            assert all(bucket_of(int(x), bounds) == b for x in d), b
            out[b] = d
    return out


def syllables(r: np.random.Generator, lengths: np.ndarray,
              voicing: dict) -> np.ndarray:
    """[n, max tones] syllable classes of each utterance."""
    tone = int(SAMPLE_RATE * voicing["tone_ms"] / 1000)
    k = int(-(-int(lengths.max()) // tone))
    return r.integers(0, voicing["classes"], size=(len(lengths), k))


def voice(lengths: np.ndarray, classes: np.ndarray, width: int,
          voicing: dict, noise_seed: int, device) -> np.ndarray:
    """[n, width] float32 signals, zero past each length (on ``device``,
    then to the host)."""
    tone = int(SAMPLE_RATE * voicing["tone_ms"] / 1000)
    dev = torch.device(device)
    n = torch.arange(width, device=dev)
    seg = torch.clamp(n // tone, max=classes.shape[1] - 1)
    local = (n % tone).double()
    freqs = voicing["base_hz"] * voicing["ratio"] ** torch.arange(
        voicing["classes"], device=dev, dtype=torch.float64)
    cls = torch.as_tensor(classes, device=dev)
    f = freqs[cls[:, seg]]                                   # [n, width]
    ramp = voicing["ramp"] * tone
    env = torch.clamp(torch.minimum(local, tone - local) / ramp, max=1.0)
    sig = voicing["amplitude"] * env * torch.sin(
        2 * math.pi * f * local / SAMPLE_RATE)
    g = torch.Generator(device=dev).manual_seed(noise_seed)
    sig = sig.float() + voicing["noise"] * torch.randn(
        sig.shape, generator=g, device=dev)
    keep = n[None, :] < torch.as_tensor(lengths, device=dev)[:, None]
    return torch.where(keep, sig, 0.0).cpu().numpy()


@dataclass
class Batch:
    """One padded batch: signals [B, samples_for_frames(bucket)], lengths
    [B] (sample counts), the bucket, and (training) labels."""

    signals: np.ndarray
    lengths: np.ndarray
    bucket: int
    labels: np.ndarray = None
    label_lengths: np.ndarray = None

    @property
    def audio_s(self) -> float:
        return float(self.lengths.sum()) / SAMPLE_RATE


def offline_batches(t: dict, seed: int, device) -> List[Batch]:
    """The offline corpus: a cycle of ``cycle_batches`` batches, each
    bucket's count its share of the durations, each bucket's utterances
    shuffled into its batches, the batches in a seeded order."""
    bsz, bounds = t["batch"], t["buckets"]
    counts = bucket_batches(t["durations"], bounds, t["cycle_batches"])
    per = bucket_durations(t["durations"], bounds,
                           {k: v * bsz for k, v in counts.items()})
    r = rng(seed, "offline")
    out = []
    for b, lens in per.items():
        lens = r.permutation(lens)
        for j in range(0, len(lens), bsz):
            ln = lens[j:j + bsz]
            cls = syllables(r, ln, t["voicing"])
            sig = voice(ln, cls, samples_for_frames(b), t["voicing"],
                        derive(seed, f"noise:{b}:{j}"), device)
            out.append(Batch(sig, ln.astype(np.int32), b))
    return [out[i] for i in r.permutation(len(out))]


def train_batches(t: dict, seed: int, device) -> List[Batch]:
    """``pool`` training batches of ``batch`` rows padded to ``bucket``,
    every row a different utterance; labels of ``labels.min``-``max``
    ids, cut so that each stays CTC-feasible (2 L + 1 <= logit frames)."""
    bsz, bucket, pool = t["batch"], t["bucket"], t["pool"]
    r = rng(seed, "train")
    lens_all = r.permutation(durations(t["durations"], bsz * pool))
    lab = t["labels"]
    out = []
    for j in range(pool):
        ln = lens_all[j * bsz:(j + 1) * bsz]
        cls = syllables(r, ln, t["voicing"])
        sig = voice(ln, cls, samples_for_frames(bucket), t["voicing"],
                    derive(seed, f"noise:{j}"), device)
        logit_frames = np.minimum(
            np.array([frames_for(int(x)) for x in ln]) // 8 + 1, bucket // 8)
        cap = (logit_frames - 1) // 2
        n_lab = np.minimum(r.integers(lab["min"], lab["max"] + 1, size=bsz),
                           cap)
        labels = r.integers(lab["first_id"], lab["last_id"] + 1,
                            size=(bsz, lab["max"]))
        labels[np.arange(lab["max"])[None, :] >= n_lab[:, None]] = 0
        out.append(Batch(sig, ln.astype(np.int32), bucket,
                         labels.astype(np.int32), n_lab.astype(np.int32)))
    return out
