"""Offline noise-corpus generator (host-side tool): the port of the JAX
package's ``audio/noise_corpus.py``, numpy only, writing the same files for
the same seed.

The reference augments by materializing an entire noisy corpus on disk
ahead of training: ``util/noise_util.py:23-49`` wipes the output dir,
samples a fraction of train utterances, mixes colored noise at random SNR
(``util/noise.py:70-128``) and writes wavs named
``idx_n_type_snr_dB.wav`` plus a ``data/noise_data.txt`` manifest
(path\tpinyin\thanzi) that the loaders pick up as a fallback root
(data_loader.py:121-125).

The trainers prefer on-device per-batch augmentation
(``audio.noise.add_noise_batch``, ``AMTrainer(augment_noise=True)``) — no
disk pass at all — but this tool
preserves the offline capability for users who want reproducible
pre-materialized noisy corpora. Pure numpy, no librosa/pydub.

CLI: python -m asr_dfcnn_transformer_torch.audio.noise_corpus \
        --data-dir D --speech-root R --out-root O [--rate 1.0] [...]
"""

from __future__ import annotations

import argparse
import os
import random
import shutil
from typing import List, Optional, Tuple

import numpy as np

from asr_dfcnn_transformer_torch.audio.wav import read_wav, write_wav
from asr_dfcnn_transformer_torch.data.manifest import Manifest, load_manifests


def color_noise_np(rng: np.random.Generator, length: int,
                   alpha: float) -> np.ndarray:
    """Host-side colored noise, same shaping as audio.noise.color_noise
    (1/f^-alpha spectrum, de-meaned, max-normalized)."""
    white = rng.standard_normal(length)
    spec = np.fft.rfft(white)
    k = np.arange(1, len(spec) + 1, dtype=np.float64)
    noise = np.fft.irfft(spec * (k ** alpha), n=length)
    noise = noise - noise.mean()
    noise = noise / noise.max()
    return noise.astype(np.float32)


def add_noise_to_file(path: str, rng: np.random.Generator,
                      snr_db: Optional[int] = None,
                      alpha: Optional[float] = None
                      ) -> Tuple[np.ndarray, int, int, float]:
    """Read a wav, mix one colored-noise realization.
    Returns (noisy signal, sample_rate, snr_db, alpha)."""
    sig, sr = read_wav(path)
    snr = snr_db if snr_db is not None else int(rng.integers(5, 11))
    a = alpha if alpha is not None else round(float(rng.integers(-10, 11)) / 10, 1)
    noise = color_noise_np(rng, len(sig), a)
    es = np.mean(sig * sig)
    en = np.mean(noise * noise)
    k = np.sqrt(es / max(en, 1e-12)) * (10 ** (-snr / 20))
    noisy = sig + k * noise
    peak = np.abs(noisy).max()
    if peak > 1.0:  # normalize only when clipping would occur (noise.py:115)
        noisy = noisy / peak
    return noisy.astype(np.float32), sr, snr, a


def generate_noise_corpus(manifest: Manifest, speech_root: str,
                          out_root: str, data_dir: str,
                          rate: float = 1.0, n_per_utt: int = 1,
                          seed: int = 0, wipe: bool = True) -> int:
    """Write noisy copies of a sampled subset of ``manifest`` under
    ``out_root`` (same relative paths, so loaders find them via the
    noise_root fallback) and the ``noise_data.txt`` manifest.
    Returns the number of noisy utterances written."""
    if wipe and os.path.isdir(out_root):
        shutil.rmtree(out_root)
    os.makedirs(out_root, exist_ok=True)
    rng = np.random.default_rng(seed)
    pick = random.Random(seed)
    rows: List[Tuple[str, str, str]] = []
    for i in range(len(manifest)):
        if pick.random() > rate:
            continue
        src = os.path.join(speech_root, manifest.paths[i])
        if not os.path.isfile(src):
            continue
        for n in range(n_per_utt):
            noisy, sr, snr, a = add_noise_to_file(src, rng)
            rel = manifest.paths[i]
            if n > 0:
                stem, ext = os.path.splitext(rel)
                rel = f"{stem}_n{n}{ext}"
            dst = os.path.join(out_root, rel)
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            write_wav(dst, noisy, sr)
            rows.append((rel, manifest.pinyin[i], manifest.hanzi[i]))
    os.makedirs(data_dir, exist_ok=True)
    with open(os.path.join(data_dir, "noise_data.txt"), "w",
              encoding="utf-8") as f:
        for rel, pny, han in rows:
            f.write(f"{rel}\t{pny}\t{han}\n")
    return len(rows)


def main(argv=None):
    p = argparse.ArgumentParser(prog="noise-corpus")
    p.add_argument("--data-dir", required=True)
    p.add_argument("--speech-root", required=True)
    p.add_argument("--out-root", required=True)
    p.add_argument("--corpora", default="thchs,aishell,aidatatang,stcmd,prime")
    p.add_argument("--rate", type=float, default=1.0,
                   help="fraction of train utterances to augment "
                        "(noise_util.py uses 1.0)")
    p.add_argument("--n-per-utt", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no-wipe", action="store_true")
    args = p.parse_args(argv)
    m = load_manifests(args.data_dir, "train",
                       corpora=tuple(args.corpora.split(",")))
    n = generate_noise_corpus(m, args.speech_root, args.out_root,
                              args.data_dir, rate=args.rate,
                              n_per_utt=args.n_per_utt, seed=args.seed,
                              wipe=not args.no_wipe)
    print(f"wrote {n} noisy utterances to {args.out_root}; manifest at "
          f"{os.path.join(args.data_dir, 'noise_data.txt')}")


if __name__ == "__main__":
    main()
