"""Synthetic corpus fixtures for tests and benchmarks: a copy of the JAX
package's ``data/synthetic.py`` over the port's ``core/vocab.py``.

The reference has no test fixtures at all (SURVEY.md §4); its manifest
format (path\tpinyin\thanzi TSV, data_util.py:83-89) is trivial to
fabricate. This module writes a small learnable corpus: each pinyin
"syllable" is voiced as a pure tone at a distinct frequency, so an acoustic
model can actually learn the mapping — loss decreasing on this corpus is a
meaningful end-to-end signal, not just a smoke test.
"""

from __future__ import annotations

import os
import random
from typing import List, Optional, Sequence, Tuple

import numpy as np

from asr_dfcnn_transformer_torch.audio.wav import write_wav
from asr_dfcnn_transformer_torch.core import vocab


def make_synthetic_corpus(root: str,
                          num_utts: int = 32,
                          num_classes: int = 8,
                          syllables_per_utt: Tuple[int, int] = (2, 5),
                          sample_rate: int = 16000,
                          tone_ms: int = 300,
                          seed: int = 0,
                          corpus_name: str = "thchs",
                          modes: Sequence[str] = ("train", "dev", "test"),
                          pinyin_inventory: Optional[List[str]] = None):
    """Create wavs + manifests under ``root``.

    Layout: ``root/wav/<mode>/utt_<i>.wav`` and
    ``root/data/{corpus_name}_{mode}.txt`` with paths relative to
    ``root/wav`` (the loader's ``speech_data_root``).

    Labels: ``num_classes`` distinct real pinyin syllables (taken from the
    bundled mixdict so vocab encoding works), each mapped to a distinct
    tone; hanzi labels are the i-th hanzi of the bundled dictionary so the
    LM path is exercised with real vocab ids.

    Returns (data_dir, wav_root, syllables, hanzi_chars).
    """
    rng = random.Random(seed)
    av = vocab.acoustic_vocab()
    lv = vocab.language_vocab()
    if pinyin_inventory is None:
        # deterministic spread across the vocab (skip blank at the end)
        step = (av.size - 1) // (num_classes + 1)
        syllables = [av.symbols[(i + 1) * step] for i in range(num_classes)]
    else:
        syllables = pinyin_inventory[:num_classes]
    hanzi_chars = [lv.symbols[10 + i] for i in range(num_classes)]
    syl2hanzi = dict(zip(syllables, hanzi_chars))
    freqs = [300.0 * (1.18 ** i) for i in range(num_classes)]
    syl2freq = dict(zip(syllables, freqs))

    data_dir = os.path.join(root, "data")
    wav_root = os.path.join(root, "wav")
    os.makedirs(data_dir, exist_ok=True)
    tone_n = int(sample_rate * tone_ms / 1000)

    for mode in modes:
        os.makedirs(os.path.join(wav_root, mode), exist_ok=True)
        rows = []
        for i in range(num_utts):
            n_syl = rng.randint(*syllables_per_utt)
            utt_syls = [rng.choice(syllables) for _ in range(n_syl)]
            segs = []
            for s in utt_syls:
                t = np.arange(tone_n) / sample_rate
                env = np.minimum(1.0, np.minimum(np.arange(tone_n),
                                                 tone_n - np.arange(tone_n))
                                 / (0.05 * tone_n))
                segs.append(0.5 * env * np.sin(2 * np.pi * syl2freq[s] * t))
            sig = np.concatenate(segs).astype(np.float32)
            sig += 0.01 * np.random.default_rng(seed + i).standard_normal(len(sig)).astype(np.float32)
            rel = os.path.join(mode, f"utt_{i}.wav")
            write_wav(os.path.join(wav_root, rel), sig, sample_rate)
            rows.append((rel, " ".join(utt_syls),
                         "".join(syl2hanzi[s] for s in utt_syls)))
        with open(os.path.join(data_dir, f"{corpus_name}_{mode}.txt"),
                  "w", encoding="utf-8") as f:
            for rel, pny, han in rows:
                f.write(f"{rel}\t{pny}\t{han}\n")
    return data_dir, wav_root, syllables, hanzi_chars
