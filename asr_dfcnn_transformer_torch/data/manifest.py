"""Corpus manifest layer: a copy of the JAX package's ``data/manifest.py``
(standard library only).

Replaces the reference's pandas-based ``DataUtil``
(``util/data_util.py:12-117``): TSV manifests named
``{corpus}_{mode}.txt`` with three tab-separated columns
path / space-separated-pinyin / hanzi (``data_util.py:80-89``), per-corpus
on/off selection, optional shuffle, truncation to a multiple of the batch
size (``data_util.py:99-106``) and optional cap on total utterances
(``data_length``). Also regenerates the frequency-sorted hanzi dictionary
(``generate_dict``, ``data_util.py:108-117``).

No pandas dependency — the format is three ``\t``-separated fields.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import random
from typing import List, Optional, Sequence


@dataclasses.dataclass
class Manifest:
    paths: List[str]
    pinyin: List[str]   # space-separated pinyin strings
    hanzi: List[str]    # hanzi strings

    def __len__(self):
        return len(self.paths)

    def shuffled(self, seed: int = 0) -> "Manifest":
        idx = list(range(len(self)))
        random.Random(seed).shuffle(idx)
        return Manifest([self.paths[i] for i in idx],
                        [self.pinyin[i] for i in idx],
                        [self.hanzi[i] for i in idx])

    def truncate_to_multiple(self, batch_size: int) -> "Manifest":
        n = (len(self) // batch_size) * batch_size
        return Manifest(self.paths[:n], self.pinyin[:n], self.hanzi[:n])

    def head(self, n: int) -> "Manifest":
        return Manifest(self.paths[:n], self.pinyin[:n], self.hanzi[:n])


def read_manifest(path: str) -> Manifest:
    paths, pny, han = [], [], []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.rstrip("\n")
            if not line.strip():
                continue
            cols = line.split("\t")
            if len(cols) < 3:
                continue
            paths.append(cols[0].strip())
            pny.append(cols[1].strip())
            han.append(cols[2].strip().replace(" ", ""))
    return Manifest(paths, pny, han)


def load_manifests(data_dir: str, mode: str,
                   corpora: Sequence[str] = ("thchs", "aishell", "aidatatang",
                                             "stcmd", "prime"),
                   use_noise: bool = False,
                   shuffle: bool = False,
                   seed: int = 0,
                   data_length: Optional[int] = None,
                   batch_size: Optional[int] = None) -> Manifest:
    """Concatenate the selected per-corpus manifests for ``mode`` in
    train/dev/test; append the noise-augmentation manifest when requested
    (``data/noise_data.txt``, const.py:44 + data_util.py:74-77)."""
    out = Manifest([], [], [])
    for corpus in corpora:
        p = os.path.join(data_dir, f"{corpus}_{mode}.txt")
        if os.path.isfile(p):
            m = read_manifest(p)
            out.paths += m.paths
            out.pinyin += m.pinyin
            out.hanzi += m.hanzi
    if use_noise and mode == "train":
        p = os.path.join(data_dir, "noise_data.txt")
        if os.path.isfile(p):
            m = read_manifest(p)
            out.paths += m.paths
            out.pinyin += m.pinyin
            out.hanzi += m.hanzi
    if shuffle:
        out = out.shuffled(seed)
    if data_length is not None:
        out = out.head(data_length)
    if batch_size:
        out = out.truncate_to_multiple(batch_size)
    return out


def generate_hanzi_dict(manifest: Manifest, out_path: str) -> int:
    """Write a frequency-sorted hanzi vocabulary file (one char per line),
    the analogue of DataUtil.generate_dict (data_util.py:108-117).
    Returns the number of distinct characters."""
    counter = collections.Counter()
    for text in manifest.hanzi:
        counter.update(text)
    chars = [c for c, _ in counter.most_common()]
    with open(out_path, "w", encoding="utf-8") as f:
        f.write("\n".join(chars))
    return len(chars)
