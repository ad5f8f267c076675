"""Pinyin (acoustic) and hanzi (language) vocabularies.

The port's own copy of the JAX package's ``core/vocab.py``, reading the
port's ``assets/``:

- **Acoustic vocab**: every non-blank line of ``mixdict.txt`` in file order,
  then the CTC blank ``'_'`` LAST -> 1536 symbols. ``mixdict.txt`` holds one
  duplicated syllable; the str->id map keeps its LAST occurrence while the
  id->str list keeps both.
- **Language vocab**: ``'<pad>'`` then every line of ``hanzi.txt`` -> 6345
  symbols, PAD = 0 first.
- **End-to-end language vocab**: ``'<pad>' '<sos>' '</sos>'`` then
  ``hanzi.txt`` -> 6347 symbols.

An out-of-vocabulary symbol raises ``ValueError``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

from asr_dfcnn_transformer_torch.core import constants


def _read_lines(path: str) -> List[str]:
    with open(path, encoding="utf-8") as f:
        return [ln for ln in f.read().splitlines() if ln.strip() != ""]


@dataclasses.dataclass(frozen=True)
class Vocab:
    """Immutable bidirectional vocabulary."""

    symbols: tuple
    str2id: Dict[str, int]

    @property
    def size(self) -> int:
        return len(self.symbols)

    def to_id(self, sym: str) -> int:
        try:
            return self.str2id[sym]
        except KeyError as e:
            raise ValueError(f"OOV symbol: {sym!r}") from e

    def to_str(self, idx: int) -> str:
        return self.symbols[idx]

    def encode(self, syms: Sequence[str]) -> List[int]:
        return [self.to_id(s) for s in syms]

    def decode(self, ids: Sequence[int]) -> List[str]:
        return [self.to_str(int(i)) for i in ids]


def build_vocab(symbols: List[str]) -> Vocab:
    # a dict over enumerate keeps the LAST index of a duplicated symbol
    return Vocab(tuple(symbols), {s: i for i, s in enumerate(symbols)})


def acoustic_vocab(path: str = constants.PINYIN_DICT_PATH) -> Vocab:
    """Pinyin syllables + trailing CTC blank (size 1536)."""
    symbols = _read_lines(path)
    symbols.append(constants.BLANK_SYMBOL)
    return build_vocab(symbols)


def language_vocab(path: str = constants.HANZI_DICT_PATH) -> Vocab:
    """``<pad>`` + hanzi characters (size 6345)."""
    symbols = [constants.PAD_FLAG] + _read_lines(path)
    return build_vocab(symbols)


def e2e_language_vocab(path: str = constants.HANZI_DICT_PATH) -> Vocab:
    """``<pad> <sos> </sos>`` + hanzi characters (size 6347)."""
    symbols = [constants.PAD_FLAG, constants.SOS_FLAG, constants.EOS_FLAG]
    symbols += _read_lines(path)
    return build_vocab(symbols)


def pinyin_to_ids(vocab: Vocab, line: str) -> List[int]:
    """Space-separated pinyin line -> ids."""
    return vocab.encode(line.strip().split(" "))


def hanzi_to_ids(vocab: Vocab, line: str) -> List[int]:
    """Hanzi string (one char per symbol) -> ids."""
    return [vocab.to_id(ch) for ch in line.strip()]
