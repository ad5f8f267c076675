"""Pinyin -> candidate-hanzi lexicon: the port's own copy of the JAX
package's ``core/lexicon.py``, reading the port's ``assets/dict.txt``.

The reference ships ``dict.txt`` — 1,423 lines of
``pinyin<TAB>candidate hanzi string`` — but no code ever reads it
(grep-verified in SURVEY §2.1). Here it's a loadable asset with the
obvious API, because a pinyin->hanzi stack should expose its lexicon:
candidate lookup powers constrained LM decoding, data validation, and
simple rule-based fallbacks when no LM checkpoint is available.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence

from asr_dfcnn_transformer_torch.core import constants

LEXICON_PATH = os.path.join(constants.ASSET_DIR, "dict.txt")


def load_lexicon(path: str = LEXICON_PATH) -> Dict[str, List[str]]:
    """{pinyin syllable: [candidate hanzi chars, frequency-ordered]}."""
    out: Dict[str, List[str]] = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            cols = line.rstrip("\n").split("\t")
            if len(cols) >= 2 and cols[0].strip():
                out[cols[0].strip()] = list(cols[1].strip())
    return out


class Lexicon:
    def __init__(self, path: str = LEXICON_PATH):
        self.table = load_lexicon(path)

    def candidates(self, syllable: str) -> List[str]:
        return self.table.get(syllable, [])

    def first_candidate_transcription(self, pinyin: Sequence[str]) -> str:
        """Rule-based pinyin->hanzi: most frequent candidate per syllable
        (a no-LM fallback)."""
        out = []
        for s in pinyin:
            c = self.candidates(s)
            out.append(c[0] if c else "?")
        return "".join(out)

    def validate(self, pinyin: Sequence[str], hanzi: str) -> List[bool]:
        """Per-position check that each hanzi char is a lexicon candidate
        of the aligned pinyin syllable (useful for manifest QA)."""
        return [i < len(hanzi) and hanzi[i] in self.candidates(s)
                for i, s in enumerate(pinyin)]
