"""Phonemization utilities: pinyin -> phonemes, hanzi -> pinyin. The
port's own copy of the JAX package's ``utils/phoneme.py`` (pure Python).

The reference ships a disconnected 5-line demo of the external
``phonemizer`` package (``lm_and_am/phoneme_tool.py``) — the capability it
gestures at is "turn text into phoneme tokens". Here that capability is
implemented natively for the framework's own language domain and wired to
its assets instead of an external binary:

- :func:`split_pinyin` decomposes a (optionally toned) pinyin syllable
  into (initial, final, tone) using standard Mandarin phonology — the
  same toned-syllable format as ``assets/mixdict.txt`` (the acoustic
  vocabulary, ``data_loader.py:85-92``).
- :func:`phonemize_pinyin` maps a pinyin sequence to a flat phoneme
  token list (initials/finals + tone markers), suitable for building
  phone-level lexica or sub-syllable acoustic targets.
- :class:`HanziPhonemizer` inverts the shipped ``dict.txt`` lexicon
  (pinyin -> candidate hanzi, frequency-ordered) to give hanzi -> pinyin
  -> phonemes for raw Chinese text, mirroring ``phonemize('English')``'s
  text-in / phonemes-out shape.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from asr_dfcnn_transformer_torch.core.lexicon import LEXICON_PATH, load_lexicon

# Standard Mandarin initials, longest-match-first ("zh" before "z").
_INITIALS = (
    "zh", "ch", "sh",
    "b", "p", "m", "f", "d", "t", "n", "l",
    "g", "k", "h", "j", "q", "x",
    "z", "c", "s", "r", "y", "w",
)


def split_pinyin(syllable: str) -> Tuple[str, str, int]:
    """Decompose ``'zhong4'`` -> ``('zh', 'ong', 4)``.

    Tone 0 means the syllable carried no tone digit (mixdict.txt mixes
    toneless and toned entries). Zero-initial syllables ('a', 'er', 'ai')
    return an empty initial. Raises ValueError on an empty syllable.
    """
    s = syllable.strip().lower()
    if not s:
        raise ValueError("empty pinyin syllable")
    tone = 0
    if s[-1].isdigit():
        tone = int(s[-1])
        s = s[:-1]
    if not s:
        raise ValueError(f"pinyin syllable {syllable!r} is only a tone")
    for ini in _INITIALS:
        # A final must remain: 'n' in 'n2' (interjection) keeps empty final.
        if s.startswith(ini) and len(s) > len(ini):
            return ini, s[len(ini):], tone
    return "", s, tone


def phonemize_pinyin(pinyin: Sequence[str],
                     tones: bool = True) -> List[str]:
    """Flat phoneme-token list for a pinyin sequence.

    Each syllable contributes [initial?, final, tone-marker?]; tone
    markers are ``'1'..'5'`` strings so the output alphabet stays small
    (≤ 23 initials + finals + 5 tones vs 1,423 whole syllables).
    """
    out: List[str] = []
    for syl in pinyin:
        ini, fin, tone = split_pinyin(syl)
        if ini:
            out.append(ini)
        if fin:
            out.append(fin)
        if tones and tone:
            out.append(str(tone))
    return out


def phoneme_inventory(pinyin: Sequence[str]) -> List[str]:
    """Sorted unique phoneme alphabet induced by a syllable list — e.g.
    the whole of mixdict.txt; useful for building phone-level targets."""
    return sorted(set(phonemize_pinyin(pinyin)))


class HanziPhonemizer:
    """hanzi text -> pinyin -> phonemes, via the inverted dict.txt lexicon.

    ``dict.txt`` maps each toned pinyin syllable to its candidate hanzi in
    frequency order (``assets/dict.txt``; SURVEY §2.1 "Vocab assets").
    Inverting it gives, per hanzi, the candidate pinyin readings ranked by
    how early the hanzi appears in each syllable's candidate list — a
    no-external-dependency grapheme-to-phoneme table.
    """

    def __init__(self, lexicon_path: str = LEXICON_PATH):
        table = load_lexicon(lexicon_path)
        best: Dict[str, Tuple[int, str]] = {}
        for syllable, candidates in table.items():
            for rank, ch in enumerate(candidates):
                if ch not in best or rank < best[ch][0]:
                    best[ch] = (rank, syllable)
        self._han2pny = {ch: syl for ch, (_, syl) in best.items()}

    def pinyin(self, text: str, unknown: str = "?") -> List[str]:
        """Most-likely pinyin reading per character."""
        return [self._han2pny.get(ch, unknown) for ch in text]

    def phonemize(self, text: str, tones: bool = True) -> List[str]:
        """Chinese text in, phoneme tokens out (unknown chars dropped)."""
        syls = [s for s in self.pinyin(text) if s != "?"]
        return phonemize_pinyin(syls, tones=tones)
