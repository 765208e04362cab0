"""CLIP byte-pair-encoding tokenizer (demo2_tpu/utils/bpe.py).

Produces token ids compatible with OpenAI CLIP's BPE (reference:
modeling/clip/simple_tokenizer.py + clip.py::tokenize) using the public
`bpe_simple_vocab_16e6.txt.gz` vocabulary, of which the port keeps its own
byte-identical copy under demo2_tpu_torch/assets/ (a data asset from the
OpenAI CLIP release, not code; tests/test_torch_clip_text.py pins it equal
to the JAX package's).

Compatibility pins the algorithm: the reversible byte<->unicode table, the
merge-table slice, the vocabulary ordering (256 byte units, their '</w>'
variants, 48894 merges, 2 specials -> 49408 ids) and the token-split
pattern must all match or the ids diverge.  `regex` gives the pattern its
unicode letter and number classes; without it the standard `re` takes an
ASCII form of it.  `ftfy` text fixing is applied when the package is present
and skipped otherwise (identity for clean ASCII prompts, the only inputs the
reference ever feeds it).
"""

from __future__ import annotations

import functools
import gzip
import html
import os
from typing import Iterable, List, Union

import numpy as np

try:
    import regex as _re  # supports \p{L}/\p{N} unicode classes
except ImportError:  # pragma: no cover
    _re = None

try:
    import ftfy as _ftfy
except ImportError:
    _ftfy = None

VOCAB_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "assets",
    "bpe_simple_vocab_16e6.txt.gz",
)
SOT = "<|startoftext|>"
EOT = "<|endoftext|>"


@functools.lru_cache()
def _byte_unicode_table() -> dict:
    """Reversible byte -> printable-unicode map (GPT-2/CLIP convention)."""
    printable = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    chars = printable[:]
    offset = 0
    for b in range(256):
        if b not in printable:
            printable.append(b)
            chars.append(256 + offset)
            offset += 1
    return {b: chr(c) for b, c in zip(printable, chars)}


class ClipBPE:
    """Word-level BPE with end-of-word markers, CLIP vocabulary order."""

    def __init__(self, vocab_path: str = VOCAB_PATH):
        raw = gzip.open(vocab_path).read().decode("utf-8").split("\n")
        # Line 0 is a header; 49152-256-2 merge rules follow (reference
        # slice simple_tokenizer.py:66).
        merge_lines = raw[1 : 49152 - 256 - 2 + 1]
        merges = [tuple(line.split()) for line in merge_lines]
        self._byte_enc = _byte_unicode_table()
        self._byte_dec = {c: b for b, c in self._byte_enc.items()}
        units = list(self._byte_enc.values())
        vocab = units + [u + "</w>" for u in units]
        vocab += ["".join(m) for m in merges]
        vocab += [SOT, EOT]
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self._rank = {m: i for i, m in enumerate(merges)}
        self._cache = {SOT: SOT, EOT: EOT}
        if _re is not None:
            self._pat = _re.compile(
                r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"""
                r"""|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
                _re.IGNORECASE,
            )
        else:  # pragma: no cover - ASCII-only fallback
            import re as _std_re

            self._pat = _std_re.compile(
                r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"""
                r"""|[A-Za-z]+|[0-9]|[^\sA-Za-z0-9]+""",
                _std_re.IGNORECASE,
            )

    def _merge_word(self, token: str) -> str:
        if token in self._cache:
            return self._cache[token]
        parts = list(token[:-1]) + [token[-1] + "</w>"]
        if len(parts) == 1:
            return token + "</w>"
        while len(parts) > 1:
            pairs = {(parts[i], parts[i + 1]) for i in range(len(parts) - 1)}
            best = min(pairs, key=lambda p: self._rank.get(p, float("inf")))
            if best not in self._rank:
                break
            first, second = best
            merged: List[str] = []
            i = 0
            while i < len(parts):
                if (
                    i < len(parts) - 1
                    and parts[i] == first
                    and parts[i + 1] == second
                ):
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(parts[i])
                    i += 1
            parts = merged
        word = " ".join(parts)
        self._cache[token] = word
        return word

    def encode(self, text: str) -> List[int]:
        if _ftfy is not None:
            text = _ftfy.fix_text(text)
        text = html.unescape(html.unescape(text))
        text = " ".join(text.split()).strip().lower()
        ids: List[int] = []
        for piece in self._pat.findall(text):
            mapped = "".join(self._byte_enc[b] for b in piece.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._merge_word(mapped).split(" "))
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        text = "".join(self.decoder[int(i)] for i in ids)
        data = bytearray(self._byte_dec[c] for c in text)
        return data.decode("utf-8", errors="replace").replace("</w>", " ")


@functools.lru_cache()
def _default_tokenizer() -> ClipBPE:
    return ClipBPE()


def tokenize(
    texts: Union[str, List[str]],
    context_length: int = 77,
    truncate: bool = False,
) -> np.ndarray:
    """`clip.tokenize` equivalent: (N, 77) int32 with SOT/EOT framing."""
    if isinstance(texts, str):
        texts = [texts]
    bpe = _default_tokenizer()
    sot, eot = bpe.encoder[SOT], bpe.encoder[EOT]
    out = np.zeros((len(texts), context_length), np.int32)
    for row, text in enumerate(texts):
        ids = [sot] + bpe.encode(text) + [eot]
        if len(ids) > context_length:
            if not truncate:
                raise RuntimeError(
                    f"Input {text!r} is too long for context length {context_length}"
                )
            ids = ids[:context_length]
            ids[-1] = eot
        out[row, : len(ids)] = ids
    return out
