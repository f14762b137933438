"""CLIP byte-pair-encoding tokenizer (an own copy of the JAX package's
``features/clip_tokenizer.py``, which is pure Python).

Re-implements the standard CLIP tokenizer (whitespace-cleaned lowercased
text -> byte-level BPE with ``</w>`` end-of-word markers -> ids in a
49408-token vocabulary with ``<|startoftext|>`` / ``<|endoftext|>``),
gated on the standard merges file ``bpe_simple_vocab_16e6.txt.gz`` being
present in a weights directory (features/weights.py) — the same file every
CLIP distribution ships.  Without it :func:`get_tokenizer` returns None and
the extractor falls back to offline hashed text embeddings.

Reference behavior: ``maskclip_onnx.clip.tokenize``, which the reference
calls in its ``utils/features.py``.
"""

from __future__ import annotations

import functools
import gzip
import html
import re
from typing import Dict, List, Optional, Tuple

from .weights import find_weights


def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte <-> printable-unicode mapping."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _basic_clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return text.strip()


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


# CLIP's original pattern uses regex-module classes \p{L}/\p{N}; Python's
# `re` has neither, but [^\W\d_] (any word char that is not a digit or
# underscore) reproduces \p{L} and \d reproduces \p{N} under re.UNICODE,
# so accented/non-Latin words tokenize like the reference tokenizer.
_PAT = re.compile(
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"""
    r"""[^\W\d_]+|\d|(?:[^\s\w]|_)+""",
    re.IGNORECASE | re.UNICODE,
)


class ClipTokenizer:
    def __init__(self, bpe_path: str):
        merges_txt = gzip.open(bpe_path, "rt", encoding="utf-8").read()
        merges = merges_txt.split("\n")[1 : 49152 - 256 - 2 + 1]
        merge_pairs: List[Tuple[str, str]] = [
            tuple(m.split()) for m in merges
        ]
        self.byte_encoder = bytes_to_unicode()
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for a, b in merge_pairs:
            vocab.append(a + b)
        vocab += ["<|startoftext|>", "<|endoftext|>"]
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.bpe_ranks = {pair: i for i, pair in enumerate(merge_pairs)}
        self.sot = self.encoder["<|startoftext|>"]
        self.eot = self.encoder["<|endoftext|>"]
        self._cache: Dict[str, List[str]] = {}

    def _bpe(self, token: str) -> List[str]:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = set(zip(word[:-1], word[1:]))
            best = min(
                pairs, key=lambda p: self.bpe_ranks.get(p, float("inf"))
            )
            if best not in self.bpe_ranks:
                break
            a, b = best
            new_word: List[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == a and word[i + 1] == b:
                    new_word.append(a + b)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
        out = list(word)
        self._cache[token] = out
        return out

    def encode(self, text: str, context_length: int = 77) -> List[int]:
        """[context_length] ids: <sot> tokens <eot> 0-padded (CLIP layout;
        over-long texts are truncated keeping the final <eot>)."""
        text = _whitespace_clean(_basic_clean(text)).lower()
        ids: List[int] = [self.sot]
        for tok in _PAT.findall(text):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(tok))
        ids.append(self.eot)
        if len(ids) > context_length:
            ids = ids[: context_length - 1] + [self.eot]
        return ids + [0] * (context_length - len(ids))


@functools.lru_cache(maxsize=1)
def get_tokenizer() -> Optional[ClipTokenizer]:
    path = find_weights("bpe_simple_vocab_16e6.txt.gz")
    if path is None:
        return None
    return ClipTokenizer(path)
