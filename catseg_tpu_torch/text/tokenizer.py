"""Byte-level BPE tokenizer for CLIP text encoding (pure Python, no torch).

Behavioral contract (reference: cat_seg/third_party/simple_tokenizer.py,
clip.py:199-214): lowercase + whitespace-collapse the text, split with the
CLIP regex, byte-encode each piece into the reversible unicode alphabet, apply
ranked BPE merges with the ``</w>`` end-of-word marker, then frame as
``<|startoftext|> ids <|endoftext|>`` zero-padded to a 77-token context.

The merge table is *data*, not code: it is loaded at runtime from the
standard OpenAI ``bpe_simple_vocab_16e6.txt.gz`` that ships beside this
module (another copy can be named with ``CATSEG_BPE_PATH``).

The port's own copy of catseg_tpu/text/tokenizer.py, so that the port reads
nothing of the JAX package.
"""

from __future__ import annotations

import functools
import gzip
import html
import os

import numpy as np

try:
    import regex as _re

    _PAT = _re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
        _re.IGNORECASE,
    )
except ImportError:  # pragma: no cover - regex is normally available
    import re as _re

    # ASCII approximation of the unicode-category classes; class names and
    # prompt templates in this framework are ASCII.  The punctuation class
    # must include "_" (it is non-letter/non-digit in CLIP's \p{L}/\p{N}
    # pattern but inside \w here), so runs of punct-or-underscore are matched
    # by (?:[^\s\w]|_)+ to keep token ids identical to the regex-module path.
    _PAT = _re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[^\W\d_]+|\d|(?:[^\s\w]|_)+""",
        _re.IGNORECASE,
    )

try:
    import ftfy as _ftfy
except ImportError:
    _ftfy = None

_WS = __import__("re").compile(r"\s+")

_BPE_SEARCH_PATHS = (
    os.path.join(os.path.dirname(__file__), "bpe_simple_vocab_16e6.txt.gz"),
)

N_MERGES = 49152 - 256 - 2  # standard CLIP vocab arithmetic: 48,894 merges
VOCAB_SIZE = 49408
CONTEXT_LENGTH = 77


def find_bpe_vocab() -> str:
    env = os.environ.get("CATSEG_BPE_PATH")
    candidates = ([env] if env else []) + list(_BPE_SEARCH_PATHS)
    for path in candidates:
        if path and os.path.exists(path):
            return path
    raise FileNotFoundError(
        "CLIP BPE merges file not found; set CATSEG_BPE_PATH to "
        "bpe_simple_vocab_16e6.txt.gz"
    )


@functools.lru_cache(maxsize=None)
def _byte_alphabet() -> dict[int, str]:
    """Reversible byte <-> printable-unicode mapping (GPT-2/CLIP standard)."""
    printable = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    mapping = {b: chr(b) for b in printable}
    fill = 0
    for b in range(256):
        if b not in mapping:
            mapping[b] = chr(256 + fill)
            fill += 1
    return mapping


def _clean(text: str) -> str:
    if _ftfy is not None:
        text = _ftfy.fix_text(text)
    text = html.unescape(html.unescape(text))
    return _WS.sub(" ", text).strip()


class ClipBPE:
    """Encoder from text to CLIP token ids."""

    def __init__(self, bpe_path: str | None = None):
        path = bpe_path or find_bpe_vocab()
        lines = gzip.open(path).read().decode("utf-8").split("\n")
        merge_lines = lines[1 : N_MERGES + 1]
        merges = [tuple(line.split()) for line in merge_lines]

        alphabet = list(_byte_alphabet().values())
        tokens = alphabet + [c + "</w>" for c in alphabet]
        tokens += ["".join(pair) for pair in merges]
        tokens += ["<|startoftext|>", "<|endoftext|>"]
        self.token_to_id = {tok: i for i, tok in enumerate(tokens)}
        self.id_to_token = tokens
        self.rank = {pair: i for i, pair in enumerate(merges)}
        self.byte_to_char = _byte_alphabet()
        self._word_cache: dict[str, list[int]] = {}
        assert len(tokens) == VOCAB_SIZE

    @property
    def sot(self) -> int:
        return self.token_to_id["<|startoftext|>"]

    @property
    def eot(self) -> int:
        return self.token_to_id["<|endoftext|>"]

    def _merge_word(self, piece: str) -> list[int]:
        """BPE-merge one regex piece (already byte-mapped) into token ids."""
        cached = self._word_cache.get(piece)
        if cached is not None:
            return cached
        if not piece:
            return []
        symbols = list(piece[:-1]) + [piece[-1] + "</w>"]
        while len(symbols) > 1:
            # find the lowest-ranked adjacent pair
            best_rank = None
            best_i = -1
            for i in range(len(symbols) - 1):
                r = self.rank.get((symbols[i], symbols[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank = r
                    best_i = i
            if best_rank is None:
                break
            pair = (symbols[best_i], symbols[best_i + 1])
            merged = pair[0] + pair[1]
            # merge *every* occurrence of this pair left-to-right
            out: list[str] = []
            i = 0
            while i < len(symbols):
                if i < len(symbols) - 1 and symbols[i] == pair[0] and symbols[i + 1] == pair[1]:
                    out.append(merged)
                    i += 2
                else:
                    out.append(symbols[i])
                    i += 1
            symbols = out
        ids = [self.token_to_id[s] for s in symbols]
        self._word_cache[piece] = ids
        return ids

    def encode(self, text: str) -> list[int]:
        text = _clean(text).lower()
        ids: list[int] = []
        for piece in _PAT.findall(text):
            mapped = "".join(self.byte_to_char[b] for b in piece.encode("utf-8"))
            ids.extend(self._merge_word(mapped))
        return ids

    def decode(self, ids) -> str:
        chars = "".join(self.id_to_token[int(i)] for i in ids)
        inv = {v: k for k, v in self.byte_to_char.items()}
        raw = bytes(inv[c] for c in chars)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")


@functools.lru_cache(maxsize=1)
def _default_tokenizer() -> ClipBPE:
    return ClipBPE()


def tokenize(texts, context_length: int = CONTEXT_LENGTH, tokenizer: ClipBPE | None = None) -> np.ndarray:
    """Encode a list of strings into an int32 (N, context_length) id matrix.

    Matches reference clip.tokenize (clip.py:199-214): SOT + ids + EOT,
    zero padding, error if a prompt exceeds the context window.
    """
    if isinstance(texts, str):
        texts = [texts]
    tok = tokenizer or _default_tokenizer()
    out = np.zeros((len(texts), context_length), dtype=np.int32)
    for i, text in enumerate(texts):
        ids = [tok.sot] + tok.encode(text) + [tok.eot]
        if len(ids) > context_length:
            raise RuntimeError(f"Input {text!r} is too long for context length {context_length}")
        out[i, : len(ids)] = ids
    return out
