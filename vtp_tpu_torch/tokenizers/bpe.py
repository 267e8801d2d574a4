"""OpenAI-CLIP byte-level BPE tokenizer (port of ``vtp_tpu/tokenizers/bpe.py``;
behavioural reference ``vtp/tokenizers/text_tokenizer.py:144-294``).

Token ids must equal the reference's for zero-shot parity: 256 byte
symbols + their 256 ``</w>`` variants + the merges + ``<start_of_text>``
and ``<end_of_text>`` (49,408 with the released merges file). The merges
come from ``$VTP_BPE_PATH`` or ``bpe_simple_vocab_16e6.txt.gz`` beside
this module (the file is data, not vendored here).

The pre-tokenising pattern, CLIP's
``'s|'t|'re|'ve|'m|'ll|'d|[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+``, needs
Unicode property classes, which the standard ``re`` lacks (the JAX
package uses the ``regex`` package, which the card's machine does not
have). Here the letter and number classes are built once from
``unicodedata`` (every code point whose category starts with L, or with
N: Nd, Nl and No, so ``½``, ``²`` and ``Ⅻ`` are numbers as in ``\\p{N}``;
``\\d`` would take Nd alone). ``ftfy`` fixes the text when it is
installed and is skipped otherwise, as in the reference. Output is a
zero-padded ``(B, context_length)`` int32 numpy array, as the JAX
package's.
"""

from __future__ import annotations

import functools
import gzip
import html
import os
import re
import sys
import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

DEFAULT_CONTEXT_LENGTH = 77
VOCAB_ENV = "VTP_BPE_PATH"
VOCAB_NAME = "bpe_simple_vocab_16e6.txt.gz"


def _fix_text(text: str) -> str:
    try:
        import ftfy
    except ImportError:
        return text
    return ftfy.fix_text(text)


def find_bpe_vocab() -> str:
    for path in (os.environ.get(VOCAB_ENV, ""),
                 os.path.join(os.path.dirname(os.path.abspath(__file__)), VOCAB_NAME)):
        if path and os.path.exists(path):
            return path
    raise FileNotFoundError(f"{VOCAB_NAME} not found; set {VOCAB_ENV} to the OpenAI CLIP BPE "
                            f"vocab file.")


@functools.lru_cache()
def byte_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte <-> unicode table: printable latin-1 ranges
    map to themselves, the rest to U+0100 onwards."""
    keep = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
            + list(range(ord("®"), ord("ÿ") + 1)))
    mapping = {b: chr(b) for b in keep}
    offset = 0
    for b in range(256):
        if b not in mapping:
            mapping[b] = chr(256 + offset)
            offset += 1
    return mapping


@functools.lru_cache()
def unicode_classes() -> Tuple[str, str]:
    """(letters, numbers): ``re`` character-class bodies of every code point
    of category L* and of N*, the ``\\p{L}`` and ``\\p{N}`` of the
    ``regex`` package, as runs of code points."""
    cat = unicodedata.category
    first = np.frombuffer("".join([cat(chr(i))[0] for i in range(sys.maxunicode + 1)])
                          .encode("ascii"), np.uint8)
    bodies = []
    for letter in "LN":
        edges = np.diff(np.concatenate([[0], (first == ord(letter)).astype(np.int8), [0]]))
        starts, ends = np.flatnonzero(edges == 1), np.flatnonzero(edges == -1) - 1
        bodies.append("".join(re.escape(chr(a)) if a == b else f"{re.escape(chr(a))}-{re.escape(chr(b))}"
                              for a, b in zip(starts.tolist(), ends.tolist())))
    return bodies[0], bodies[1]


def _pattern(specials: Sequence[str] = ()) -> "re.Pattern[str]":
    """CLIP's pre-tokenising pattern after the special tokens."""
    letters, numbers = unicode_classes()
    return re.compile(
        "".join(f"{re.escape(s)}|" for s in specials)
        + rf"""'s|'t|'re|'ve|'m|'ll|'d|[{letters}]+|[{numbers}]|[^\s{letters}{numbers}]+""",
        re.IGNORECASE)


def _clean(text: str, lowercase: bool = True) -> str:
    text = _fix_text(text)
    text = html.unescape(html.unescape(text)).strip()
    text = " ".join(text.split()).strip()
    return text.lower() if lowercase else text


class SimpleTokenizer:
    """CLIP BPE with numpy output."""

    def __init__(self, bpe_path: Optional[str] = None,
                 additional_special_tokens: Optional[List[str]] = None,
                 context_length: Optional[int] = DEFAULT_CONTEXT_LENGTH, clean: str = "lower"):
        bpe_path = bpe_path or find_bpe_vocab()
        self.byte_encoder = byte_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")
        # the first line is a version header; the table holds 49152 - 256 - 2 merges
        merges: List[Tuple[str, ...]] = [tuple(l.split()) for l in lines[1: 49152 - 256 - 2 + 1]]

        base = list(self.byte_encoder.values())
        vocab = base + [s + "</w>" for s in base]
        vocab.extend("".join(m) for m in merges)
        specials = ["<start_of_text>", "<end_of_text>"]
        if additional_special_tokens:
            specials = specials + list(additional_special_tokens)
        vocab.extend(specials)

        self.encoder: Dict[str, int] = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks: Dict[Tuple[str, ...], int] = {m: i for i, m in enumerate(merges)}
        self._word_cache: Dict[str, List[str]] = {s: [s] for s in specials}

        self.pat = _pattern(specials)
        self.vocab_size = len(self.encoder)
        self.all_special_ids = [self.encoder[s] for s in specials]
        self.sot_token_id = self.all_special_ids[0]
        self.eot_token_id = self.all_special_ids[1]
        self.context_length = context_length
        self.lowercase = clean != "whitespace"

    def _merge_word(self, token: str) -> List[str]:
        """Greedy lowest-rank merging of one pre-token (with </w>)."""
        cached = self._word_cache.get(token)
        if cached is not None:
            return cached
        parts: List[str] = list(token[:-1]) + [token[-1] + "</w>"]
        ranks = self.bpe_ranks
        while len(parts) > 1:
            best_rank, best_i = None, -1
            for i in range(len(parts) - 1):
                r = ranks.get((parts[i], parts[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_i = r, i
            if best_rank is None:
                break
            merged = parts[best_i] + parts[best_i + 1]
            out: List[str] = []  # merge every non-overlapping occurrence of this pair
            i = 0
            while i < len(parts):
                if (i < len(parts) - 1 and parts[i] + parts[i + 1] == merged
                        and ranks.get((parts[i], parts[i + 1])) == best_rank):
                    out.append(merged)
                    i += 2
                else:
                    out.append(parts[i])
                    i += 1
            parts = out
        self._word_cache[token] = parts
        return parts

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for token in self.pat.findall(_clean(text, self.lowercase)):
            mapped = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[p] for p in self._merge_word(mapped))
        return ids

    def decode(self, tokens) -> str:
        text = "".join(self.decoder[int(t)] for t in tokens)
        raw = bytearray(self.byte_decoder[c] for c in text)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")

    def __call__(self, texts: Union[str, List[str]],
                 context_length: Optional[int] = None) -> np.ndarray:
        """Zero-padded ``(B, context_length)`` int32 ids; an over-long
        sequence is cut with EOT forced at its end (text_tokenizer.py:285-294)."""
        if isinstance(texts, str):
            texts = [texts]
        L = context_length or self.context_length
        if not L:
            raise ValueError("a context length is required")
        out = np.zeros((len(texts), L), dtype=np.int32)
        for i, text in enumerate(texts):
            toks = [self.sot_token_id] + self.encode(text) + [self.eot_token_id]
            if len(toks) > L:
                toks = toks[:L]
                toks[-1] = self.eot_token_id
            out[i, : len(toks)] = toks
        return out

    encode_batch = __call__


def write_merges_file(path: str, texts: Sequence[str]) -> int:
    """Write a gzip merges file in the released file's format (a version
    line, then one ``a b`` merge a line) built from a corpus: the chain of
    prefixes of every distinct pre-token of ``texts`` (cleaned and split as
    ``SimpleTokenizer`` does), in first-seen order, each merge once. A
    stand-in vocab for runs without the released file; returns the number
    of merges."""
    pat = _pattern()
    enc = byte_to_unicode()
    merges: Dict[Tuple[str, str], None] = {}
    for text in texts:
        for token in pat.findall(_clean(text)):
            mapped = "".join(enc[b] for b in token.encode("utf-8"))
            symbols = list(mapped[:-1]) + [mapped[-1] + "</w>"]
            cur = symbols[0]
            for sym in symbols[1:]:
                merges.setdefault((cur, sym))
                cur += sym
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("#version: synthetic\n" + "".join(f"{a} {b}\n" for a, b in merges))
    return len(merges)


def get_tokenizer(context_length: Optional[int] = None, **kwargs) -> SimpleTokenizer:
    """The reference's ``get_tokenizer`` (text_tokenizer.py:297-325) without
    its open_clip branch and model name: ``SimpleTokenizer`` at
    ``context_length`` (77 by default)."""
    return SimpleTokenizer(context_length=context_length or DEFAULT_CONTEXT_LENGTH, **kwargs)
