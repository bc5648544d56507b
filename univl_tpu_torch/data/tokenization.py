"""BERT WordPiece tokenizer, the port's own copy of
``univl_tpu/data/tokenization.py``.

Basic tokenization (cleanup, CJK spacing, optional lowercasing and accent
stripping, punctuation splitting), then greedy longest-match-first WordPiece
with '##' continuations. As in the JAX package, ``WordPieceTokenizer`` takes
the native C++ path (``data/native.py``, ``csrc/wordpiece.cc``) by default,
and the Python path here for a string the C++ path declines; both give the
same ids. ``UNIVL_TPU_NO_NATIVE=1`` turns the native path off. Unlike the
JAX package, a native path that cannot be built raises, with the compiler's
message, rather than leaving the tokenizer on the Python path unnoticed.
"""

from __future__ import annotations

import collections
import os
import unicodedata
from typing import Dict, List, Sequence

SPECIAL_TOKENS = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")


def load_vocab(vocab_file: str) -> "collections.OrderedDict[str, int]":
    vocab = collections.OrderedDict()
    with open(vocab_file, "r", encoding="utf-8") as f:
        for i, line in enumerate(f):
            # a blank line becomes a vocab[""] entry at its index, as in the
            # reference loader
            vocab[line.rstrip("\n").strip()] = i
    return vocab


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    # ASCII ranges count as punctuation even where unicode disagrees ('$', '^', '`')
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF
        or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF
        or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F
        or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF
        or 0x2F800 <= cp <= 0x2FA1F
    )


class BasicTokenizer:
    def __init__(self, do_lower_case: bool = True,
                 never_split: Sequence[str] = ("[UNK]", "[SEP]", "[MASK]", "[CLS]")):
        self.do_lower_case = do_lower_case
        self.never_split = set(never_split)

    def tokenize(self, text: str) -> List[str]:
        text = self._space_cjk(self._clean(text))
        out: List[str] = []
        for tok in text.split():
            if tok in self.never_split:
                out.append(tok)
                continue
            if self.do_lower_case:
                tok = self._strip_accents(tok.lower())
            out.extend(self._split_punct(tok))
        return " ".join(out).split()

    @staticmethod
    def _clean(text: str) -> str:
        buf = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            buf.append(" " if _is_whitespace(ch) else ch)
        return "".join(buf)

    @staticmethod
    def _space_cjk(text: str) -> str:
        return "".join(f" {ch} " if _is_cjk(ord(ch)) else ch for ch in text)

    @staticmethod
    def _strip_accents(text: str) -> str:
        return "".join(ch for ch in unicodedata.normalize("NFD", text)
                       if unicodedata.category(ch) != "Mn")

    @staticmethod
    def _split_punct(tok: str) -> List[str]:
        pieces: List[List[str]] = []
        new_word = True
        for ch in tok:
            if _is_punctuation(ch):
                pieces.append([ch])
                new_word = True
            else:
                if new_word:
                    pieces.append([])
                    new_word = False
                pieces[-1].append(ch)
        return ["".join(p) for p in pieces]


class GreedyWordpiece:
    def __init__(self, vocab: Dict[str, int], unk_token: str = "[UNK]",
                 max_chars_per_word: int = 100):
        self.vocab = vocab
        self.unk_token = unk_token
        self.max_chars_per_word = max_chars_per_word

    def tokenize(self, word: str) -> List[str]:
        if len(word) > self.max_chars_per_word:
            return [self.unk_token]
        pieces: List[str] = []
        start, n = 0, len(word)
        while start < n:
            end, cur = n, None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [self.unk_token]
            pieces.append(cur)
            start = end
        return pieces


class WordPieceTokenizer:
    """End-to-end tokenizer with the reference BertTokenizer's interface."""

    # the reference's from_pretrained never_split set, which includes [PAD]
    PRETRAINED_NEVER_SPLIT = ("[UNK]", "[SEP]", "[PAD]", "[CLS]", "[MASK]")

    def __init__(self, vocab_file: str, do_lower_case: bool = True,
                 never_split: Sequence[str] = PRETRAINED_NEVER_SPLIT):
        if not os.path.isfile(vocab_file):
            raise ValueError(f"vocab file not found: {vocab_file}")
        self.vocab = load_vocab(vocab_file)
        missing = [t for t in SPECIAL_TOKENS if t not in self.vocab]
        if missing:
            raise ValueError(f"vocab {vocab_file} is missing special tokens {missing}; "
                             f"expected a BERT WordPiece vocab with {SPECIAL_TOKENS}")
        self.ids_to_tokens = {i: t for t, i in self.vocab.items()}
        if set(self.ids_to_tokens) != set(range(len(self.vocab))):
            raise ValueError(f"vocab {vocab_file} contains duplicate tokens; "
                             "some ids would have no reverse mapping")
        self.basic = BasicTokenizer(do_lower_case=do_lower_case, never_split=never_split)
        self.wordpiece = GreedyWordpiece(self.vocab)
        self._vocab_tokens = list(self.vocab)
        self._native = None
        if not os.environ.get("UNIVL_TPU_NO_NATIVE"):
            from univl_tpu_torch.data.native import NativeWordPiece

            self._native = NativeWordPiece(self._vocab_tokens, do_lower_case,
                                           never_split=list(never_split))

    @property
    def native(self) -> bool:
        """Whether ``tokenize`` takes the native C++ path."""
        return self._native is not None

    def __len__(self) -> int:
        return len(self.vocab)

    def tokenize(self, text: str) -> List[str]:
        if self._native is not None:
            ids = self._native.tokenize_ids(text)
            if ids is not None:
                return [self._vocab_tokens[i] for i in ids]
        out: List[str] = []
        for tok in self.basic.tokenize(text):
            out.extend(self.wordpiece.tokenize(tok))
        return out

    def convert_tokens_to_ids(self, tokens: Sequence[str]) -> List[int]:
        unk = self.vocab["[UNK]"]
        return [self.vocab.get(t, unk) for t in tokens]

    def convert_ids_to_tokens(self, ids: Sequence[int]) -> List[str]:
        return [self.ids_to_tokens[int(i)] for i in ids]

    @property
    def pad_id(self) -> int:
        return self.vocab["[PAD]"]

    @property
    def bos_id(self) -> int:  # BOS is [CLS]
        return self.vocab["[CLS]"]

    @property
    def eos_id(self) -> int:  # EOS is [SEP]
        return self.vocab["[SEP]"]
