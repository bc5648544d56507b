"""Text and video encoding, the port's own copy of
``univl_tpu/data/text_encoding.py``: the encoder's text, the caption
decoder's teacher-forcing ids, the video, and pretraining's masking (15% of
the tokens, split 80 / 10 / 10 between [MASK], a random token and the token
itself, with -1 labels elsewhere; 15% of the frames, zeroed), with JAX's
draws in JAX's order.

All outputs are fixed-shape int32/float32 numpy arrays.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

IGNORE = -1


def clip_and_wrap(words: List[str], max_words: int) -> List[str]:
    """["[CLS]"] + words (cut to max_words - 1 with CLS) + ["[SEP]"]."""
    words = ["[CLS]"] + words
    if len(words) > max_words - 1:
        words = words[: max_words - 1]
    return words + ["[SEP]"]


def mask_tokens(words: List[str], tokenizer,
                rng: np.random.RandomState) -> Tuple[List[str], List[int]]:
    """Masked-language masking of a wrapped token list, the first and last
    positions skipped: one draw for every position, then one for the random
    tokens; returns (masked words, labels: the original id where masked,
    else -1)."""
    n = len(words)
    masked = list(words)
    labels = [IGNORE] * n
    if n <= 2:
        return masked, labels
    probs = rng.random_sample(n - 2)
    hit = probs < 0.15
    if not hit.any():
        return masked, labels
    branch = probs[hit] / 0.15
    vocab_tokens, unk = tokenizer.ids_to_tokens, tokenizer.vocab["[UNK]"]
    rand_ids = rng.randint(0, len(vocab_tokens), hit.sum())
    for j, off in enumerate(np.nonzero(hit)[0]):
        i = int(off) + 1
        if branch[j] < 0.8:
            masked[i] = "[MASK]"
        elif branch[j] < 0.9:
            masked[i] = vocab_tokens[int(rand_ids[j])]
        labels[i] = tokenizer.vocab.get(words[i], unk)
    return masked, labels


def encode_text(text_or_words, tokenizer, max_words: int,
                rng: Optional[np.random.RandomState] = None,
                with_mlm: bool = False) -> Dict[str, np.ndarray]:
    """Tokenize (a string; a list is taken as tokens), wrap and pad: int32
    ``input_ids``, ``attention_mask`` and ``token_type_ids``, each
    [max_words]; with ``with_mlm`` also ``masked_text`` and ``token_labels``
    (``mask_tokens``, drawing from ``rng``)."""
    words = (tokenizer.tokenize(text_or_words) if isinstance(text_or_words, str)
             else list(text_or_words))
    words = clip_and_wrap(words, max_words)
    input_ids = tokenizer.convert_tokens_to_ids(words)
    out = {
        "input_ids": _pad(input_ids, max_words, 0),
        "attention_mask": _pad([1] * len(input_ids), max_words, 0),
        "token_type_ids": np.zeros(max_words, np.int32),
    }
    if with_mlm:
        if rng is None:
            raise ValueError("with_mlm draws from rng")
        masked_words, labels = mask_tokens(words, tokenizer, rng)
        out["masked_text"] = _pad(tokenizer.convert_tokens_to_ids(masked_words), max_words, 0)
        out["token_labels"] = _pad(labels, max_words, IGNORE)
    return out


def encode_caption(caption_words: List[str], tokenizer, max_words: int,
                   rng: Optional[np.random.RandomState] = None,
                   mask_input: bool = False) -> Dict[str, np.ndarray]:
    """The decoder's teacher-forcing ids: input [CLS] + words, output words
    + [SEP], cut to ``max_words`` and 0-padded; int32 ``input_caption_ids``,
    ``output_caption_ids`` and ``decoder_mask``, each [max_words]. With
    ``mask_input`` the input is masked (``mask_tokens``, drawing from
    ``rng``), as pretraining does."""
    words = list(caption_words)[: max_words - 1]
    input_words = ["[CLS]"] + words
    if mask_input:
        if rng is None:
            raise ValueError("mask_input draws from rng")
        input_words, _ = mask_tokens(input_words, tokenizer, rng)
    input_ids = tokenizer.convert_tokens_to_ids(input_words)
    output_ids = tokenizer.convert_tokens_to_ids(words + ["[SEP]"])
    return {
        "input_caption_ids": _pad(input_ids, max_words, 0),
        "output_caption_ids": _pad(output_ids, max_words, 0),
        "decoder_mask": _pad([1] * len(input_ids), max_words, 0),
    }


def pad_video(video_slice: np.ndarray, max_frames: int,
              video_dim: int) -> Tuple[np.ndarray, np.ndarray, int]:
    """Cut or zero-pad a [T, D] feature slice to [max_frames, D]; returns
    (video, mask, length)."""
    video = np.zeros((max_frames, video_dim), np.float32)
    length = min(video_slice.shape[0], max_frames) if video_slice.size else 0
    if length > 0:
        video[:length] = video_slice[:length]
    mask = np.zeros(max_frames, np.int32)
    mask[:length] = 1
    return video, mask, length


def mask_frames(video: np.ndarray, length: int,
                rng: np.random.RandomState) -> Tuple[np.ndarray, np.ndarray]:
    """15% of the first ``length`` frames zeroed (one draw a frame); labels
    hold each masked frame's index, else -1."""
    masked = video.copy()
    labels = np.full(video.shape[0], IGNORE, np.int32)
    if length > 0:
        idx = np.nonzero(rng.random_sample(length) < 0.15)[0]
        masked[idx] = 0.0
        labels[idx] = idx
    return masked, labels


def _pad(xs: Sequence[int], n: int, fill: int) -> np.ndarray:
    arr = np.full(n, fill, np.int32)
    arr[: len(xs)] = np.asarray(list(xs), np.int32)
    return arr
