"""Text and video padding, the port's own copy of the parts of
``univl_tpu/data/text_encoding.py`` that serving and fine-tuning read: the
encoder's text, the caption decoder's teacher-forcing ids and the video (no
MLM masking yet: only pretraining masks).

All outputs are fixed-shape int32/float32 numpy arrays.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def clip_and_wrap(words: List[str], max_words: int) -> List[str]:
    """["[CLS]"] + words (cut to max_words - 1 with CLS) + ["[SEP]"]."""
    words = ["[CLS]"] + words
    if len(words) > max_words - 1:
        words = words[: max_words - 1]
    return words + ["[SEP]"]


def encode_text(text: str, tokenizer, max_words: int) -> Dict[str, np.ndarray]:
    """Tokenize, wrap and pad: int32 ``input_ids``, ``attention_mask`` and
    ``token_type_ids``, each [max_words]."""
    input_ids = tokenizer.convert_tokens_to_ids(
        clip_and_wrap(tokenizer.tokenize(text), max_words))
    return {
        "input_ids": _pad(input_ids, max_words, 0),
        "attention_mask": _pad([1] * len(input_ids), max_words, 0),
        "token_type_ids": np.zeros(max_words, np.int32),
    }


def encode_caption(caption_words: List[str], tokenizer, max_words: int) -> Dict[str, np.ndarray]:
    """The decoder's teacher-forcing ids: input [CLS] + words, output words
    + [SEP], cut to ``max_words`` and 0-padded; int32 ``input_caption_ids``,
    ``output_caption_ids`` and ``decoder_mask``, each [max_words]."""
    words = list(caption_words)[: max_words - 1]
    input_ids = tokenizer.convert_tokens_to_ids(["[CLS]"] + words)
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


def _pad(xs: Sequence[int], n: int, fill: int) -> np.ndarray:
    arr = np.full(n, fill, np.int32)
    arr[: len(xs)] = np.asarray(list(xs), np.int32)
    return arr
