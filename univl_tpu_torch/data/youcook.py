"""The YouCook2 datasets, the port's copy of the parts of
``univl_tpu/data/youcook.py`` that fine-tuning reads: retrieval pairs and
caption clips, over a shared reader.

Data files (the reference's pickle schema):
  csv:      columns video_id, feature_file
  data:     pickle {video_id: {start[], end[], text[], transcript[]?}}
  features: pickle {feature_file: float array [T, video_dim]}

A retrieval sample holds the five arrays the retrieval step reads:
``input_ids``, ``token_type_ids``, ``attention_mask`` ([max_words] int32),
``video`` ([max_frames, video_dim] f32) and ``video_mask`` ([max_frames]
int32). A caption sample's encoder text is the clip's transcript and it adds
the decoder's ``input_caption_ids``, ``output_caption_ids`` and
``decoder_mask`` (the caption). The masked-language and masked-frame fields
wait for pretraining; they will draw from ``_rng``, seeded per sample as in
the JAX package.
"""

from __future__ import annotations

import csv as _csv
import pickle
from typing import Dict, List

import numpy as np

from univl_tpu_torch.data import text_encoding as te


def read_csv_ids(csv_path: str):
    with open(csv_path, newline="") as f:
        rows = list(_csv.DictReader(f))
    return [r["video_id"] for r in rows], [r["feature_file"] for r in rows]


class _YoucookBase:
    """The clips of the csv's videos, one per captioned segment."""

    def __init__(self, csv_path: str, data_path: str, features_path: str, tokenizer,
                 feature_framerate: float = 1.0, max_words: int = 48, max_frames: int = 48,
                 seed: int = 42):
        self.video_ids, self.feature_files = read_csv_ids(csv_path)
        with open(data_path, "rb") as f:
            self.data_dict = pickle.load(f)
        with open(features_path, "rb") as f:
            self.feature_dict = pickle.load(f)
        self.fps = feature_framerate
        self.max_words = max_words
        self.max_frames = max_frames
        self.tokenizer = tokenizer
        self.seed = seed
        self.epoch = 0
        self.vid2file = dict(zip(self.video_ids, self.feature_files))
        self.pairs: List = [(vid, sub_id) for vid in self.video_ids
                            for sub_id in range(len(self.data_dict[vid]["start"]))]
        d0 = next(iter(self.feature_dict.values()))
        self.video_dim = int(np.asarray(d0).shape[-1])

    def __len__(self):
        return len(self.pairs)

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _rng(self, idx: int) -> np.random.RandomState:
        return np.random.RandomState(
            np.random.PCG64((self.seed * 1_000_003 + self.epoch * 97 + idx) % (2**31 - 1)))

    def _video(self, vid: str, sub_id: int) -> Dict[str, np.ndarray]:
        d = self.data_dict[vid]
        feats = np.asarray(self.feature_dict[self.vid2file[vid]], np.float32)
        s = int(float(d["start"][sub_id]) * self.fps)
        e = int(float(d["end"][sub_id]) * self.fps) + 1
        video, mask, _ = te.pad_video(feats[s:e], self.max_frames, self.video_dim)
        return {"video": video, "video_mask": mask}


class YoucookRetrievalDataset(_YoucookBase):
    """(video clip, text) pairs, one per captioned clip."""

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        vid, sub_id = self.pairs[idx]
        sample = te.encode_text(str(self.data_dict[vid]["text"][sub_id]), self.tokenizer,
                                self.max_words)
        sample.update(self._video(vid, sub_id))
        return sample


class YoucookCaptionDataset(_YoucookBase):
    """Caption clips: the encoder's text is the clip's transcript (its
    caption where the data has none), the decoder's target the caption."""

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        vid, sub_id = self.pairs[idx]
        d = self.data_dict[vid]
        transcript = str(d.get("transcript", d["text"])[sub_id])
        sample = te.encode_text(transcript, self.tokenizer, self.max_words)
        sample.update(te.encode_caption(self.tokenizer.tokenize(str(d["text"][sub_id])),
                                        self.tokenizer, self.max_words))
        sample.update(self._video(vid, sub_id))
        return sample

    def reference_caption(self, idx: int) -> str:
        vid, sub_id = self.pairs[idx]
        return str(self.data_dict[vid]["text"][sub_id])
