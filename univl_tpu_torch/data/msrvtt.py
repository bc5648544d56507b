"""The MSRVTT datasets, the port's copy of ``univl_tpu/data/msrvtt.py``:
JSFusion-style retrieval eval, retrieval training (one random caption per
video per epoch, or every caption with ``unfold_sentences``) and
video-only captioning with all of a clip's references, over a shared reader.

Files (the reference's formats):
  csv:      column video_id (train), or video_id,sentence (the JSFusion test)
  json:     {"videos": [{video_id, url, ...}], "sentences": [{video_id, caption}]}
  features: pickle {video_id: float array [T, video_dim]} (the whole video)

A sample holds the five arrays the encoders read (``input_ids``,
``token_type_ids``, ``attention_mask``, ``video``, ``video_mask``); a
caption sample adds the decoder's three. Each sample draws from its own
``_rng`` (seeded by seed, epoch and index, as in the JAX package), so the
caption a training video gets in an epoch is JAX's. The masked-language and
masked-frame fields wait for pretraining, as in ``data/youcook.py``.
"""

from __future__ import annotations

import csv as _csv
import json
import pickle
from collections import defaultdict
from typing import Dict, List

import numpy as np

from univl_tpu_torch.data import text_encoding as te

# the reference's positional video splits over the json's list; the test split
# is open-ended, as the reference's video_ids[7010:]
MSRVTT_SPLITS = {"train": (0, 6513), "val": (6513, 7010), "test": (7010, None)}


def _read_csv(path: str) -> List[dict]:
    with open(path, newline="") as f:
        return list(_csv.DictReader(f))


class _MsrvttBase:
    def __init__(self, features_path: str, tokenizer, max_words: int, max_frames: int,
                 seed: int = 42):
        with open(features_path, "rb") as f:
            self.feature_dict = pickle.load(f)
        self.tokenizer = tokenizer
        self.max_words = max_words
        self.max_frames = max_frames
        self.seed = seed
        self.epoch = 0
        d0 = next(iter(self.feature_dict.values()))
        self.video_dim = int(np.asarray(d0).shape[-1])

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _rng(self, idx: int) -> np.random.RandomState:
        return np.random.RandomState(
            np.random.PCG64((self.seed * 1_000_003 + self.epoch * 97 + idx) % (2**31 - 1)))

    def _video(self, video_id: str) -> Dict[str, np.ndarray]:
        feats = np.asarray(self.feature_dict[video_id], np.float32)
        video, mask, _ = te.pad_video(feats, self.max_frames, self.video_dim)
        return {"video": video, "video_mask": mask}


class MsrvttRetrievalEvalDataset(_MsrvttBase):
    """The JSFusion test csv: one (video_id, sentence) row per clip."""

    def __init__(self, csv_path: str, features_path: str, tokenizer, max_words: int = 48,
                 max_frames: int = 48, seed: int = 42):
        super().__init__(features_path, tokenizer, max_words, max_frames, seed)
        self.rows = _read_csv(csv_path)

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        row = self.rows[idx]
        sample = te.encode_text(row["sentence"], self.tokenizer, self.max_words)
        sample.update(self._video(row["video_id"]))
        return sample

    def meta(self, idx: int) -> str:
        return self.rows[idx]["video_id"]


class MsrvttRetrievalTrainDataset(_MsrvttBase):
    """The training videos of the csv. ``unfold_sentences`` (the CLI's
    ``--expand_msrvtt_sentences``) makes every caption of a video a sample;
    otherwise each video is one sample with a caption drawn from the
    sample's rng, anew each epoch."""

    def __init__(self, csv_path: str, json_path: str, features_path: str, tokenizer,
                 max_words: int = 48, max_frames: int = 48, unfold_sentences: bool = False,
                 seed: int = 42):
        super().__init__(features_path, tokenizer, max_words, max_frames, seed)
        self.csv_rows = _read_csv(csv_path)
        with open(json_path) as f:
            self.meta_json = json.load(f)
        self.unfold = unfold_sentences
        train_ids = set(r["video_id"] for r in self.csv_rows)
        if self.unfold:
            self.samples = [(s["video_id"], s["caption"]) for s in self.meta_json["sentences"]
                            if s["video_id"] in train_ids]
        else:
            self.sentences = defaultdict(list)
            for s in self.meta_json["sentences"]:
                self.sentences[s["video_id"]].append(s["caption"])
            self.samples = [(r["video_id"], None) for r in self.csv_rows]

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        video_id, caption = self.samples[idx]
        if caption is None:
            caps = self.sentences[video_id]
            caption = caps[int(self._rng(idx).randint(0, len(caps)))]
        sample = te.encode_text(caption, self.tokenizer, self.max_words)
        sample.update(self._video(video_id))
        return sample


class MsrvttCaptionDataset(_MsrvttBase):
    """Video-only captioning: the encoder's text is empty ([CLS][SEP]), the
    videos are the split's of the json's list (``MSRVTT_SPLITS``). Train: a
    sample per caption; val and test: a sample per video (its first caption
    the decoder's target), with all its captions as ``references``."""

    def __init__(self, csv_path: str, json_path: str, features_path: str, tokenizer,
                 split_type: str = "train", max_words: int = 48, max_frames: int = 48,
                 seed: int = 42):
        super().__init__(features_path, tokenizer, max_words, max_frames, seed)
        with open(json_path) as f:
            self.meta_json = json.load(f)
        video_ids = [v["video_id"] for v in self.meta_json["videos"]]
        lo, hi = MSRVTT_SPLITS[split_type]
        chosen = set(video_ids[lo:hi])
        self.video_sentences: Dict[str, List[str]] = defaultdict(list)
        for s in self.meta_json["sentences"]:
            if s["video_id"] in chosen:
                self.video_sentences[s["video_id"]].append(s["caption"])
        if split_type == "train":
            self.samples = [(s["video_id"], s["caption"]) for s in self.meta_json["sentences"]
                            if s["video_id"] in chosen]
        else:
            self.samples = [(vid, self.video_sentences[vid][0]) for vid in video_ids[lo:hi]
                            if vid in self.video_sentences]

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        video_id, caption = self.samples[idx]
        sample = te.encode_text("", self.tokenizer, self.max_words)
        sample.update(te.encode_caption(self.tokenizer.tokenize(caption), self.tokenizer,
                                        self.max_words))
        sample.update(self._video(video_id))
        return sample

    def references(self, idx: int) -> List[str]:
        return self.video_sentences[self.samples[idx][0]]

    def meta(self, idx: int) -> str:
        return self.samples[idx][0]
