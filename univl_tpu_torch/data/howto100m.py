"""The HowTo100M pretraining reader, the port's copy of
``univl_tpu/data/howto100m.py`` on the pure-Python tokenizer: the same
arrays, draw for draw, for the same files and seed.

  - a clip's transcript grows to ``min_time`` seconds and ``min_words``
    tokens by merging its neighbours;
  - an empty video window grows outward until it holds a frame;
  - ``n_pair`` clips a sample (-1: all of the video's); ``use_mil`` groups a
    video's clips into pairs of n_pair and makes each group a sample,
    ``sampled_use_mil`` draws one group a video;
  - ``pretrain_enhance_vmodal`` blanks the text of 15% of the samples;
  - ``only_sim`` (stage I) makes no masks and no captions;
  - an unreadable feature file gives a zero video, and is logged.

The features are one ``.npy`` a video under ``features_path`` (the csv's
``feature_file`` column), memory-mapped through a bounded LRU of handles.
The sample's draws come from a generator seeded by (seed, epoch, index).
"""

from __future__ import annotations

import collections
import logging
import os
import threading
from typing import Dict, List, Tuple

import numpy as np

from univl_tpu_torch.data import text_encoding as te
from univl_tpu_torch.data.youcook import read_csv_ids

logger = logging.getLogger("univl_tpu_torch.data")


class HowTo100MPretrainDataset:
    def __init__(self, csv_path: str, data_dict: dict, features_path: str, tokenizer,
                 feature_framerate: float = 1.0, max_words: int = 48, max_frames: int = 64,
                 min_words: int = 0, min_time: float = 10.0, n_pair: int = 1,
                 with_long_context: bool = True, only_sim: bool = False,
                 use_mil: bool = False, sampled_use_mil: bool = False,
                 pretrain_enhance_vmodal: bool = False, video_dim: int = 1024,
                 seed: int = 42):
        """``data_dict``: the caption pickle's {video id: {start, end, text}}."""
        self.video_ids, self.feature_files = read_csv_ids(csv_path)
        self.data_dict = data_dict
        self.features_path = features_path
        self.tokenizer = tokenizer
        self.fps = feature_framerate
        self.max_words = max_words
        self.max_frames = max_frames
        self.min_words = min_words
        self.min_time = min_time
        self.n_pair = n_pair
        self.with_long_context = with_long_context
        self.only_sim = only_sim
        self.pretrain_enhance_vmodal = pretrain_enhance_vmodal
        self.video_dim = video_dim
        self.seed = seed
        self.epoch = 0
        self.use_mil = use_mil or sampled_use_mil
        self.sampled_use_mil = sampled_use_mil

        # memory-mapped feature files and tokenized clips, each an LRU under
        # its lock (the batcher reads samples from a thread pool)
        self._feat_cache: "collections.OrderedDict[str, np.ndarray]" = collections.OrderedDict()
        self._feat_cache_max = 32
        self._feat_lock = threading.Lock()
        self._tok_cache: "collections.OrderedDict" = collections.OrderedDict()
        self._tok_cache_max = 4096
        self._tok_lock = threading.Lock()
        self._video_err_count = 0

        self.iter_num = len(self.video_ids)
        if self.use_mil:
            self.vid2idx = {v: i for i, v in enumerate(self.video_ids)}
            self.iter2video_pairs: List[Tuple[str, List[int]]] = []
            self.vid2pairslist: Dict[str, List[List[int]]] = {}
            for vid in self.video_ids:
                sub_list = self._group_clips(len(self.data_dict[vid]["start"]))
                self.iter2video_pairs.extend((vid, sub) for sub in sub_list)
                self.vid2pairslist[vid] = sub_list
            if not self.sampled_use_mil:
                self.iter_num = len(self.iter2video_pairs)

    def _group_clips(self, n_caption: int) -> List[List[int]]:
        """The clip indices in groups of n_pair, the last one filled from
        the start (n_pair -1 or 1: one clip a group)."""
        if self.n_pair < 0 or self.n_pair == 1:
            return [[i] for i in range(n_caption)]
        ids = list(range(n_caption))
        if self.n_pair > n_caption:
            ids = (ids * (self.n_pair // n_caption + 1))[: self.n_pair]
        else:
            pad_to = ((n_caption + self.n_pair - 1) // self.n_pair) * self.n_pair
            ids = ids + ids[: pad_to - n_caption]
        return [ids[i: i + self.n_pair] for i in range(0, len(ids), self.n_pair)]

    def __len__(self):
        return self.iter_num

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _rng(self, idx):
        return np.random.RandomState(
            np.random.PCG64((self.seed * 1_000_003 + self.epoch * 97 + idx) % (2**31 - 1)))

    def _clip_tokens(self, d, ind) -> List[str]:
        """One clip's tokens, cached by (the video's dict, clip)."""
        key = (id(d), ind)
        with self._tok_lock:
            toks = self._tok_cache.get(key)
            if toks is not None:
                self._tok_cache.move_to_end(key)
                return toks
        toks = self.tokenizer.tokenize(str(d["text"][ind]))
        with self._tok_lock:
            self._tok_cache[key] = toks
            self._tok_cache.move_to_end(key)
            while len(self._tok_cache) > self._tok_cache_max:
                self._tok_cache.popitem(last=False)
        return toks

    def _single_transcript(self, d, ind) -> Tuple[List[str], float, float]:
        """Merge neighbours, the nearer in time (or with min_time 0 the
        shorter) first, until min_words and min_time hold."""
        start = end = ind
        words = list(self._clip_tokens(d, ind))
        diff = d["end"][end] - d["start"][start]
        while self.with_long_context and (len(words) < self.min_words or diff < self.min_time):
            if start > 0 and end < len(d["end"]) - 1:
                next_words = self._clip_tokens(d, end + 1)
                prev_words = self._clip_tokens(d, start - 1)
                d1 = d["end"][end + 1] - d["start"][start]
                d2 = d["end"][end] - d["start"][start - 1]
                if (self.min_time > 0 and d2 <= d1) or (
                        self.min_time == 0 and len(next_words) <= len(prev_words)):
                    start -= 1
                    words = list(prev_words) + words
                else:
                    end += 1
                    words = words + list(next_words)
            elif start > 0:
                start -= 1
                words = list(self._clip_tokens(d, start)) + words
            elif end < len(d["end"]) - 1:
                end += 1
                words = words + list(self._clip_tokens(d, end))
            else:
                break
            diff = d["end"][end] - d["start"][start]
        return words, float(d["start"][start]), float(d["end"][end])

    def _expand_video_slice(self, s, e, si, ei, feats) -> np.ndarray:
        """The [start, end] frames, grown one clip left then right in turn
        until not empty; at most max_frames."""
        start = int(s[si] * self.fps)
        end = int(e[ei] * self.fps) + 1
        if start > end:
            start, end = end, start
        video_slice = feats[start:end]
        expand_left = True
        while len(video_slice) < 1:
            if si == 0 and ei == len(s) - 1:
                break
            if expand_left:
                expand_left = False
                si = si - 1 if si > 0 else si
            else:
                expand_left = True
                ei = ei + 1 if ei < len(e) - 1 else ei
            start = int(s[si] * self.fps)
            end = int(e[ei] * self.fps) + 1
            if start > end:
                start, end = end, start
            video_slice = feats[start:end]
        return video_slice[: self.max_frames]

    def _load_features(self, path: str) -> np.ndarray:
        """The memory-mapped [T, D] features, through the LRU; raises on an
        unreadable file."""
        with self._feat_lock:
            feats = self._feat_cache.get(path)
            if feats is not None:
                self._feat_cache.move_to_end(path)
                return feats
        feats = np.load(path, mmap_mode="r")
        if feats.ndim != 2:
            raise ValueError(f"{path}: expected [T, D] features")
        with self._feat_lock:
            self._feat_cache[path] = feats
            self._feat_cache.move_to_end(path)
            while len(self._feat_cache) > self._feat_cache_max:
                self._feat_cache.popitem(last=False)
        return feats

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        rng = self._rng(idx)
        if self.sampled_use_mil:
            vid = self.video_ids[idx]
            sub_list = self.vid2pairslist[vid]
            sub_ids = sub_list[int(rng.randint(0, len(sub_list)))]
            file_idx = idx
        elif self.use_mil:
            vid, sub_ids = self.iter2video_pairs[idx]
            file_idx = self.vid2idx[vid]
        else:
            vid, sub_ids, file_idx = self.video_ids[idx], None, idx

        enhance_vmodal = (not self.only_sim and self.pretrain_enhance_vmodal
                          and rng.random_sample() < 0.15)

        d = self.data_dict[vid]
        if sub_ids is None:
            n_caption = len(d["start"])
            k = self.n_pair if self.n_pair != -1 else n_caption
            if self.n_pair == -1:
                r_ind = list(range(n_caption))
            elif k <= n_caption:
                r_ind = list(rng.choice(n_caption, k, replace=False))
            else:
                r_ind = list(range(n_caption)) + list(
                    rng.choice(n_caption, k - n_caption, replace=True))
                rng.shuffle(r_ind)
        else:
            r_ind = list(sub_ids)
        k = len(r_ind)

        Lw, Lf, D = self.max_words, self.max_frames, self.video_dim
        out = {
            "input_ids": np.zeros((k, Lw), np.int32),
            "attention_mask": np.zeros((k, Lw), np.int32),
            "token_type_ids": np.zeros((k, Lw), np.int32),
            "video": np.zeros((k, Lf, D), np.float32),
            "video_mask": np.zeros((k, Lf), np.int32),
        }
        if not self.only_sim:
            out.update(
                masked_text=np.zeros((k, Lw), np.int32),
                token_labels=np.full((k, Lw), te.IGNORE, np.int32),
                masked_video=np.zeros((k, Lf, D), np.float32),
                video_labels_index=np.full((k, Lf), te.IGNORE, np.int32),
                input_caption_ids=np.zeros((k, Lw), np.int32),
                output_caption_ids=np.zeros((k, Lw), np.int32),
                decoder_mask=np.zeros((k, Lw), np.int32),
            )

        starts, ends = np.zeros(k), np.zeros(k)
        for i, ind in enumerate(r_ind):
            words, starts[i], ends[i] = self._single_transcript(d, int(ind))
            t = te.encode_text([] if enhance_vmodal else words, self.tokenizer, Lw, rng,
                               with_mlm=not self.only_sim)
            out["input_ids"][i] = t["input_ids"]
            out["attention_mask"][i] = t["attention_mask"]
            if not self.only_sim:
                out["masked_text"][i] = t["masked_text"]
                out["token_labels"][i] = t["token_labels"]
                cap = te.encode_caption(words, self.tokenizer, Lw, rng, mask_input=True)
                for key in ("input_caption_ids", "output_caption_ids", "decoder_mask"):
                    out[key][i] = cap[key]

        feature_file = os.path.join(self.features_path, self.feature_files[file_idx])
        lengths = [0] * k
        try:
            feats = self._load_features(feature_file)
            if len(feats) < 1:
                raise ValueError(f"{feature_file} is empty")
            for i in range(k):
                sl = self._expand_video_slice(starts, ends, i, i, feats)
                lengths[i] = len(sl)
                if len(sl) >= 1:
                    out["video"][i, : len(sl)] = sl
        except (OSError, ValueError, EOFError) as e:
            # a zero video with a zero mask, as the reference reader does;
            # logged, so that a wrong --features_path does not train silently
            self._video_err_count += 1
            c = self._video_err_count
            if c <= 5 or c % 1000 == 0:
                logger.warning("video load failed (#%d): %s: %s: %s", c, feature_file,
                               type(e).__name__, e)
        for i, ln in enumerate(lengths):
            out["video_mask"][i, :ln] = 1

        if not self.only_sim:
            for i in range(k):
                out["masked_video"][i], out["video_labels_index"][i] = te.mask_frames(
                    out["video"][i], lengths[i], rng)
        return out
