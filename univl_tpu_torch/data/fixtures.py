"""Synthetic data in the reference's file formats, the port's copy of
``univl_tpu/data/fixtures.py``'s ``make_vocab``, ``make_youcook``,
``make_msrvtt`` and ``make_howto100m``: the same files, byte for byte, for
the same arguments.

``chip_smoke.py`` and the tests make their training data with these.
"""

from __future__ import annotations

import csv
import json
import os
import pickle

import numpy as np

WORDS = (
    "add the chopped onions and stir well then pour some olive oil into pan "
    "heat salt pepper garlic butter mix flour water sugar egg chicken beef "
    "slice tomato cheese bread cook bake fry boil simmer plate serve bowl "
    "cut place remove season taste sauce rice pasta potato carrot"
).split()


def make_vocab(path: str) -> str:
    """Vocab covering the fixture word list plus wordpieces and specials."""
    tokens = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    tokens += sorted(set(WORDS))
    tokens += [c for c in "abcdefghijklmnopqrstuvwxyz0123456789"]
    tokens += ["##" + c for c in "abcdefghijklmnopqrstuvwxyz0123456789"]
    tokens += ["##ing", "##ed", ",", ".", "!", "?"]
    # keep the first occurrence of a duplicate: a later one would leave an id
    # without a reverse mapping
    seen = set()
    tokens = [t for t in tokens if not (t in seen or seen.add(t))]
    with open(path, "w") as f:
        f.write("\n".join(tokens) + "\n")
    return path


def _sentence(rng: np.random.RandomState, lo=4, hi=12) -> str:
    n = rng.randint(lo, hi)
    return " ".join(rng.choice(WORDS, n))


def make_youcook(out_dir: str, n_videos: int = 6, clips_per_video: int = 3,
                 video_dim: int = 32, seconds_per_video: int = 60, seed: int = 0,
                 with_transcript: bool = True):
    """Writes csv, data.pickle, features.pickle; returns their paths."""
    rng = np.random.RandomState(seed)
    os.makedirs(out_dir, exist_ok=True)
    vids = [f"vid{i:03d}" for i in range(n_videos)]

    csv_path = os.path.join(out_dir, "youcook.csv")
    with open(csv_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["video_id", "feature_file"])
        for v in vids:
            w.writerow([v, v])

    data = {}
    feats = {}
    for v in vids:
        bounds = np.sort(rng.uniform(0, seconds_per_video, 2 * clips_per_video))
        starts = bounds[0::2]
        ends = bounds[1::2] + 1.0
        data[v] = {
            "start": np.asarray(starts, dtype=object),
            "end": np.asarray(ends, dtype=object),
            "text": np.asarray([_sentence(rng) for _ in range(clips_per_video)], dtype=object),
        }
        if with_transcript:
            data[v]["transcript"] = np.asarray(
                [_sentence(rng) for _ in range(clips_per_video)], dtype=object)
        feats[v] = rng.randn(seconds_per_video, video_dim).astype(np.float32)

    data_path = os.path.join(out_dir, "youcook_data.pickle")
    with open(data_path, "wb") as f:
        pickle.dump(data, f)
    feat_path = os.path.join(out_dir, "youcook_features.pickle")
    with open(feat_path, "wb") as f:
        pickle.dump(feats, f)
    return csv_path, data_path, feat_path


def make_msrvtt(out_dir: str, n_videos: int = 8, sentences_per_video: int = 3,
                video_dim: int = 32, frames: int = 20, seed: int = 0, id_offset: int = 0,
                caption_test_layout: bool = False):
    """Writes the train csv, the JSFusion-style test csv, the json and the
    features pickle; returns their paths.

    ``caption_test_layout``: the reference's caption splits are positional
    over the json's video list (train = videos[:6513], test = videos[7010:]);
    when True, 7,010 caption-less dummy entries come first, so the real
    videos land in the test split."""
    rng = np.random.RandomState(seed)
    os.makedirs(out_dir, exist_ok=True)
    vids = [f"video{i + id_offset}" for i in range(n_videos)]

    train_csv = os.path.join(out_dir, "msrvtt_train.csv")
    with open(train_csv, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["video_id"])
        for v in vids:
            w.writerow([v])

    sentences = []
    for v in vids:
        for _ in range(sentences_per_video):
            sentences.append({"video_id": v, "caption": _sentence(rng)})
    video_entries = [{"video_id": v, "url": f"https://x.test/watch?v={v}"} for v in vids]
    if caption_test_layout:
        dummies = [{"video_id": f"dummy{i}", "url": f"https://x.test/watch?v=dummy{i}"}
                   for i in range(7010)]
        video_entries = dummies + video_entries
    json_path = os.path.join(out_dir, "msrvtt.json")
    with open(json_path, "w") as f:
        json.dump({"videos": video_entries, "sentences": sentences}, f)

    test_csv = os.path.join(out_dir, "msrvtt_test.csv")
    with open(test_csv, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["video_id", "sentence"])
        for v in vids:
            w.writerow([v, _sentence(rng)])

    feats = {v: rng.randn(frames, video_dim).astype(np.float32) for v in vids}
    feat_path = os.path.join(out_dir, "msrvtt_features.pickle")
    with open(feat_path, "wb") as f:
        pickle.dump(feats, f)
    return train_csv, test_csv, json_path, feat_path


def make_howto100m(out_dir: str, n_videos: int = 5, clips_per_video: int = 6,
                   video_dim: int = 32, seconds_per_video: int = 120, seed: int = 0,
                   corrupt_last: bool = True):
    """Writes the csv, the caption pickle and a dir of per-video .npy
    features (the last video's file not a .npy with ``corrupt_last``);
    returns their paths."""
    rng = np.random.RandomState(seed)
    feat_dir = os.path.join(out_dir, "features")
    os.makedirs(feat_dir, exist_ok=True)
    vids = [f"ht{i:03d}" for i in range(n_videos)]

    csv_path = os.path.join(out_dir, "howto100m.csv")
    with open(csv_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["video_id", "feature_file"])
        for v in vids:
            w.writerow([v, v + ".npy"])

    data = {}
    for i, v in enumerate(vids):
        bounds = np.sort(rng.uniform(0, seconds_per_video, 2 * clips_per_video))
        data[v] = {
            "start": np.asarray(bounds[0::2], dtype=object),
            "end": np.asarray(bounds[1::2] + 2.0, dtype=object),
            "text": np.asarray([_sentence(rng) for _ in range(clips_per_video)], dtype=object),
        }
        path = os.path.join(feat_dir, v + ".npy")
        if corrupt_last and i == n_videos - 1:
            with open(path, "wb") as f:
                f.write(b"not-an-npy")  # the reader's zero-video path
        else:
            np.save(path, rng.randn(seconds_per_video, video_dim).astype(np.float32))

    data_path = os.path.join(out_dir, "howto100m_caption.pickle")
    with open(data_path, "wb") as f:
        pickle.dump(data, f)
    return csv_path, data_path, feat_dir
