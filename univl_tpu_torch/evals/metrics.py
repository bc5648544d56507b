"""Retrieval metrics, the port's copy of ``univl_tpu/evals/metrics.py``.

R@K, MedianR and MeanR from the rank of the diagonal of a text x video
similarity matrix. The rank is the number of entries in the row strictly
greater than the diagonal entry, so a tie counts in the true pair's favour
(well defined under ties, as in the JAX package).
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def compute_retrieval_metrics(sim_matrix: np.ndarray) -> Dict[str, float]:
    x = np.asarray(sim_matrix)
    if x.ndim != 2 or x.shape[0] != x.shape[1]:
        raise ValueError(f"need a square similarity matrix, got {x.shape}")
    d = np.diagonal(x)
    ranks = (x > d[:, None]).sum(axis=1)  # 0-based rank of the true pair
    return {
        "R1": float((ranks == 0).mean()),
        "R5": float((ranks < 5).mean()),
        "R10": float((ranks < 10).mean()),
        "MR": float(np.median(ranks) + 1),
        "MeanR": float(ranks.mean() + 1),
    }
