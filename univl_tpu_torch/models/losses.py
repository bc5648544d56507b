"""UniVL's training objectives, in PyTorch.

Ports the losses of ``univl_tpu/models/losses.py`` that the ported training
paths read. FT-Joint (stage one without MIL) trains with the max-margin
ranking loss; the others come with their slices. Every loss reduces over the
batch it is given: the trainer calls it on each micro-batch's own rows, so
the negatives are that micro-batch's (the reference's per-device negatives).
"""

from __future__ import annotations

import numpy as np
import torch


def max_margin_ranking_loss(sim_matrix: torch.Tensor, margin: float = 0.1,
                            negative_weighting: bool = False, batch_size: int = 1,
                            n_pair: int = 1, hard_negative_rate: float = 0.5) -> torch.Tensor:
    """Bidirectional hinge over a square similarity matrix, with the
    reference's optional hard-negative weighting (when ``n_pair > 1``)."""
    d = torch.diagonal(sim_matrix)
    max_margin = (torch.relu(margin + sim_matrix - d[:, None])
                  + torch.relu(margin + sim_matrix - d[None, :]))
    if negative_weighting and n_pair > 1 and batch_size > 1:
        easy_negative_rate = 1 - hard_negative_rate
        alpha = easy_negative_rate / ((batch_size - 1) * (1 - easy_negative_rate))
        mm = (1 - alpha) * np.eye(batch_size) + alpha
        mm = np.kron(mm, np.ones((n_pair, n_pair)))
        mm = mm * (batch_size * (1 - easy_negative_rate))
        max_margin = max_margin * torch.from_numpy(mm.astype(np.float32)).to(sim_matrix.device)
    return max_margin.mean()
