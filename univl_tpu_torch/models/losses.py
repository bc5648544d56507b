"""UniVL's training objectives, in PyTorch.

Ports the losses of ``univl_tpu/models/losses.py`` that the ported training
paths read: retrieval fine-tuning in stage one (FT-Joint, FT-Align) trains
with the max-margin ranking loss; stage two's caption fine-tuning with the
decoder's masked cross entropy and its retrieval fine-tuning with CrossEn;
MIL-NCE and the masked-frame loss come with pretraining. Every loss reduces
over the batch it is given: the trainer calls it on each micro-batch's own
rows, so the negatives are that micro-batch's (the reference's per-device
negatives).
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


def cross_en_loss(sim_matrix: torch.Tensor) -> torch.Tensor:
    """CrossEn: the mean negative log-softmax of the diagonal, over the rows
    of a square similarity matrix."""
    return -torch.diagonal(torch.log_softmax(sim_matrix, dim=-1)).mean()


def masked_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                         ignore_index: int = -1) -> torch.Tensor:
    """The mean cross entropy (in f32) over positions whose label is not
    ``ignore_index``, 0 when none is (torch's ``ignore_index`` semantics
    without the NaN). Caption targets are padded with 0, not -1, so their
    padded positions count, as in the reference."""
    logits = logits.reshape(-1, logits.shape[-1]).float()
    labels = labels.reshape(-1).long()
    valid = labels != ignore_index
    logpt = torch.log_softmax(logits, dim=-1)
    nll = -logpt.gather(1, torch.where(valid, labels, 0)[:, None])[:, 0]
    return torch.where(valid, nll, 0.0).sum() / valid.sum().clamp(min=1)
