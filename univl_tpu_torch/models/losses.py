"""UniVL's training objectives, in PyTorch.

Ports ``univl_tpu/models/losses.py``: retrieval fine-tuning in stage one
(FT-Joint, FT-Align) trains with the max-margin ranking loss, or MIL-NCE
with ``use_mil``; stage two's caption fine-tuning with the decoder's masked
cross entropy and its retrieval fine-tuning with CrossEn; pretraining adds
the masked-language loss (the masked cross entropy again) and the
masked-frame NCE. Every loss reduces
over the batch it is given: the trainer calls it on each micro-batch's own
rows, so the negatives are that micro-batch's (the reference's per-device
negatives).
"""

from __future__ import annotations

import numpy as np
import torch

from univl_tpu_torch.parallel import comm


def _mil_mask(batch_size: int, n_pair: int) -> np.ndarray:
    """Block-diagonal positive mask: kron(I_B, ones(n_pair, n_pair))."""
    return np.kron(np.eye(batch_size), np.ones((n_pair, n_pair))).astype(np.float32)


def milnce_loss(sim_matrix: torch.Tensor, batch_size: int, n_pair: int) -> torch.Tensor:
    """MIL-NCE over a [B * n_pair, B * n_pair] similarity matrix whose
    positives are the n_pair x n_pair blocks on the diagonal, read at the
    middle row of each block (the reference's ``mark_ind``)."""
    mm_mask = torch.from_numpy(_mil_mask(batch_size, n_pair)).to(sim_matrix.device)
    from_text = sim_matrix + mm_mask * -1e12
    new_sim = torch.cat([sim_matrix.t(), from_text], dim=-1)
    logpt = torch.log_softmax(new_sim, dim=-1)
    mask_logpt = torch.cat([mm_mask, torch.zeros_like(mm_mask)], dim=-1)
    new_logpt = -torch.logsumexp(logpt + (1.0 - mask_logpt) * -1e12, dim=-1)
    mark_ind = torch.from_numpy(np.arange(batch_size) * n_pair + n_pair // 2)
    return new_logpt[mark_ind.to(sim_matrix.device)].mean()


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
                         ignore_index: int = -1, vocab=None) -> torch.Tensor:
    """The mean cross entropy (in f32) over positions whose label is not
    ``ignore_index``, 0 when none is (torch's ``ignore_index`` semantics
    without the NaN). Caption targets are padded with 0, not -1, so their
    padded positions count, as in the reference. ``vocab`` (a
    ``parallel/tp.py:VocabShard``): the logits are a tensor-parallel rank's
    vocab columns, and ``vocab_parallel_nll`` gives each position's loss."""
    logits = logits.reshape(-1, logits.shape[-1]).float()
    labels = labels.reshape(-1).long()
    valid = labels != ignore_index
    if vocab is not None:
        nll = vocab_parallel_nll(logits, torch.where(valid, labels, 0), vocab)
    else:
        logpt = torch.log_softmax(logits, dim=-1)
        nll = -logpt.gather(1, torch.where(valid, labels, 0)[:, None])[:, 0]
    return torch.where(valid, nll, 0.0).sum() / valid.sum().clamp(min=1)


def vocab_parallel_nll(logits: torch.Tensor, labels: torch.Tensor, vocab) -> torch.Tensor:
    """-log softmax(logits)[label] of each row over a vocab split across the
    tp ranks (Megatron's vocab-parallel cross entropy): logits ``[M, V/tp]``
    are the rank's columns ``[vocab.start, vocab.start + vocab.size)``. The
    row max, the sum of exponentials and the target's logit are each reduced
    over the ranks, so no rank holds ``[M, V]``; the gradient reaches each
    rank's columns alone (the reductions' backward is the identity, the loss
    being the same on every rank)."""
    mesh = vocab.mesh
    m = comm.all_reduce_max(logits.detach().amax(dim=-1), mesh)
    sum_exp = comm.reduce_from_tp(torch.exp(logits - m[:, None]).sum(dim=-1), mesh)
    local = labels - vocab.start
    inside = (local >= 0) & (local < vocab.size)
    target = logits.gather(1, torch.where(inside, local, 0)[:, None])[:, 0]
    target = comm.reduce_from_tp(torch.where(inside, target, 0.0), mesh)
    return torch.log(sum_exp) + m - target


def mfm_nce_loss(frame_scores: torch.Tensor, video: torch.Tensor, video_mask: torch.Tensor,
                 video_labels_index: torch.Tensor, ignore_index: int = -1) -> torch.Tensor:
    """Masked-frame NCE, in f32: each masked frame's predicted features
    ([B, F, video_dim], the visual head's) against every valid frame of the
    micro-batch (``video``, the normalized clean features), the positive its
    own; the mean over the masked frames, 0 when none is."""
    dim = frame_scores.shape[-1]
    scores = frame_scores.reshape(-1, dim).float()
    targets = video.reshape(-1, dim).float()
    m = video_mask.reshape(-1).float()
    masked_logits = scores @ targets.t() + (1.0 - m[:, None] * m[None, :]) * -1e8
    nce = -torch.diagonal(torch.log_softmax(masked_logits, dim=-1))
    sel = (video_labels_index.reshape(-1) != ignore_index).float()
    return (nce * sel).sum() / sel.sum().clamp(min=1.0)
