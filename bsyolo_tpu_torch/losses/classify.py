"""Classification loss (counterpart of ``bsyolo_tpu/losses/classify.py``): the mean cross-entropy."""

from __future__ import annotations

from typing import Tuple

import torch

from bsyolo_tpu_torch.losses.detect import LossState


def classification_loss(logits: torch.Tensor, labels: torch.Tensor, state: LossState,
                        cfg=None) -> Tuple[torch.Tensor, torch.Tensor, LossState]:
    """(total, items [loss] (1,), state unchanged), as the task losses return them; ``logits`` (B, nc),
    ``labels`` (B,) int."""
    logp = torch.log_softmax(logits.float(), -1)
    loss = -logp.gather(1, labels.long()[:, None])[:, 0].mean()
    return loss, loss[None], state
