"""Model losses. Only ``classifier_loss`` is ported so far (the LeNet
path); the LM stack of ``repro.models.model`` comes with the serving
slice."""
from __future__ import annotations

import torch


def classifier_loss(logits, labels, weights):
    """Weighted mean softmax cross-entropy; labels are integer classes."""
    lf = logits.to(torch.float32)
    logz = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.to(torch.int64)[..., None])[..., 0]
    w = weights.to(torch.float32)
    return torch.sum((logz - gold) * w) / torch.clamp(torch.sum(w), min=1.0)
