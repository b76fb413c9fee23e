"""Device resolution for the port's entry points.

Entry points that create tensors (``api.fit``, ``support.select_support``,
``synthetic.aimpeak_like``, ``covariance.init_params``) run on the card
unless the caller names another device. They never drop to the CPU on
their own: a missing card is an error, not a slow run.
"""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the CUDA card."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device unless told otherwise, and "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch path on the CPU")
    return torch.device("cuda")
