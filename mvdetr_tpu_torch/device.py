"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a :class:`torch.device`, refusing a CUDA device when no
    card is present. Entry points default to ``"cuda"``: a run without a card
    must ask for the CPU explicitly (``device="cpu"``), so a missing card is
    an error and never a silent CPU fallback."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "mvdetr_tpu_torch: no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
