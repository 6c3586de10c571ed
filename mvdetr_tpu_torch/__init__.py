"""PyTorch/CUDA port of :mod:`mvdetr_tpu` for NVIDIA Hopper (H100).

The JAX package ``mvdetr_tpu`` stays the reference; this package mirrors its
module paths so each counterpart is easy to find, imports ``torch``, numpy and
scipy only, and never imports JAX or anything of ``mvdetr_tpu``.

This slice ports the serving path: a multiview frame set goes in and
ground-plane detections come out (``train.trainer.eval_step``). Its one TPU
kernel, the windowed deformable-attention forward, is the hand-written CUDA
kernel in ``csrc/msda_windowed_fwd.cu``.

Entry points run on the card (``device="cuda"``) unless the caller asks for
``device="cpu"``; they raise when no card is present.
"""

from mvdetr_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
