"""PyTorch/CUDA port of :mod:`mvdetr_tpu` for NVIDIA Hopper (H100).

The JAX package ``mvdetr_tpu`` stays the reference; this package mirrors its
module paths so each counterpart is easy to find, imports ``torch``, numpy and
scipy only, and never imports JAX or anything of ``mvdetr_tpu``.

Ported so far: serving (a multiview frame set in, ground-plane detections
out, ``train.trainer.eval_step``) and training (``train.trainer.train_step``:
loss, backward, two-group Adam + OneCycle). Their TPU kernels are
hand-written CUDA kernels in ``csrc/``: the windowed deformable-attention
forward and backward, and the backward of the perspective warp.

Entry points run on the card (``device="cuda"``) unless the caller asks for
``device="cpu"``; they raise when no card is present.
"""

from mvdetr_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
