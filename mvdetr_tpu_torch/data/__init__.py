from mvdetr_tpu_torch.data.targets import build_targets, gaussian2d, splat_gaussian

__all__ = ["build_targets", "gaussian2d", "splat_gaussian"]
