from mvdetr_tpu_torch.data.adapters import MultiviewXScene, WildtrackScene, open_scene
from mvdetr_tpu_torch.data.augment import random_affine, random_affine_matrix, warp_bboxes
from mvdetr_tpu_torch.data.dataset import FrameDataset, collate
from mvdetr_tpu_torch.data.prefetch import prefetch_to_device
from mvdetr_tpu_torch.data.source import FrameAnnotation, SyntheticScene
from mvdetr_tpu_torch.data.targets import build_targets, gaussian2d, splat_gaussian

__all__ = [
    "FrameAnnotation",
    "FrameDataset",
    "MultiviewXScene",
    "SyntheticScene",
    "WildtrackScene",
    "build_targets",
    "collate",
    "gaussian2d",
    "open_scene",
    "prefetch_to_device",
    "random_affine",
    "random_affine_matrix",
    "splat_gaussian",
    "warp_bboxes",
]
