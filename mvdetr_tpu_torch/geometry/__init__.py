from mvdetr_tpu_torch.geometry.projection import (
    extrinsic_from_rvec_tvec,
    inverse_plane_homography,
    look_at_extrinsic,
    pinhole_intrinsic,
    plane_homography,
    project_points,
    rodrigues,
)
from mvdetr_tpu_torch.geometry.rig import CameraRig
from mvdetr_tpu_torch.geometry.synthetic import make_synthetic_rig, make_wildtrack_like_rig

__all__ = [
    "CameraRig",
    "extrinsic_from_rvec_tvec",
    "inverse_plane_homography",
    "look_at_extrinsic",
    "make_synthetic_rig",
    "make_wildtrack_like_rig",
    "pinhole_intrinsic",
    "plane_homography",
    "project_points",
    "rodrigues",
]
