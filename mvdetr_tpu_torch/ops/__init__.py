from mvdetr_tpu_torch.ops.decode import ctdet_decode, heatmap_peaks, mvdet_decode, top_k
from mvdetr_tpu_torch.ops.msda_warped import ms_deform_attn_warped, shadow_warp_stack
from mvdetr_tpu_torch.ops.msda_windowed import ms_deform_attn_windowed, msda_windowed_fwd, windowed_attention
from mvdetr_tpu_torch.ops.nms import distance_nms
from mvdetr_tpu_torch.ops.sampling import bilinear_patch_sample
from mvdetr_tpu_torch.ops.warp import invert_3x3, perspective_warp

__all__ = [
    "bilinear_patch_sample",
    "ctdet_decode",
    "distance_nms",
    "heatmap_peaks",
    "invert_3x3",
    "ms_deform_attn_warped",
    "ms_deform_attn_windowed",
    "msda_windowed_fwd",
    "mvdet_decode",
    "perspective_warp",
    "shadow_warp_stack",
    "top_k",
    "windowed_attention",
]
