from mvdetr_tpu_torch.ops.decode import heatmap_peaks, mvdet_decode, top_k
from mvdetr_tpu_torch.ops.msda_windowed import ms_deform_attn_windowed, msda_windowed_fwd, windowed_attention
from mvdetr_tpu_torch.ops.nms import distance_nms
from mvdetr_tpu_torch.ops.sampling import bilinear_patch_sample
from mvdetr_tpu_torch.ops.warp import invert_3x3, perspective_warp

__all__ = [
    "bilinear_patch_sample",
    "distance_nms",
    "heatmap_peaks",
    "invert_3x3",
    "ms_deform_attn_windowed",
    "msda_windowed_fwd",
    "mvdet_decode",
    "perspective_warp",
    "top_k",
    "windowed_attention",
]
