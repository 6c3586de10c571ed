from mvdetr_tpu_torch.models.deformable import DeformableEncoder, MSDeformAttn
from mvdetr_tpu_torch.models.heads import OutputHead
from mvdetr_tpu_torch.models.mvdetr import MVDeTr
from mvdetr_tpu_torch.models.resnet import resnet_features
from mvdetr_tpu_torch.models.world_feat import build_world_feat

__all__ = ["DeformableEncoder", "MSDeformAttn", "MVDeTr", "OutputHead", "build_world_feat", "resnet_features"]
