from mvdetr_tpu_torch.models.world_feat.modules import (
    ConvWorldFeat, DeformConvWorldFeat, DeformTransWorldFeat, DeformTransWorldFeatAIO, TransformerWorldFeat,
    build_world_feat,
)

__all__ = ["ConvWorldFeat", "DeformConvWorldFeat", "DeformTransWorldFeat", "DeformTransWorldFeatAIO",
           "TransformerWorldFeat", "build_world_feat"]
