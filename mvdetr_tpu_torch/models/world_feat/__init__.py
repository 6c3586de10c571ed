from mvdetr_tpu_torch.models.world_feat.modules import DeformTransWorldFeat, DeformTransWorldFeatAIO, build_world_feat

__all__ = ["DeformTransWorldFeat", "DeformTransWorldFeatAIO", "build_world_feat"]
