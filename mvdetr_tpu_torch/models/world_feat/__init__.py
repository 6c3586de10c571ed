from mvdetr_tpu_torch.models.world_feat.modules import DeformTransWorldFeat, build_world_feat

__all__ = ["DeformTransWorldFeat", "build_world_feat"]
