from mvdetr_tpu_torch.train.trainer import decode_detections, eval_step

__all__ = ["decode_detections", "eval_step"]
