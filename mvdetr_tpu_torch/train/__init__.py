from mvdetr_tpu_torch.train.state import TrainState, create_train_state
from mvdetr_tpu_torch.train.trainer import batch_to_device, decode_detections, eval_step, supervised_loss, train_step

__all__ = ["TrainState", "batch_to_device", "create_train_state", "decode_detections", "eval_step",
           "supervised_loss", "train_step"]
