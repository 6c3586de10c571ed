from mvdetr_tpu_torch.train.checkpoint import latest_step, restore_checkpoint, restore_weights, save_checkpoint
from mvdetr_tpu_torch.train.state import TrainState, create_train_state, load_full_variables
from mvdetr_tpu_torch.train.trainer import (
    Trainer, batch_to_device, decode_detections, eval_step, supervised_loss, train_step,
)

__all__ = ["TrainState", "Trainer", "batch_to_device", "create_train_state", "decode_detections", "eval_step",
           "latest_step", "load_full_variables", "restore_checkpoint", "restore_weights", "save_checkpoint",
           "supervised_loss", "train_step"]
