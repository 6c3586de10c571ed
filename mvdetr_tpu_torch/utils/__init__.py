from mvdetr_tpu_torch.utils.logger import AverageMeter, Logger
from mvdetr_tpu_torch.utils.profiling import StepTimer, device_trace

__all__ = ["AverageMeter", "Logger", "StepTimer", "device_trace"]
