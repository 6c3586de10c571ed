from mvdetr_tpu_torch.utils.logger import AverageMeter, Logger
from mvdetr_tpu_torch.utils.profiling import device_trace, span

__all__ = ["AverageMeter", "Logger", "device_trace", "span"]
