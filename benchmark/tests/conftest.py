"""Few threads a test process: the benchmark's tests run in several worker
processes at once, and a tiny model gains nothing from more."""

import torch

torch.set_num_threads(2)
