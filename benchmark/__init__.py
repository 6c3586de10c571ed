"""The benchmark of the PyTorch and CUDA port (``mvdetr_tpu_torch``): see ``run.py``."""
