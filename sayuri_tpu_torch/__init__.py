"""PyTorch + CUDA port of sayuri-tpu: the same engine on one NVIDIA card."""

__version__ = "0.1.0"
