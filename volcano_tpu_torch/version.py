"""Version of the PyTorch/CUDA port."""

VERSION = "0.1.0"
