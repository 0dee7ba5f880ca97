"""The main-path CUDA kernels, their plain PyTorch versions and wrappers."""
