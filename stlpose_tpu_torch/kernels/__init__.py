"""CUDA kernels of the port (csrc/*.cu), each beside its plain PyTorch
version and a launch counter."""
