"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version (``ref.py``).  A wrapper runs the plain version only for CPU
tensors; for a CUDA tensor it launches its kernel or raises."""
