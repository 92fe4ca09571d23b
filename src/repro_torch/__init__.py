"""PyTorch + CUDA port of the ``repro`` serving path.

The package mirrors ``repro``'s module paths (``repro_torch.serving.continuous``
is the counterpart of ``repro.serving.continuous``, and so on) so a reader
finds each counterpart by its name.  It imports ``torch`` and numpy only —
never JAX, never the ``repro`` package.  The hot-path kernels
(``kernels/decode_attention`` and ``kernels/moe_dropless``) are hand-written
CUDA C++ for Hopper (``sm_90a``), built with ``nvcc`` at first use and bound
through ``ctypes``; on CPU tensors their wrappers run the plain PyTorch
versions in the matching ``ref.py``.
"""
