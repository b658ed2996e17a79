"""MGS on PyTorch and CUDA: the port of the ``repro`` JAX package to one
NVIDIA H100.

Mirrors the reference's module names (``core``, ``quant``, ``kernels``,
``configs``, ``models``, ``launch``, ``data``, ``train``, ``runtime``);
parameter and optimizer trees are nested dicts (``tree``). The TPU kernels
become hand-written CUDA kernels for ``sm_90a`` under ``csrc/``, each
with a plain PyTorch twin that CPU tensors run. Imports ``torch``, numpy
and the standard library only.
"""

__version__ = "0.1.0"
