"""The port's kernels: hand-written CUDA for Hopper, each with a plain
PyTorch twin that CPU tensors run.

* B1 ``mgs_matmul.mgs_matmul_exact_fused`` — ``csrc/mgs_matmul.cu``
* B2 ``mgs_attention.mgs_flash_blocks`` — ``csrc/mgs_attention.cu``

``LAUNCHES`` counts the launches of each wrapper.
"""

from ._cuda import LAUNCHES, build_all, reset_launch_counts
from .mgs_attention import mgs_flash_attention, mgs_flash_blocks
from .mgs_matmul import (ACTIVATIONS, limb_decompose,
                         mgs_matmul_exact_fused,
                         mgs_matmul_exact_fused_plain,
                         worst_case_flush_period)
from .ops import apply_epilogue, mgs_matmul
from .ref import mgs_matmul_ref

__all__ = ["LAUNCHES", "reset_launch_counts", "build_all", "ACTIVATIONS",
           "limb_decompose", "worst_case_flush_period",
           "mgs_matmul_exact_fused", "mgs_matmul_exact_fused_plain",
           "mgs_flash_attention", "mgs_flash_blocks", "mgs_matmul",
           "mgs_matmul_ref", "apply_epilogue"]
