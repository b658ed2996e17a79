"""The port's kernels: hand-written CUDA for Hopper, each with a plain
PyTorch twin that CPU tensors run.

* B1 ``mgs_matmul.mgs_matmul_exact_fused`` — ``csrc/mgs_matmul.cu``
* B3 the same wrapper under ``schedule="weight"`` / ``"activation"`` —
  ``csrc/mgs_matmul.cu``
* B2 ``mgs_attention.mgs_flash_blocks`` (dense, paged and verify entries)
  — ``csrc/mgs_attention.cu``
* B4 ``mgs_matmul.mgs_matmul_exact`` (pre-decomposed limb planes) —
  ``csrc/mgs_matmul.cu``
* B5 ``mgs_matmul.mgs_matmul_dmac_codes`` (the paper's dMAC numerics over
  packed codes; ``mgs_matmul_dmac`` over float values) —
  ``csrc/mgs_dmac.cu``

``LAUNCHES`` counts the launches of each wrapper, ``BUILDS`` the ``nvcc``
runs of the process.
"""

from ._cuda import BUILDS, LAUNCHES, build_all, reset_launch_counts
from .mgs_attention import (mgs_flash_attention, mgs_flash_blocks,
                            mgs_paged_flash_attention,
                            mgs_paged_verify_attention)
from .mgs_matmul import (ACTIVATIONS, WS_STRIPE_BUDGET_BYTES, limb_decompose,
                         mgs_matmul_dmac, mgs_matmul_dmac_codes,
                         mgs_matmul_dmac_codes_plain, mgs_matmul_dmac_plain,
                         mgs_matmul_exact, mgs_matmul_exact_fused,
                         mgs_matmul_exact_fused_plain, mgs_matmul_exact_plain,
                         mgs_matmul_stationary_plain,
                         worst_case_flush_period, ws_stripe_bytes)
from .ops import apply_epilogue, mgs_matmul
from .ref import mgs_matmul_ref, wide_matmul_ref

__all__ = ["LAUNCHES", "BUILDS", "reset_launch_counts", "build_all", "ACTIVATIONS",
           "limb_decompose", "worst_case_flush_period",
           "mgs_matmul_exact_fused", "mgs_matmul_exact_fused_plain",
           "mgs_matmul_stationary_plain", "mgs_matmul_exact",
           "mgs_matmul_exact_plain", "mgs_matmul_dmac",
           "mgs_matmul_dmac_plain", "mgs_matmul_dmac_codes",
           "mgs_matmul_dmac_codes_plain", "WS_STRIPE_BUDGET_BYTES",
           "ws_stripe_bytes", "mgs_flash_attention",
           "mgs_paged_flash_attention", "mgs_paged_verify_attention",
           "mgs_flash_blocks", "mgs_matmul",
           "mgs_matmul_ref", "wide_matmul_ref", "apply_epilogue"]
