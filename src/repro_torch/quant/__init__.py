"""Quantized execution of the port: config, quantizers, prepared weights,
the ``qmatmul`` / ``qeinsum`` dispatch, the packed KV cache, and
calibration (one-pass and streaming)."""

from .calibrate import (ActivationRecorder, CalibrationTable,
                        applied_calib_state, calibrating,
                        current_calib_state, current_recorder)
from .config import (FP8_MGS, FP8_MGS_EXACT, FP8_MGS_SERVE,
                     FP8_MGS_SERVE_KV, FP8_MGS_SERVE_PAGED, FP8_WIDE, NONE,
                     QuantConfig)
from .kvcache import (TRASH_BLOCK, BlockAllocator, PagedKVCache,
                      QuantizedKVCache, append_kv, gather_paged_kv,
                      init_paged_kv, init_quantized_kv, kv_cache_bytes,
                      paged_append_kv, paged_rollback_kv, quantize_kv)
from .prepared import (PREP_STATS, PreparedWeight, clear_prepared_cache,
                       prepare_logits_head, prepare_params, prepare_unembed,
                       prepare_weight)
from .qeinsum import plan_qeinsum, qeinsum
from .qmatmul import qmatmul
from .quantize import QTensor, quantize_fp8, quantize_fp8_static
from .streaming import (DriftReport, StreamingCalibrator, StreamingRecorder,
                        detect_drift, sample_gate, tv_distance)

__all__ = ["QuantConfig", "NONE", "FP8_MGS", "FP8_MGS_EXACT",
           "FP8_MGS_SERVE", "FP8_MGS_SERVE_KV", "FP8_MGS_SERVE_PAGED",
           "FP8_WIDE", "QTensor",
           "quantize_fp8", "quantize_fp8_static", "PreparedWeight",
           "prepare_weight", "prepare_params", "prepare_unembed",
           "prepare_logits_head", "PREP_STATS", "clear_prepared_cache",
           "qmatmul", "qeinsum", "plan_qeinsum", "QuantizedKVCache",
           "quantize_kv", "init_quantized_kv", "append_kv", "TRASH_BLOCK",
           "PagedKVCache", "BlockAllocator", "init_paged_kv",
           "paged_append_kv", "paged_rollback_kv", "gather_paged_kv",
           "kv_cache_bytes", "ActivationRecorder", "CalibrationTable",
           "applied_calib_state", "calibrating", "current_calib_state",
           "current_recorder", "DriftReport", "StreamingCalibrator",
           "StreamingRecorder", "detect_drift", "sample_gate",
           "tv_distance"]
