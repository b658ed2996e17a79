"""Quantized execution of the port: config, quantizers (FP8 and integer),
prepared weights, the ``qmatmul`` / ``qeinsum`` dispatch, the packed KV
cache, and calibration (one-pass and streaming)."""

from .calibrate import (ActivationRecorder, CalibrationTable,
                        applied_calib_state, calibrating,
                        current_calib_state, current_recorder)
from .config import (FP8_MGS, FP8_MGS_EXACT, FP8_MGS_SERVE,
                     FP8_MGS_SERVE_KV, FP8_MGS_SERVE_PAGED, FP8_WIDE,
                     INT8_DMAC, NONE, QuantConfig)
from .kvcache import (TRASH_BLOCK, BlockAllocator, PagedKVCache,
                      QuantizedKVCache, append_kv, gather_paged_kv,
                      init_paged_kv, init_quantized_kv, kv_cache_bytes,
                      paged_append_kv, paged_rollback_kv, quantize_kv)
from .prepared import (PREP_STATS, PreparedWeight, clear_prepared_cache,
                       prepare_logits_head, prepare_params, prepare_unembed,
                       prepare_weight)
from .qeinsum import plan_qeinsum, qeinsum
from .qmatmul import qmatmul
from .quantize import (QTensor, dequantize_int, fake_quant_fp8,
                       fake_quant_int, quantize_fp8, quantize_fp8_static,
                       quantize_int)
from .streaming import (DriftReport, StreamingCalibrator, StreamingRecorder,
                        detect_drift, sample_gate, tv_distance)

__all__ = ["QuantConfig", "NONE", "FP8_MGS", "FP8_MGS_EXACT",
           "FP8_MGS_SERVE", "FP8_MGS_SERVE_KV", "FP8_MGS_SERVE_PAGED",
           "FP8_WIDE", "INT8_DMAC", "QTensor",
           "quantize_fp8", "quantize_fp8_static", "quantize_int",
           "dequantize_int", "fake_quant_fp8", "fake_quant_int",
           "PreparedWeight",
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
