"""Quantized-execution configuration (the port's copy of ``repro.quant.config``).

A ``QuantConfig`` selects the number format of weights/activations and the
accumulation strategy for every matmul routed through
:mod:`repro_torch.quant.qmatmul`. The fields and presets are identical to
the reference's, so one config value means the same numerics in both
packages; the port runs the subset its slices have landed (see
``ROADMAP.md``) and raises ``NotImplementedError`` on the rest. The paper's MGS is ``accum="mgs_dmac"``
(bit-faithful) or ``accum="mgs_exact"`` (our TPU-native exact fixed-point
variant); the baselines it compares against are ``"wide"`` (FP32
accumulation — what H100/TPU hardware does), ``"clip"`` (saturation) and
``"swamp"`` (sequential narrow-mantissa accumulation).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.core.formats import FPFormat, get_format

__all__ = ["QuantConfig", "DTYPES", "ACCUMS", "SCHEDULES", "KV_CACHES"]

DTYPES = ("none", "int8", "int5", "int4", "fp8_e4m3", "fp8_e5m2")
ACCUMS = ("wide", "mgs_exact", "mgs_dmac", "clip", "wrap", "swamp")
SCHEDULES = ("output", "weight", "activation")
KV_CACHES = ("float", "packed")
# Narrow-exponent formats the exact limb kernels support; the packed KV
# cache decode runs through them, so kv_format is restricted to this set.
_KV_FORMATS = ("e4m3", "e3m4")


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Configuration for one quantized matmul family.

    Attributes:
      dtype: operand format (weights and activations).
      accum: accumulation strategy (see module docstring).
      narrow_bits: narrow accumulator width for dmac/clip emulation paths
        (5 signed bits in the paper's FP8 evaluation, §6.2.2).
      act_bits / weight_bits: integer operand widths for the int paths
        (the paper sweeps 5..8, §6.2.1).
      per_channel: per-output-channel weight scales (vs per-tensor).
      per_row_act: per-row activation scales (vs per-tensor). Each
        ``(..., K)`` activation row is absmax-scaled independently, so a
        row's quantized codes depend only on that row's values — no
        coupling through a batch-wide absmax. This is what makes a
        decode step *row-independent* end to end (KV-cache scales and
        decode attention are already per-slice): the continuous-batching
        engine requires it, because its determinism contract is that a
        request's logits do not depend on which requests happen to share
        the batch (docs/serving.md; ``tests/test_continuous.py``). Off
        by default — per-tensor is the baseline numerics every existing
        pin test is anchored to.
      gate_subnormal: §5.3 subnormal gating of tiny products.
      use_kernel: route through the hand-written CUDA kernel (CPU tensors
        run its plain PyTorch twin). False = the plain emulation path
        (``kernels.ref``).
      fused: exact-mode kernel variant. True streams *packed* FP8 codes
        (1 byte/elem HBM) and decodes + limb-splits per tile in VMEM, with
        the dequant-scale/bias/activation epilogue fused into the kernel;
        False streams pre-decomposed int8 limb planes (3 bytes/elem, the
        A/B baseline).
      schedule: fused-kernel loop order. "output" (default) is
        output-stationary: both operand tiles are decoded at every grid
        step. "weight" is the K-resident weight-stationary schedule: the
        decoded weight limb stripe is cached in VMEM scratch across the
        M-grid axis, cutting in-kernel weight decode work grid_m-fold.
        "activation" is the symmetric activation-stationary schedule:
        the decoded x limb stripe is cached across the N-grid axis,
        cutting activation decode work grid_n-fold (wide-N layers). All
        three are bit-identical; stationary schedules fall back to
        "output" with a warning when the stripe exceeds the VMEM budget.
      block_m/n/k: tile sizes; ``block_k`` is the K-step the flush
        period counts, and the packed KV cache's chunk.
      flush_target: probabilistic overflow budget used by the Markov
        planner (core.markov.plan_flush_period) to derive the kernel flush
        period; None = deterministic worst-case bound.
      calibration: observed per-call-site activation limb sigmas — a
        sorted tuple of (site, sigma) pairs (hashable, so the frozen
        config stays usable as a jit static). Built by
        quant.calibrate.CalibrationTable / ServeEngine.calibrate; when
        set, the Markov planner uses the site's observed activation
        sigma instead of the uniform-limb default, making flush periods
        per-call-site rather than global.
      kv_cache: decode KV-cache representation. "float" stores K/V in
        ``ModelConfig.kv_cache_dtype`` and re-quantizes them per decode
        step for the score/value contractions. "packed" stores K/V as
        packed FP8 *codes* (1 byte/element, ``quant.kvcache``) with
        per-entry scales — append re-quantizes only the new entries, and
        decode attention streams the codes straight into the MGS
        flash-decode kernel (``kernels.mgs_attention``). Requires an
        exact-MGS fp8 config (the packed path has no float fallback
        numerics of its own).
      kv_format: FP8 format of the packed cache codes (narrow-exponent
        only: the exact limb kernels decode them in-VMEM).
      draft_layers: speculative-decoding self-draft depth. When set, the
        serving engine's draft pass runs only the first ``draft_layers``
        transformer layers (plus the final norm and logits head) to
        propose candidate tokens; the full model verifies them. Draft
        numerics never leak into accepted output — acceptance is an
        exact ``==`` against the full model's greedy tokens — so this
        knob trades acceptance *rate* against draft cost only. ``None``
        disables truncated drafting (drafts run the full model, useful
        only for testing the spec plumbing).
      static_q_scale: use the calibrated static decode-query scale. When
        True and ``calibration`` carries an ``"attn.q.amax"`` entry, the
        packed/paged decode attention quantizes q with that fixed scale
        instead of a per-step absmax reduce — one fewer reduction on the
        decode critical path. Rows exceeding the calibrated amax are
        clipped (the standard static-quantization contract); when the
        running absmax stays within the calibrated one, the quantized
        codes are bitwise identical to the dynamic path's. Falls back to
        dynamic absmax when no calibrated entry exists.
    """

    dtype: str = "none"
    accum: str = "wide"
    narrow_bits: int = 5
    act_bits: int = 8
    weight_bits: int = 8
    per_channel: bool = False
    per_row_act: bool = False
    gate_subnormal: bool = True
    use_kernel: bool = False
    fused: bool = False
    schedule: str = "output"
    block_m: int = 128
    block_n: int = 128
    block_k: int = 128
    flush_target: Optional[float] = None
    calibration: Optional[Tuple[Tuple[str, float], ...]] = None
    kv_cache: str = "float"
    kv_format: str = "e4m3"
    draft_layers: Optional[int] = None
    static_q_scale: bool = False

    def __post_init__(self):
        if self.draft_layers is not None and self.draft_layers < 1:
            raise ValueError(f"draft_layers must be >= 1 when set, got "
                             f"{self.draft_layers}")
        if self.dtype not in DTYPES:
            raise ValueError(f"dtype {self.dtype!r} not in {DTYPES}")
        if self.accum not in ACCUMS:
            raise ValueError(f"accum {self.accum!r} not in {ACCUMS}")
        if self.schedule not in SCHEDULES:
            raise ValueError(f"schedule {self.schedule!r} not in "
                             f"{SCHEDULES}")
        if self.kv_cache not in KV_CACHES:
            raise ValueError(f"kv_cache {self.kv_cache!r} not in "
                             f"{KV_CACHES}")
        if self.kv_format not in _KV_FORMATS:
            raise ValueError(f"kv_format {self.kv_format!r} not in "
                             f"{_KV_FORMATS} (the exact limb kernels "
                             f"need a narrow-exponent format)")
        if self.kv_cache == "packed" and not (
                self.is_fp8 and self.accum == "mgs_exact"):
            raise ValueError(
                "kv_cache='packed' requires dtype='fp8_*' and "
                "accum='mgs_exact': the packed cache is consumed by the "
                "MGS flash-decode attention kernel "
                f"(got dtype={self.dtype!r}, accum={self.accum!r})")
        if self.calibration is not None:
            # normalize unconditionally (CalibrationTable / dict / any
            # pair iterable -> sorted, coerced tuple) so equal tables
            # always compare and hash equal
            object.__setattr__(self, "calibration",
                               _calibration_pairs(self.calibration))

    @property
    def is_fp8(self) -> bool:
        return self.dtype.startswith("fp8")

    @property
    def quantized_kv(self) -> bool:
        """True when the decode KV cache stores packed FP8 codes."""
        return self.kv_cache == "packed"

    @property
    def kv_fmt(self) -> FPFormat:
        """The packed KV cache's code format."""
        return get_format(self.kv_format)

    @property
    def is_int(self) -> bool:
        return self.dtype.startswith("int")

    @property
    def fmt(self) -> FPFormat:
        if not self.is_fp8:
            raise ValueError(f"{self.dtype} has no FP format")
        return get_format(self.dtype.split("_", 1)[1])

    @property
    def int_bits(self) -> int:
        if not self.is_int:
            raise ValueError(f"{self.dtype} is not an int dtype")
        return int(self.dtype[3:])

    @property
    def fp8_margin(self) -> float:
        """Operand-scaling headroom for the fp8 paths.

        Paths that round *products* back into the FP8 format (Fig. 8
        hardware) scale each operand so amax -> sqrt(max_finite),
        guaranteeing |qx*qw| <= max_finite and hence no product
        saturation. The exact path performs no product re-rounding, so
        operands may fill the whole range (a beyond-paper accuracy
        advantage of the limb kernel, quantified in benchmarks).
        """
        if self.accum in ("mgs_dmac", "swamp"):
            return self.fmt.max_finite ** -0.5
        return 1.0

    @property
    def fused_exact(self) -> bool:
        """True when matmuls run the streaming limb-fused exact kernel."""
        return (self.is_fp8 and self.accum == "mgs_exact"
                and self.use_kernel and self.fused)

    def act_sigma(self, site: Optional[str]) -> Optional[float]:
        """Observed activation limb sigma for a call site, or None."""
        if self.calibration is None or site is None:
            return None
        for s, sigma in self.calibration:
            if s == site:
                return sigma
        return None

    def with_calibration(self, table) -> "QuantConfig":
        """Config carrying observed per-site activation sigmas.

        ``table``: a ``quant.calibrate.CalibrationTable``, a mapping, or
        an iterable of (site, sigma) pairs; ``None`` clears calibration.
        """
        pairs = None if table is None else _calibration_pairs(table)
        return dataclasses.replace(self, calibration=pairs)

    def replace(self, **kw) -> "QuantConfig":
        return dataclasses.replace(self, **kw)


def _calibration_pairs(table) -> Tuple[Tuple[str, float], ...]:
    if hasattr(table, "to_pairs"):
        return table.to_pairs()
    items = table.items() if hasattr(table, "items") else table
    return tuple(sorted((str(k), float(v)) for k, v in items))


NONE = QuantConfig()
FP8_MGS = QuantConfig(dtype="fp8_e4m3", accum="mgs_dmac")
FP8_MGS_EXACT = QuantConfig(dtype="fp8_e4m3", accum="mgs_exact")
# Serving preset: streaming limb-fused kernel over packed codes with
# prepared weights (see quant.prepared) and fused epilogues.
FP8_MGS_SERVE = QuantConfig(dtype="fp8_e4m3", accum="mgs_exact",
                            use_kernel=True, fused=True)
# Serving preset with the packed FP8 KV cache: decode attention streams
# 1-byte cache codes through the MGS flash-decode kernel
# (kernels.mgs_attention), halving decode HBM traffic vs a bf16 cache.
FP8_MGS_SERVE_KV = QuantConfig(dtype="fp8_e4m3", accum="mgs_exact",
                               use_kernel=True, fused=True,
                               kv_cache="packed")
# Continuous-batching serving preset: packed cache + per-row activation
# scales, making every decode step row-independent — the numerics the
# paged slot engine (launch.serve.ContinuousBatchingEngine) requires for
# its traffic-invariant bit-identity contract.
FP8_MGS_SERVE_PAGED = FP8_MGS_SERVE_KV.replace(per_row_act=True)
FP8_WIDE = QuantConfig(dtype="fp8_e4m3", accum="wide")
INT8_DMAC = QuantConfig(dtype="int8", accum="mgs_dmac")
