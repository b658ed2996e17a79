"""Bit-level number formats of the port, the MGS numerics (the dMAC
matmul's helpers and the dot-level emulators with their counters), the
integer dMAC, the classical low-precision summations, the energy model,
and the absorbing-Markov overflow analysis (``markov``) behind the flush
planner."""

from .formats import (E3M4, E4M3, E5M2, FPFormat, decode_bits, decode_sm_e,
                      decompose, encode_bits, get_format, pow2,
                      quantum_exponent, recompose, representable_values,
                      round_to_format)
from .int_dmac import (IntDmacStats, average_accumulator_bits, int_dot_clip,
                       int_dot_dmac, int_dot_exact, int_dot_wrap)
from .mgs import (MGSStats, bin_sums, combine_bins, mgs_dot_dmac,
                  mgs_dot_exact, mgs_dot_narrow_clipped, mgs_matvec_exact,
                  round_product)
from . import energy, markov, summation

__all__ = ["FPFormat", "E4M3", "E5M2", "E3M4", "get_format", "pow2",
           "round_to_format", "decompose", "recompose", "encode_bits",
           "decode_bits", "decode_sm_e", "quantum_exponent",
           "representable_values", "IntDmacStats",
           "average_accumulator_bits", "int_dot_clip", "int_dot_dmac",
           "int_dot_exact", "int_dot_wrap", "MGSStats", "round_product",
           "bin_sums", "combine_bins", "mgs_dot_dmac", "mgs_dot_exact",
           "mgs_dot_narrow_clipped", "mgs_matvec_exact", "energy", "markov",
           "summation"]
