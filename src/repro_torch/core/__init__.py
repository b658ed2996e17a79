"""Bit-level number formats of the port, the dMAC numerics of MGS, and the
absorbing-Markov overflow analysis (``markov``) behind the flush planner."""

from .formats import (E3M4, E4M3, E5M2, FPFormat, decode_bits, decode_sm_e,
                      decompose, encode_bits, get_format, pow2, recompose,
                      round_to_format)
from .mgs import bin_sums, combine_bins, round_product
from . import markov

__all__ = ["FPFormat", "E4M3", "E5M2", "E3M4", "get_format", "pow2",
           "round_to_format", "decompose", "recompose", "encode_bits",
           "decode_bits", "decode_sm_e", "round_product", "bin_sums",
           "combine_bins", "markov"]
