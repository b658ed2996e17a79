"""dMAC energy/area model — paper §6.4 (Table 3), as a transferable model.
The port's own copy of ``repro.core.energy`` (numpy only).

We cannot re-run the 7 nm ASAP7 flow; instead we expose an analytical
per-operation energy model whose components are calibrated so that, under
the paper's reported workload statistics, it reproduces the paper's
measured totals (Table 3). During emulated inference the ``MGSStats`` /
``IntDmacStats`` counters (``core.mgs``, ``core.int_dmac``) feed this
model to estimate energy per layer / per model and the dMAC-vs-MAC
savings — the Fig. 4b / Fig. 9 / Table 3 quantities.

Calibration assumptions (documented, adjustable):
* Paper's units run at 500 MHz, 0.7 V. Energy/op = power / frequency.
* Conventional FP8 MAC (Table 3): 97.37 µW → 194.7 fJ/MAC. Every MAC pays
  FP8→FP32 conversion + wide (24-bit-mantissa) add + normalization.
* FP8 dMAC w/o skipping: 64.66 µW → 129.3 fJ/MAC *at the paper's traced
  ViT overflow rate*. We decompose this into a base (multiply + round +
  narrow 5-bit add + register write) cost plus a per-overflow wide flush
  cost, calibrated at an assumed traced overflow rate of 2%.
* INT8 MAC 27.48 µW → 55.0 fJ; INT8 dMAC 23.25 µW → 46.5 fJ at the traced
  MobileNetV2 overflow rate (assumed 2%).
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["EnergyModel", "FP8_MODEL", "INT8_MODEL", "PAPER_TABLE3",
           "PAPER_TABLE2"]

# Verbatim paper tables, for reporting/benchmark comparison.
PAPER_TABLE3 = {
    # unit: (dynamic µW, static µW, total µW, savings vs baseline)
    "INT8 MAC": (27.41, 0.073, 27.48, 0.0),
    "INT8 dMAC": (23.16, 0.085, 23.25, 0.154),
    "FP8 MAC": (97.12, 0.249, 97.37, 0.0),
    "FP8 dMAC (w/o skipping)": (64.44, 0.226, 64.66, 0.336),
    "FP8 dMAC (w/ skipping)": (63.92, 0.232, 64.15, 0.341),
}

PAPER_TABLE2 = {
    # unit: (FPGA LUTs, FPGA FFs)
    "INT8 MAC": (107, 81),
    "INT8 dMAC": (126, 79),
    "FP8 MAC": (457, 335),
    "FP8 dMAC (w/o skipping)": (165, 143),
    "FP8 dMAC (w/ skipping)": (180, 143),
}

_FREQ_HZ = 500e6
_CAL_OVERFLOW_RATE = 0.02  # assumed traced overflow rate for calibration


@dataclasses.dataclass(frozen=True)
class EnergyModel:
    """Per-event energies in femtojoules."""

    name: str
    e_conventional_mac: float   # full wide-accumulate MAC
    e_narrow_mac: float         # multiply + round + narrow add + reg write
    e_wide_flush: float         # shift + wide add on overflow / final drain
    e_skip_check: float         # exponent gate logic (paper §5.3)
    e_skipped_mac: float        # residual cost of a gated (skipped) MAC
    static_w_conv: float        # static power, conventional unit (µW)
    static_w_dmac: float        # static power, dMAC unit (µW)

    def conventional_energy(self, n_macs) -> float:
        """Energy (fJ) of n MACs on the conventional wide-accumulator unit."""
        return float(np.asarray(n_macs, np.float64) * self.e_conventional_mac)

    def dmac_energy(self, n_narrow, n_flushes, n_skipped=0,
                    skipping: bool = False) -> float:
        """Energy (fJ) of a dMAC execution trace.

        ``n_narrow``: narrow-adder activations; ``n_flushes``: wide flushes
        (overflow + final drains); ``n_skipped``: subnormal-gated MACs.
        """
        n_narrow = float(np.asarray(n_narrow, np.float64))
        n_flushes = float(np.asarray(n_flushes, np.float64))
        n_skipped = float(np.asarray(n_skipped, np.float64))
        e = n_narrow * self.e_narrow_mac + n_flushes * self.e_wide_flush
        if skipping:
            e += (n_narrow + n_skipped) * self.e_skip_check
            e += n_skipped * self.e_skipped_mac
        else:
            # without gating, skipped products still ride the full pipeline
            e += n_skipped * self.e_narrow_mac
        return e

    def savings(self, n_narrow, n_flushes, n_skipped=0,
                skipping: bool = False) -> float:
        """Fractional energy savings vs the conventional unit."""
        total_macs = (float(np.asarray(n_narrow, np.float64))
                      + float(np.asarray(n_skipped, np.float64)))
        conv = self.conventional_energy(total_macs)
        dmac = self.dmac_energy(n_narrow, n_flushes, n_skipped, skipping)
        return 1.0 - dmac / max(conv, 1e-30)

    def average_power_uw(self, n_narrow, n_flushes, n_skipped=0,
                         skipping: bool = False, freq_hz: float = _FREQ_HZ):
        """Average dynamic power if the trace streams at one MAC/cycle."""
        total = (float(np.asarray(n_narrow, np.float64))
                 + float(np.asarray(n_skipped, np.float64)))
        e_fj = self.dmac_energy(n_narrow, n_flushes, n_skipped, skipping)
        return (e_fj / max(total, 1.0)) * 1e-15 * freq_hz * 1e6  # µW


def _calibrate_fp8() -> EnergyModel:
    e_conv = PAPER_TABLE3["FP8 MAC"][2] / _FREQ_HZ * 1e15 / 1e6  # fJ
    e_dmac_avg = (PAPER_TABLE3["FP8 dMAC (w/o skipping)"][2] / _FREQ_HZ
                  * 1e15 / 1e6)
    # e_narrow + r * e_wide = e_dmac_avg at calibration overflow rate r;
    # take the wide flush to cost ~80% of a conventional MAC (shift+wide add,
    # no normalize) and solve for the narrow base.
    e_wide = 0.8 * e_conv
    e_narrow = e_dmac_avg - _CAL_OVERFLOW_RATE * e_wide
    return EnergyModel(
        name="fp8",
        e_conventional_mac=e_conv,
        e_narrow_mac=e_narrow,
        e_wide_flush=e_wide,
        e_skip_check=0.5,
        e_skipped_mac=0.1 * e_narrow,
        static_w_conv=PAPER_TABLE3["FP8 MAC"][1],
        static_w_dmac=PAPER_TABLE3["FP8 dMAC (w/ skipping)"][1],
    )


def _calibrate_int8() -> EnergyModel:
    e_conv = PAPER_TABLE3["INT8 MAC"][2] / _FREQ_HZ * 1e15 / 1e6
    e_dmac_avg = PAPER_TABLE3["INT8 dMAC"][2] / _FREQ_HZ * 1e15 / 1e6
    e_wide = 0.8 * e_conv
    e_narrow = e_dmac_avg - _CAL_OVERFLOW_RATE * e_wide
    return EnergyModel(
        name="int8",
        e_conventional_mac=e_conv,
        e_narrow_mac=e_narrow,
        e_wide_flush=e_wide,
        e_skip_check=0.25,
        e_skipped_mac=0.1 * e_narrow,
        static_w_conv=PAPER_TABLE3["INT8 MAC"][1],
        static_w_dmac=PAPER_TABLE3["INT8 dMAC"][1],
    )


FP8_MODEL = _calibrate_fp8()
INT8_MODEL = _calibrate_int8()
