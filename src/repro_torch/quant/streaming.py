"""Streaming calibration: drift detection over live serve traffic
(``repro.quant.streaming``).

``quant.calibrate`` is a one-shot trace; production traffic drifts, and a
stale limb PMF mis-plans flush periods. This module keeps the plan live
without touching the served numerics:

1. **Sampling gate** — :func:`sample_gate` admits every Nth unit of
   traffic (group / admission), offset by a seed: integer arithmetic,
   deterministic in ``(seed, index)``.
2. **Streaming recorder** — :class:`StreamingRecorder` folds each call's
   normalized limb PMF (and the amax) into an exponential moving average,
   so old traffic decays. Engines feed it through *shadow passes*: the
   gated tokens re-run under ``calibrating(recorder)`` beside the served
   pass, whose bits observation never touches.
3. **Drift detector** — :func:`detect_drift` compares the streaming
   statistics with the installed
   :class:`~repro_torch.quant.calibrate.CalibrationTable`: relative sigma
   delta, total-variation distance from a baseline PMF snapshot, relative
   amax delta.
4. **Refresh** — :class:`StreamingCalibrator` turns a drift verdict into
   ``table.refreshed(...)`` (a version bump) handed to an ``apply_fn``
   (``ServeEngine.apply_calibration``). Flush periods reach the kernels as
   runtime arguments, so the swap builds nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np

from repro_torch.core.markov import Pmf
from repro_torch.quant.calibrate import (ActivationRecorder,
                                         CalibrationTable, _LIMB_LO)

__all__ = ["DriftReport", "StreamingCalibrator", "StreamingRecorder",
           "detect_drift", "sample_gate", "tv_distance"]


def sample_gate(seed: int, index: int, period: int) -> bool:
    """Deterministic sampling gate: admit every ``period``-th index.

    ``(index + seed) % period == 0`` — integer-only, so the decision is
    a pure function of ``(seed, index, period)``: the same traffic
    replayed through the same gate samples the same units, and two
    replicas with different seeds stagger their shadow passes instead
    of all sampling the same group. ``period <= 1`` admits everything.
    """
    period = int(period)
    if period <= 1:
        return True
    return (int(index) + int(seed)) % period == 0


class StreamingRecorder(ActivationRecorder):
    """EMA variant of the batch recorder, for open-ended traffic.

    Each :meth:`record` call folds that call's *normalized* limb PMF
    into a per-site EMA: ``p_t = (1 - decay) * pmf_call + decay *
    p_{t-1}``. Convex combinations of normalized vectors stay
    normalized, so the inherited :meth:`pmf`/:meth:`table` work
    unchanged — but unlike the batch recorder's raw-count accumulation,
    traffic from an hour ago decays geometrically, which is what lets
    the sigma *track* a drifting distribution. On a stationary stream
    the EMA converges to the same PMF the batch recorder measures; on a
    degenerate (constant) stream they are exactly equal. Every call folds
    in through :meth:`record_counts` (``record`` and
    ``quant.calibrate.observe`` both reach it).

    ``record_amax`` is likewise an EMA rather than the batch
    recorder's max-fold: a running max can only ratchet upward, which
    would pin the static decode-query scale at a historical spike
    forever; the EMA tracks drift in both directions.

    ``muted`` pauses observation (checked under the lock — engines mute
    during replay so a replayed request never perturbs live
    statistics). Thread-safe: replica workers share one instance.
    """

    def __init__(self, decay: float = 0.9):
        super().__init__()
        if not 0.0 <= decay < 1.0:
            raise ValueError(f"decay must be in [0, 1): {decay}")
        self.decay = float(decay)
        self.muted = False

    def record_counts(self, site: str, counts: np.ndarray):
        counts = np.asarray(counts, np.float64)
        p_call = counts / counts.sum()
        with self._lock:
            if self.muted:
                return
            if site in self._counts:
                d = self.decay
                self._counts[site] = (1.0 - d) * p_call + d * self._counts[site]
                self._calls[site] += 1
            else:
                self._counts[site] = p_call
                self._calls[site] = 1

    def record_amax(self, site: str, value: float):
        v = float(value)
        with self._lock:
            if self.muted:
                return
            if site in self._amax:
                d = self.decay
                self._amax[site] = (1.0 - d) * v + d * self._amax[site]
            else:
                self._amax[site] = v


def tv_distance(p: Pmf, q: Pmf) -> float:
    """Total-variation distance ``0.5 * sum |p - q|`` over a joint support."""
    lo = min(p.lo, q.lo)
    hi = max(p.hi, q.hi)
    a = np.zeros(hi - lo + 1)
    b = np.zeros(hi - lo + 1)
    a[p.lo - lo:p.lo - lo + len(p.probs)] = p.probs
    b[q.lo - lo:q.lo - lo + len(q.probs)] = q.probs
    return float(0.5 * np.abs(a - b).sum())


@dataclasses.dataclass(frozen=True)
class DriftReport:
    """Verdict of one drift check against an installed table.

    ``sigma_delta`` / ``tv`` / ``amax_delta`` carry the per-site
    relative sigma change, TV distance against the baseline PMF
    snapshot, and relative amax change; ``drifted_sites`` lists the
    sites that tripped a threshold. ``drifted`` is the overall verdict.
    """

    drifted: bool
    drifted_sites: Tuple[str, ...]
    sigma_delta: Mapping[str, float]
    tv: Mapping[str, float]
    amax_delta: Mapping[str, float]

    def __bool__(self):
        return self.drifted


def detect_drift(recorder: ActivationRecorder, table: CalibrationTable, *,
                 baseline: Optional[Mapping[str, Pmf]] = None,
                 sigma_rtol: float = 0.10, tv_threshold: float = 0.05,
                 amax_rtol: float = 0.25,
                 min_calls: int = 1) -> DriftReport:
    """Compare streaming statistics against the installed table.

    A site drifts when its streaming limb sigma moved more than
    ``sigma_rtol`` (relative) from the table's planned sigma, when its
    PMF moved more than ``tv_threshold`` in total variation from the
    ``baseline`` snapshot (the PMFs captured when the current table was
    installed), or when its EMA amax moved more than ``amax_rtol`` from
    the table's ``<site>.amax`` entry. Sites with fewer than
    ``min_calls`` recorded calls are skipped (cold EMAs are noise).
    """
    sigma_delta: Dict[str, float] = {}
    tv: Dict[str, float] = {}
    amax_delta: Dict[str, float] = {}
    tripped = []

    for site in recorder.sites:
        if recorder.calls(site) < min_calls:
            continue
        observed = recorder.pmf(site).std
        planned = table.sigma(site)
        if planned is not None and planned > 0.0:
            rel = abs(observed - planned) / planned
            sigma_delta[site] = rel
            if rel > sigma_rtol:
                tripped.append(site)
        if baseline is not None and site in baseline:
            d = tv_distance(recorder.pmf(site), baseline[site])
            tv[site] = d
            if d > tv_threshold and site not in tripped:
                tripped.append(site)

    for site, observed in sorted(recorder._amax.items()):
        planned = table.sigma(f"{site}.amax")
        if planned is not None and planned > 0.0:
            rel = abs(observed - planned) / planned
            amax_delta[f"{site}.amax"] = rel
            if rel > amax_rtol and site not in tripped:
                tripped.append(site)

    return DriftReport(drifted=bool(tripped), drifted_sites=tuple(tripped),
                       sigma_delta=sigma_delta, tv=tv,
                       amax_delta=amax_delta)


class StreamingCalibrator:
    """Glue: recorder + gate + drift detector + versioned refresh.

    Owns the :class:`StreamingRecorder` an engine (or a replica fleet)
    feeds through its gated shadow passes, remembers which table the
    statistics are being compared against, and on :meth:`maybe_refresh`
    turns a drift verdict into ``table.refreshed(streaming sigmas)``
    handed to ``apply_fn``. After a refresh, the baseline PMF snapshot
    resets to the PMFs that justified the new table, so the next drift
    check measures movement *since the swap*, not since launch.
    """

    def __init__(self, table: CalibrationTable, *,
                 recorder: Optional[StreamingRecorder] = None,
                 seed: int = 0, sample_period: int = 4,
                 sigma_rtol: float = 0.10, tv_threshold: float = 0.05,
                 amax_rtol: float = 0.25, min_calls: int = 1):
        self.recorder = recorder if recorder is not None \
            else StreamingRecorder()
        self.table = table
        self.seed = int(seed)
        self.sample_period = int(sample_period)
        self.sigma_rtol = float(sigma_rtol)
        self.tv_threshold = float(tv_threshold)
        self.amax_rtol = float(amax_rtol)
        self.min_calls = int(min_calls)
        self._baseline: Dict[str, Pmf] = {}
        self.refreshes = 0

    def should_sample(self, index: int) -> bool:
        """Gate one unit of traffic (group index / admission counter)."""
        return sample_gate(self.seed, index, self.sample_period)

    def check(self) -> DriftReport:
        return detect_drift(self.recorder, self.table,
                            baseline=self._baseline or None,
                            sigma_rtol=self.sigma_rtol,
                            tv_threshold=self.tv_threshold,
                            amax_rtol=self.amax_rtol,
                            min_calls=self.min_calls)

    def maybe_refresh(
            self, apply_fn: Callable[[CalibrationTable], object],
    ) -> Optional[DriftReport]:
        """Refresh the installed table if the statistics drifted.

        Returns the :class:`DriftReport` when a refresh happened (the
        report that justified it), ``None`` otherwise. ``apply_fn``
        receives the *refreshed* table — streaming sigmas overlaid on
        the installed ones, version bumped — and is responsible for the
        hot swap (``ServeEngine.apply_calibration``).
        """
        report = self.check()
        if not report:
            return None
        new = self.table.refreshed(self.recorder.table().to_pairs())
        apply_fn(new)
        self.table = new
        with self.recorder._lock:
            self._baseline = {s: Pmf(_LIMB_LO,
                                     np.array(self.recorder._counts[s]
                                              / self.recorder._counts[s].sum()))
                              for s in self.recorder._counts}
        self.refreshes += 1
        return report
