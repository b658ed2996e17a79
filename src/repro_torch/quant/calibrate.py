"""Calibration: one-pass activation statistics for flush planning and the
static decode-query scale (``repro.quant.calibrate``).

The Markov flush planner (:func:`repro_torch.core.markov.plan_flush_period`)
models the exact kernels' per-class int32 accumulation as a random walk
whose step std is ``sqrt(n_limbs * block_k) * sigma_x * sigma_w``. Weights
contribute an observed ``sigma_w`` (``PreparedWeight.limb_sigma``, measured
at preparation); activations contribute the per-call-site sigma measured
here:

1. Run any forward pass under :func:`calibrating`. Every site-tagged
   ``qeinsum`` / ``qmatmul`` call then records the balanced-limb histogram
   of its quantized activation operand (:func:`observe`): the limbs are
   decomposed and counted into the 128 levels on the tensor's device, and
   128 counts (one row per slice of a batched call, as the reference's
   ``vmap`` records per slice) cross to the host. The decode query records
   its absmax (:func:`observe_amax`).
2. :meth:`ActivationRecorder.table` reduces each site's PMF to a sigma and
   emits the query absmax as ``"attn.q.amax"``.
3. The :class:`CalibrationTable` goes on the ``QuantConfig``
   (``with_calibration``), onto each ``PreparedWeight`` (``act_sigma``),
   and, through the serving engines, into the runtime state that
   :func:`applied_calib_state` hands the model: per-site flush periods
   (runtime arguments of the exact kernels) and the static decode-query
   amax.

Outside a :func:`calibrating` context :func:`observe` and
:func:`observe_amax` launch nothing and synchronize nothing.
"""

from __future__ import annotations

import contextlib
import hashlib
import threading
from typing import Any, Dict, Iterable, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.markov import Pmf, limb_sigma_default, plan_flush_period

__all__ = ["ActivationRecorder", "CalibrationTable", "applied_calib_state",
           "calibrating", "current_calib_state", "current_recorder",
           "observe", "observe_amax"]

# Balanced base-128 limbs of the exact kernels take values in [-64, 63].
_LIMB_LO = -64
_N_LEVELS = 128


def _limb_counts(limbs) -> np.ndarray:
    """Histogram of int limb values over the 128 balanced levels."""
    v = np.asarray(limbs).astype(np.int64).ravel()
    if v.min() < _LIMB_LO or v.max() >= _LIMB_LO + _N_LEVELS:
        raise ValueError(f"limb values outside balanced base-128 "
                         f"range [{_LIMB_LO}, {_LIMB_LO + _N_LEVELS}): "
                         f"[{v.min()}, {v.max()}]")
    return np.bincount(v - _LIMB_LO, minlength=_N_LEVELS).astype(np.float64)


class ActivationRecorder:
    """Accumulates per-site limb histograms during a calibration pass."""

    def __init__(self):
        self._counts: Dict[str, np.ndarray] = {}
        self._calls: Dict[str, int] = {}
        self._amax: Dict[str, float] = {}
        self._lock = threading.Lock()

    def record(self, site: str, limbs):
        """Fold one call's observed limb values into the site PMF."""
        self.record_counts(site, _limb_counts(limbs))

    def record_counts(self, site: str, counts: np.ndarray):
        """Fold one call's 128-level limb histogram into the site PMF."""
        counts = np.asarray(counts, np.float64)
        with self._lock:
            if site in self._counts:
                self._counts[site] += counts
                self._calls[site] += 1
            else:
                self._counts[site] = counts.copy()
                self._calls[site] = 1

    @property
    def sites(self) -> Tuple[str, ...]:
        return tuple(sorted(self._counts))

    def calls(self, site: str) -> int:
        return self._calls.get(site, 0)

    def pmf(self, site: str) -> Pmf:
        """The site's aggregated limb PMF over all recorded calls, on the
        full balanced-limb support."""
        counts = self._counts[site]
        return Pmf(_LIMB_LO, counts / counts.sum())

    def record_amax(self, site: str, value: float):
        """Fold one call's activation absmax into the site max (emitted as
        ``"<site>.amax"``, the static decode-query scale's entry)."""
        v = float(value)
        with self._lock:
            self._amax[site] = max(self._amax.get(site, 0.0), v)

    def amax(self, site: str) -> Optional[float]:
        return self._amax.get(site)

    def table(self) -> "CalibrationTable":
        sigmas = {s: self.pmf(s).std for s in self._counts}
        sigmas.update({f"{s}.amax": v for s, v in self._amax.items()})
        return CalibrationTable(sigmas)


class CalibrationTable:
    """Immutable site -> observed activation limb sigma mapping, versioned.

    ``version`` is a monotone id assigned by whoever installs the table
    (the engines bump it on every swap; standalone tables default to 0);
    ``content_hash`` fingerprints the sigmas independently of the version:
    two tables with equal hashes plan identical flush periods and static
    scales, so a swap between them is bit-inert. The version is host-side
    bookkeeping only.
    """

    def __init__(self, sigmas: Union[Mapping[str, float],
                                     Iterable[Tuple[str, float]]],
                 *, version: int = 0):
        items = (sigmas.items() if isinstance(sigmas, Mapping) else sigmas)
        self._sigmas = {str(k): float(v) for k, v in items}
        self.version = int(version)

    @property
    def content_hash(self) -> str:
        """sha256 over the sorted (site, sigma) pairs — version-free."""
        h = hashlib.sha256()
        for k, v in sorted(self._sigmas.items()):
            h.update(f"{k}={v!r};".encode())
        return h.hexdigest()

    def refreshed(self, updates: Union[Mapping[str, float],
                                       Iterable[Tuple[str, float]]],
                  *, version: Optional[int] = None) -> "CalibrationTable":
        """New table = this table's sigmas overlaid with ``updates``
        (unobserved sites keep their values); ``version`` defaults to
        ``self.version + 1``."""
        items = (updates.items() if isinstance(updates, Mapping)
                 else updates)
        merged = dict(self._sigmas)
        merged.update({str(k): float(v) for k, v in items})
        v = self.version + 1 if version is None else int(version)
        return CalibrationTable(merged, version=v)

    def sigma(self, site: Optional[str],
              default: Optional[float] = None) -> Optional[float]:
        if site is None:
            return default
        return self._sigmas.get(site, default)

    def to_pairs(self) -> Tuple[Tuple[str, float], ...]:
        return tuple(sorted(self._sigmas.items()))

    @classmethod
    def from_pairs(cls, pairs, *, version: int = 0) -> "CalibrationTable":
        return cls(dict(pairs), version=version)

    def flush_period(self, site: str, block_k: int, *,
                     target_overflow: float,
                     sigma_limb_w: Optional[float] = None) -> int:
        """Site-specific Markov-planned flush period (observed sigma)."""
        return plan_flush_period(block_k, target_overflow=target_overflow,
                                 sigma_limb_x=self.sigma(
                                     site, limb_sigma_default()),
                                 sigma_limb_w=sigma_limb_w)

    def __len__(self):
        return len(self._sigmas)

    def __iter__(self):
        return iter(sorted(self._sigmas.items()))

    def __repr__(self):
        rows = ", ".join(f"{k}={v:.2f}" for k, v in sorted(
            self._sigmas.items()))
        return f"CalibrationTable(v{self.version}: {rows})"


_ctx = threading.local()


def current_recorder() -> Optional[ActivationRecorder]:
    return getattr(_ctx, "recorder", None)


@contextlib.contextmanager
def calibrating(recorder: Optional[ActivationRecorder] = None):
    """Context under which site-tagged matmuls record activation limbs
    (thread-local). Yields the recorder (a new one by default)."""
    rec = recorder if recorder is not None else ActivationRecorder()
    prev = current_recorder()
    _ctx.recorder = rec
    try:
        yield rec
    finally:
        _ctx.recorder = prev


def current_calib_state() -> Optional[Mapping[str, Any]]:
    """The runtime calibration state the engine applied, if any.

    ``{"flush": {site: int}, "q_amax": tensor, "q_amax_min": float,
    "q_amax_max": float, "q_amax_rows": {}}`` (keys present only where
    the config uses them): the flush periods are the exact kernels' runtime
    arguments; the decode-query amax is a device tensor (a scalar, or one
    entry per continuous-engine slot) with its host-known range, so
    ``models.attention._quantize_decode_q`` knows without a sync whether
    any row takes the dynamic reduce, and a cache of its per-row
    expansions. ``None`` when no engine state is active (the static
    ``QuantConfig`` plan applies).
    """
    return getattr(_ctx, "calib_state", None)


@contextlib.contextmanager
def applied_calib_state(state: Optional[Mapping[str, Any]]):
    """Context under which site-tagged matmuls and the decode query read
    ``state`` (thread-local); the engines enter it around each model
    call, so a swap between calls re-plans with nothing rebuilt."""
    prev = current_calib_state()
    _ctx.calib_state = state
    try:
        yield state
    finally:
        _ctx.calib_state = prev


def observe(site: Optional[str], q_values: torch.Tensor, fmt, *,
            batched: bool = False):
    """Record the limb statistics of one quantized activation operand.

    A no-op (nothing launched, nothing synchronized) unless a
    :func:`calibrating` context is active and the call is site-tagged.
    ``q_values`` holds format-exact values; with ``batched`` its leading
    axis indexes slices, each recorded as its own call (the reference
    records per ``vmap`` slice). The limbs are counted on the tensor's
    device; one copy of the counts reaches the host. Values outside the
    balanced range raise.
    """
    rec = current_recorder()
    if rec is None or site is None:
        return
    from repro_torch.kernels.mgs_matmul import limb_decompose
    n = q_values.shape[0] if batched else 1
    limbs = limb_decompose(q_values, fmt)                 # (3, ...) int8
    v = limbs.movedim(0, 1) if batched else limbs[None]
    v = v.reshape(n, -1).to(torch.int64) - _LIMB_LO
    base = torch.arange(n, device=v.device)[:, None] * _N_LEVELS
    # out-of-range values land in one extra bin past every slice's levels
    idx = torch.where((v >= 0) & (v < _N_LEVELS), v + base,
                      torch.full_like(v, n * _N_LEVELS))
    counts = torch.bincount(idx.reshape(-1), minlength=n * _N_LEVELS + 1)
    counts = counts.cpu().numpy()
    if counts[n * _N_LEVELS]:
        raise ValueError(f"{site}: {counts[n * _N_LEVELS]} limb values "
                         f"outside the balanced base-128 range "
                         f"[{_LIMB_LO}, {_LIMB_LO + _N_LEVELS})")
    for row in counts[:n * _N_LEVELS].reshape(n, _N_LEVELS):
        rec.record_counts(site, row)


def observe_amax(site: Optional[str], x: torch.Tensor):
    """Record the absmax of a float activation at ``site`` (one device
    reduce, one ``.item()``); a no-op outside :func:`calibrating`."""
    rec = current_recorder()
    if rec is None or site is None:
        return
    rec.record_amax(site, x.to(torch.float32).abs().amax().item())
