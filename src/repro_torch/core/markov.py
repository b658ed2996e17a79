"""Random-walk / absorbing-Markov-chain overflow analysis — paper §4.

The port's copy of ``repro.core.markov`` (pure numpy, the same names and
the same numbers). Models the running partial sum of a dot product as a
random walk over accumulator states with a single absorbing overflow
state. Provides:

* the CLT approximation of overflow probability (§4.1, Fig. 4a),
* the fundamental-matrix expected-sums-before-overflow (§4.2, Fig. 5),
* chunk-length planners that turn the analysis into *kernel tuning knobs*
  (the dMAC's greedy data-dependent fallback becomes a deterministic flush
  period of the exact kernels, chosen so overflow within a chunk is
  negligible or impossible).

Everything here is host-side analysis: it runs once per (call site,
calibration table) to configure the kernels' runtime flush period, and to
produce the paper's analysis figures.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

__all__ = [
    "clt_overflow_prob",
    "empirical_pmf",
    "product_pmf",
    "gaussian_quantized_pmf",
    "transition_matrix",
    "expected_sums_before_overflow",
    "absorption_prob_after_k",
    "plan_chunk_length_clt",
    "plan_chunk_length_worst_case",
    "plan_flush_period",
    "limb_sigma_default",
    "simulate_walk",
]


def _phi(z):
    """Standard normal CDF (vectorized, no scipy dependency)."""
    z = np.asarray(z, dtype=np.float64)
    return 0.5 * (1.0 + np.vectorize(math.erf)(z / math.sqrt(2.0)))


def _phi_inv(p: float) -> float:
    """Inverse normal CDF via Acklam's rational approximation (|err|<1e-9)."""
    if not 0.0 < p < 1.0:
        raise ValueError("p must be in (0, 1)")
    a = [-3.969683028665376e+01, 2.209460984245205e+02,
         -2.759285104469687e+02, 1.383577518672690e+02,
         -3.066479806614716e+01, 2.506628277459239e+00]
    b = [-5.447609879822406e+01, 1.615858368580409e+02,
         -1.556989798598866e+02, 6.680131188771972e+01,
         -1.328068155288572e+01]
    c = [-7.784894002430293e-03, -3.223964580411365e-01,
         -2.400758277161838e+00, -2.549732539343734e+00,
         4.374664141464968e+00, 2.938163982698783e+00]
    d = [7.784695709041462e-03, 3.224671290700398e-01,
         2.445134137142996e+00, 3.754408661907416e+00]
    plow, phigh = 0.02425, 1 - 0.02425
    if p < plow:
        q = math.sqrt(-2 * math.log(p))
        return (((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q
                + c[5]) / ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1)
    if p > phigh:
        return -_phi_inv(1 - p)
    q = p - 0.5
    r = q * q
    return (((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r
            + a[5]) * q / (((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r
                            + b[4]) * r + 1)


def clt_overflow_prob(k, acc_bits: int, sigma_p: float):
    """Pr(|Z| > 2**(a-1)) ≈ 2·Φ(−2**(a−1) / (σ_p √k))  (paper §4.1).

    ``sigma_p`` is the partial-product std (= σ_w σ_x for independent
    zero-mean operands).
    """
    k = np.asarray(k, dtype=np.float64)
    bound = 2.0 ** (acc_bits - 1)
    return 2.0 * _phi(-bound / (sigma_p * np.sqrt(np.maximum(k, 1e-12))))


# ---------------------------------------------------------------------------
# PMFs over partial-product values
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Pmf:
    """Discrete pmf over integer support [lo, hi]."""

    lo: int
    probs: np.ndarray  # probs[i] = P(v = lo + i)

    @property
    def hi(self) -> int:
        return self.lo + len(self.probs) - 1

    @property
    def support(self) -> np.ndarray:
        return np.arange(self.lo, self.hi + 1)

    @property
    def mean(self) -> float:
        return float(np.dot(self.support, self.probs))

    @property
    def std(self) -> float:
        m = self.mean
        return float(np.sqrt(np.dot((self.support - m) ** 2, self.probs)))

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        return rng.choice(self.support, size=n, p=self.probs)


def empirical_pmf(values: np.ndarray) -> Pmf:
    """Pmf from observed integer values (e.g. traced partial products)."""
    values = np.asarray(values).astype(np.int64).ravel()
    lo, hi = int(values.min()), int(values.max())
    counts = np.bincount(values - lo, minlength=hi - lo + 1).astype(np.float64)
    return Pmf(lo, counts / counts.sum())


def gaussian_quantized_pmf(bits: int, sigma_frac: float = 1.0 / 3.0,
                           half: bool = False) -> Pmf:
    """Pmf of a b-bit quantized (half-)normal (paper's Fig. 4/5 setup).

    σ is ``sigma_frac`` of the max magnitude (the paper sets extreme values
    3σ from the mean: σ_w = 15/3 for 5-bit weights). ``half=True`` models
    post-ReLU activations (half-normal, support [0, 2**(b-1)-1]... the
    paper uses [0, 127] for 7-bit activations).
    """
    hi = 2 ** (bits - 1) - 1
    lo = 0 if half else -hi
    support = np.arange(lo, hi + 1, dtype=np.float64)
    sigma = sigma_frac * hi
    if half:
        dens = np.exp(-0.5 * (support / sigma) ** 2)
    else:
        dens = np.exp(-0.5 * (support / sigma) ** 2)
    return Pmf(lo, dens / dens.sum())


def product_pmf(pw: Pmf, px: Pmf, max_abs: int | None = None) -> Pmf:
    """Pmf of the product of two independent integer variables."""
    prods = {}
    for w, pwv in zip(pw.support, pw.probs):
        if pwv == 0:
            continue
        for x, pxv in zip(px.support, px.probs):
            if pxv == 0:
                continue
            v = int(w) * int(x)
            prods[v] = prods.get(v, 0.0) + pwv * pxv
    lo = min(prods)
    hi = max(prods)
    probs = np.zeros(hi - lo + 1)
    for v, p in prods.items():
        probs[v - lo] = p
    pmf = Pmf(lo, probs)
    if max_abs is not None:
        # clip tail mass into the extremes (saturated products)
        sup = pmf.support
        clipped = np.clip(sup, -max_abs, max_abs)
        out = np.zeros(2 * max_abs + 1)
        for v, p in zip(clipped, pmf.probs):
            out[v + max_abs] += p
        pmf = Pmf(-max_abs, out)
    return pmf


# ---------------------------------------------------------------------------
# Absorbing chain
# ---------------------------------------------------------------------------


def transition_matrix(pmf: Pmf, acc_bits: int):
    """Q (transient-to-transient) and r (transient-to-absorbing) blocks.

    States are accumulator values in [-2**(a-1), 2**(a-1)-1]; any step
    leaving the range is absorbed (overflow). Row-stochastic:
    Q[i, :].sum() + r[i] == 1.
    """
    lo = -(1 << (acc_bits - 1))
    hi = (1 << (acc_bits - 1)) - 1
    n = hi - lo + 1
    if n > 1 << 14:
        raise ValueError(
            f"{acc_bits}-bit accumulator -> {n} states; use the CLT model "
            "beyond 14 bits")
    states = np.arange(lo, hi + 1)
    # Q[i, j] = P(v = states[j] - states[i]); vectorized via index shifts.
    Q = np.zeros((n, n))
    for v, p in zip(pmf.support, pmf.probs):
        if p == 0:
            continue
        src = states
        dst = src + int(v)
        ok = (dst >= lo) & (dst <= hi)
        Q[np.arange(n)[ok], (dst - lo)[ok]] += p
    r = 1.0 - Q.sum(axis=1)
    return Q, r


def expected_sums_before_overflow(pmf: Pmf, acc_bits: int,
                                  start: int = 0) -> float:
    """Expected number of adds before absorption, from state ``start``.

    Row-sum of the fundamental matrix N = (I − Q)⁻¹ at the start state —
    solved as a single linear system (I − Q) t = 1 (paper §4.2).
    """
    Q, _ = transition_matrix(pmf, acc_bits)
    n = Q.shape[0]
    t = np.linalg.solve(np.eye(n) - Q, np.ones(n))
    lo = -(1 << (acc_bits - 1))
    return float(t[start - lo])


def absorption_prob_after_k(pmf: Pmf, acc_bits: int, k: int,
                            start: int = 0) -> float:
    """P(overflow within k adds) — exact chain power (Fig. 4a analogue)."""
    Q, _ = transition_matrix(pmf, acc_bits)
    lo = -(1 << (acc_bits - 1))
    v = np.zeros(Q.shape[0])
    v[start - lo] = 1.0
    for _ in range(k):
        v = v @ Q
    return float(1.0 - v.sum())


# ---------------------------------------------------------------------------
# Kernel planners
# ---------------------------------------------------------------------------


def plan_chunk_length_clt(acc_bits: int, sigma_p: float,
                          target_overflow: float = 1e-4) -> int:
    """Largest chunk k with CLT overflow probability <= target.

    Inverts 2Φ(−2^{a−1}/(σ_p√k)) <= ε:  k <= (2^{a−1} / (σ_p z))², with
    z = Φ⁻¹(1 − ε/2). Used to pick the greedy flush period of the chunked
    MGS kernels.
    """
    z = _phi_inv(1.0 - target_overflow / 2.0)
    k = (2.0 ** (acc_bits - 1) / (sigma_p * z)) ** 2
    return max(1, int(math.floor(k)))


def plan_chunk_length_worst_case(max_abs_term: int, acc_bits: int) -> int:
    """Deterministic no-overflow bound: k <= (2^{a−1} − 1) / max|term|.

    Used for the int32 limb accumulators of the exact kernels
    (max|term| = 64·64 for balanced 7-bit limbs → k ≤ 2**19 − 1 per flush).
    """
    return max(1, ((1 << (acc_bits - 1)) - 1) // max(1, max_abs_term))


def limb_sigma_default(limb_base: int = 7) -> float:
    """Std of a balanced base-2**b limb under the uniform assumption.

    Balanced limbs of absmax-scaled operands are close to uniform over
    [-2**(b-1), 2**(b-1) - 1]; this is the planner's stand-in when no
    observed statistics are available (σ = sqrt((4**b − 1) / 12) ≈ 36.9
    for the 7-bit limbs of the exact kernel).
    """
    n = 1 << limb_base
    return math.sqrt((n * n - 1) / 12.0)


def plan_flush_period(block_k: int, *, target_overflow: float | None = None,
                      sigma_limb_x: float | None = None,
                      sigma_limb_w: float | None = None, acc_bits: int = 32,
                      limb_base: int = 7, n_limbs: int = 3) -> int:
    """Markov-informed flush period for the exact kernel's class accums.

    One grid K-step adds ``block_k * n_limbs`` limb products into the
    busiest weight-class int32 register. The worst-case (deterministic,
    overflow-impossible) period divides the register range by the maximum
    per-step magnitude; with observed limb statistics the per-step sum is
    a random walk of std ``sqrt(n_limbs * block_k) * σ_x σ_w``, and the
    CLT bound (§4.1) licenses a much longer period at a negligible
    overflow probability — fewer narrow→wide f32 combines per output tile
    (the §5.2 amortization, extended from *alignment* work to *flush*
    work).

    ``target_overflow=None`` returns the worst-case bound (the safety
    fallback). Otherwise the result is never shorter than the worst-case
    bound, and whenever it exceeds it, the overflow probability of a
    period-length chunk is <= ``target_overflow``: the register wraps if
    any *prefix* of the chunk leaves the int32 range, so the CLT endpoint
    bound is planned at ``target/2`` (reflection principle:
    P(max prefix > B) <= 2 P(endpoint > B) for a symmetric walk). Pass
    measured limb stds (e.g. ``PreparedWeight.limb_sigma``) to tighten
    the plan; defaults assume uniform limbs (:func:`limb_sigma_default`)
    and independence across the class's limb pairs — correlated operand
    limbs can push the realized per-chunk probability toward the target's
    order of magnitude, not materially past it.

    Args:
      block_k: K elements accumulated per grid step (the kernel's block_k
        tile size).
      target_overflow: per-chunk overflow probability budget in (0, 1),
        or ``None`` for the deterministic worst-case bound.
      sigma_limb_x / sigma_limb_w: observed activation / weight limb
        standard deviations; default :func:`limb_sigma_default`.
      acc_bits: accumulator register width (int32 class registers).
      limb_base / n_limbs: limb radix (2**limb_base) and count, matching
        the kernel's balanced 3x7-bit scheme.

    Returns:
      The flush period in K-steps (a python int >= 1): the exact kernels'
      runtime argument.
    """
    per_step_max = block_k * n_limbs * (1 << (limb_base - 1)) ** 2
    worst = plan_chunk_length_worst_case(per_step_max, acc_bits)
    if target_overflow is None:
        return worst
    if not 0.0 < target_overflow < 1.0:
        raise ValueError(f"target_overflow must be in (0, 1), got "
                         f"{target_overflow}")
    sx = limb_sigma_default(limb_base) if sigma_limb_x is None else float(
        sigma_limb_x)
    sw = limb_sigma_default(limb_base) if sigma_limb_w is None else float(
        sigma_limb_w)
    sigma_step = math.sqrt(n_limbs * block_k) * max(sx * sw, 1e-12)
    clt = plan_chunk_length_clt(acc_bits, sigma_step, target_overflow / 2.0)
    return max(worst, clt)


def simulate_walk(pmf: Pmf, acc_bits: int, n_trials: int = 4096,
                  max_steps: int = 100000, seed: int = 0) -> np.ndarray:
    """Monte-Carlo sums-before-overflow (validates the chain model)."""
    rng = np.random.default_rng(seed)
    lo = -(1 << (acc_bits - 1))
    hi = (1 << (acc_bits - 1)) - 1
    lengths = np.zeros(n_trials, dtype=np.int64)
    for i in range(n_trials):
        acc = 0
        steps = 0
        while steps < max_steps:
            acc += int(pmf.sample(rng, 1)[0])
            if acc < lo or acc > hi:
                break
            steps += 1
        lengths[i] = steps
    return lengths
