"""The H100 roofline of a step, and the bounds of the port's kernels: the
port's counterpart of ``repro.launch.roofline``.

Three roofline terms per (arch x shape x mesh), as the reference derives
them:

    compute    = FLOPs per device / peak FLOP/s per card
    memory     = bytes per device / HBM bandwidth
    collective = collective traffic per device / NVLink bandwidth

The reference reads its FLOPs, bytes and collectives from compiled HLO.
The port has no HLO: its counts come from the dry run's closed forms
(:mod:`repro_torch.launch.dryrun`) or from a recorded step
(:mod:`repro_torch.launch.step_cost`), and its collectives from the
``(op, payload bytes, group size)`` that ``parallel.comm.RankMesh`` counts.
The traffic a collective puts on a device is the reference's ring model
over its result:

    all-reduce      2 (g-1)/g x result bytes
    all-gather        (g-1)/g x result bytes   (result: g x the payload)
    reduce-scatter    (g-1)/g x max(operand, result) bytes
    all-to-all        (g-1)/g x result bytes
    collective-permute          result bytes

Below the step's terms sit the bounds of the hand-written kernels (B1-B5):
the larger of the bytes a call must move (each input read once, each
output written once) over the HBM rate and its operations over the rate
of their unit. ``chip_smoke.py`` reports each kernel's time beside them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = ["Hardware", "H100_SXM", "CollectiveStats", "collective_traffic",
           "RING_FACTORS", "RooflineReport", "analyze", "model_flops",
           "bound", "kernel_work", "kernel_bound", "b1_bound",
           "b1_partials_bound", "b1_flush_bound", "b2_bound", "b4_bound",
           "dmac_bound", "b4_partials_bound", "dmac_partials_bound",
           "dmac_combine_bound", "DMAC_OPS_PER_PRODUCT"]


@dataclasses.dataclass(frozen=True)
class Hardware:
    name: str
    peak_flops: float        # per card, bf16 dense tensor-core FLOP/s
    int8_ops: float          # per card, int8 dense tensor-core op/s
    int32_ops: float         # per card, CUDA-core int32 op/s
    fp32_flops: float        # per card, CUDA-core float32 FLOP/s
    hbm_bw: float            # bytes/s per card
    link_bw: float           # NVLink bytes/s per card, one direction
    hbm_bytes: float         # capacity per card

    @property
    def ici_bw(self) -> float:
        """The link rate under the reference's name (its TPU's ICI)."""
        return self.link_bw


#: One NVIDIA H100 SXM5 (NVIDIA's H100 data sheet, dense rates without
#: sparsity, at the full 700 W power limit): 989 TFLOP/s bf16 and 1,979
#: TOP/s int8 on the tensor cores; the CUDA-core int32 rate is 132 SMs x 64
#: int32 lanes x the 1.98 GHz boost clock; 67 TFLOP/s float32 outside the
#: tensor cores (128 lanes x 2 at that clock); HBM3 at 3.35 TB/s;
#: fourth-generation NVLink, 18 links of 25 GB/s each way (900 GB/s both
#: ways); the capacity is ``torch.cuda.get_device_properties(0)
#: .total_memory`` of an "NVIDIA H100 80GB HBM3" card at 700.00 W
#: (``chip_smoke.py`` phase 16 prints it).
H100_SXM = Hardware(name="nvidia_h100_sxm", peak_flops=989e12,
                    int8_ops=1979e12, int32_ops=132 * 64 * 1.98e9,
                    fp32_flops=67e12,
                    hbm_bw=3.35e12, link_bw=450e9,
                    hbm_bytes=85017493504)

#: traffic factors of the ring model, applied to (g-1)/g x result bytes
RING_FACTORS = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
                "all-to-all": 1.0, "collective-permute": 1.0}

# ``RankMesh``'s counted kinds -> the reference's HLO op (a barrier moves
# nothing)
_KIND_OP = {"all_reduce_sum": "all-reduce", "all_reduce_max": "all-reduce",
            "agree": "all-reduce", "all_gather": "all-gather"}


@dataclasses.dataclass
class CollectiveStats:
    bytes_per_device: float
    per_op: Dict[str, float]
    counts: Dict[str, int]
    ops: List[Dict]

    def to_json(self):
        return {"bytes_per_device": self.bytes_per_device,
                "per_op": self.per_op, "counts": self.counts}


def collective_traffic(ops: Iterable[Tuple[str, float, int]]
                       ) -> CollectiveStats:
    """Ring-model traffic per device of ``(kind, payload bytes, group
    size)`` records as ``RankMesh`` counts them (kinds ``all_reduce_sum``,
    ``all_reduce_max``, ``agree``, ``all_gather``, ``barrier``; the
    payload is what this rank sends in). An all-gather's result is the
    group's payloads together."""
    per_op: Dict[str, float] = {}
    counts: Dict[str, int] = {}
    out: List[Dict] = []
    for kind, nbytes, g in ops:
        op = _KIND_OP.get(kind)
        if op is None:
            continue
        g = int(g)
        rbytes = nbytes * g if op == "all-gather" else nbytes
        eff = (g - 1) / g if g > 1 else 0.0
        traffic = RING_FACTORS[op] * eff * rbytes
        per_op[op] = per_op.get(op, 0.0) + traffic
        counts[op] = counts.get(op, 0) + 1
        out.append({"op": op, "bytes": rbytes, "group": g,
                    "traffic": traffic})
    return CollectiveStats(bytes_per_device=sum(per_op.values()),
                           per_op=per_op, counts=counts, ops=out)


def model_flops(n_params: int, n_active_params: int, tokens: int,
                kind: str) -> float:
    """Analytic 'useful' FLOPs: 6·N·D training, 2·N·D forward-only."""
    n = n_active_params
    return (6.0 if kind == "train" else 2.0) * n * tokens


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    n_devices: int
    hlo_flops_per_device: float
    hlo_bytes_per_device: float
    collective_bytes_per_device: float
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    model_flops: float
    useful_flops_ratio: float
    peak_fraction: float
    memory_per_device: Dict[str, float]
    collectives: Dict

    def to_json(self):
        return dataclasses.asdict(self)

    @property
    def step_time_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)


def analyze(*, arch: str, shape: str, mesh_name: str, n_devices: int,
            cost: Dict, mem: Dict, mflops: float, collective_bytes: float,
            collective_per_op: Optional[Dict[str, float]] = None,
            hw: Hardware = H100_SXM) -> RooflineReport:
    """The reference's report from per-device ``cost`` (``"flops"``,
    ``"bytes accessed"``), memory and collective traffic. Field names keep
    the reference's ``hlo_`` prefix; the port's counts are the dry run's
    or a recorded step's."""
    flops = float(cost.get("flops", 0.0))
    bytes_acc = float(cost.get("bytes accessed", 0.0))
    t_comp = flops / hw.peak_flops
    t_mem = bytes_acc / hw.hbm_bw
    t_coll = collective_bytes / hw.ici_bw
    terms = {"compute": t_comp, "memory": t_mem, "collective": t_coll}
    bottleneck = max(terms, key=terms.get)
    total_flops = flops * n_devices
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, n_devices=n_devices,
        hlo_flops_per_device=flops, hlo_bytes_per_device=bytes_acc,
        collective_bytes_per_device=collective_bytes,
        t_compute=t_comp, t_memory=t_mem, t_collective=t_coll,
        bottleneck=bottleneck, model_flops=mflops,
        useful_flops_ratio=(mflops / total_flops if total_flops else 0.0),
        peak_fraction=(t_comp / max(t_comp, t_mem, t_coll)
                       if max(t_comp, t_mem, t_coll) > 0 else 0.0),
        memory_per_device=mem,
        collectives={"bytes_per_device": collective_bytes,
                     "per_op": collective_per_op or {}})


# ---------------------------------------------------------------------------
# the kernels' bounds (ms, and what binds: "bytes" or "operations")
# ---------------------------------------------------------------------------

#: operations per product of the dMAC's minimal form (B5): the product
#: (its mantissas multiplied, exponents added), one table lookup of the
#: rounded (sm, e), one add into bin e
DMAC_OPS_PER_PRODUCT = 4


def bound(nbytes: float, ops: float, rate: Optional[float] = None,
          hw: Hardware = H100_SXM) -> Tuple[float, str]:
    """``(ms, "bytes" | "operations")``: the larger of ``nbytes`` over the
    HBM rate and ``ops`` over ``rate`` (default: the int8 tensor cores)."""
    t_mem = nbytes / hw.hbm_bw * 1e3
    t_ops = ops / (hw.int8_ops if rate is None else rate) * 1e3
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")


def kernel_work(entry: str, shape: Sequence[int], *, segments: int = 1,
                scale_rows: int = 1, scale_elems: int = 1,
                hw: Hardware = H100_SXM) -> Tuple[float, float, float]:
    """``(bytes, operations, operations/s)`` of one launch of ``LAUNCHES``
    entry ``entry`` at ``shape``: ``(Bt, M, K, N)``; B2 ``(N slices, T
    rows, D, live keys, table entries)``.

    * B1 / B3 (``exact_fused[_stationary]``): a byte per code in, float32
      out and a scale per slice; 9 int8 limb products per multiply-add.
    * their partials entries over a cut of K: the cut's codes in, the
      ``segments x 5`` int32 class planes out; the same products.
    * the flush: the class planes in, float32 out, and ``scale_elems``
      float32 scale and bias elements, counted as stored (a broadcast dim
      once); one multiply-add a class a segment, at the float32 rate.
    * B4 (``exact``): 3 limb bytes an operand element, float32 out.
    * B4's partials entry over a cut of K: the cut's limb bytes in (3 an
      operand element), the ``segments x 5`` int32 class planes out; the
      same products.
    * B5 (``dmac``): codes in, float32 out; the minimal form's
      ``DMAC_OPS_PER_PRODUCT`` operations a product at the CUDA-core int32
      rate.
    * its partials entry over a cut of K: the cut's codes in, the
      ``segments`` int32 bins of every output out (``segments``: the
      format's bins); the same operations over the cut.
    * its combine entry: the bins in, float32 out, and ``scale_elems``
      scale and bias elements as the flush; a multiply and an add a bin,
      at the float32 rate (the bytes bind: 16 bins are 64 bytes an
      output).
    * B2 (``flash_attention``): query codes, K and V codes, the scale and
      bias rows of every key (``scale_rows`` a slice: 1, or ``T`` at the
      verify entry), float32 out, the block table and live counts; 9 limb
      products per multiply-add of the two contractions.
    """
    if entry == "mgs_flash_attention":
        N, T, D, keys, table = shape[:5]
        return (N * T * D + 2 * keys * D + 3 * scale_rows * keys * 4
                + N * T * D * 4 + table * 4 + N * 4,
                2 * 9 * 2 * T * D * keys, hw.int8_ops)
    Bt, M, K, N = shape
    if entry in ("mgs_matmul_exact_fused",
                 "mgs_matmul_exact_fused_stationary"):
        return (Bt * M * K + Bt * K * N + Bt * M * N * 4 + Bt * 4,
                9 * 2 * Bt * M * N * K, hw.int8_ops)
    if entry in ("mgs_matmul_exact_partials",
                 "mgs_matmul_stationary_partials"):
        return (Bt * M * K + Bt * K * N + segments * 5 * Bt * M * N * 4,
                9 * 2 * Bt * M * N * K, hw.int8_ops)
    if entry == "mgs_matmul_exact_flush":
        return (segments * 5 * Bt * M * N * 4 + Bt * M * N * 4
                + 4 * scale_elems,
                5 * segments * 2 * Bt * M * N, hw.fp32_flops)
    if entry == "mgs_matmul_exact":
        return (3 * Bt * (M * K + K * N) + 4 * Bt * M * N,
                9 * 2 * Bt * M * N * K, hw.int8_ops)
    if entry == "mgs_matmul_exact_limb_partials":
        return (3 * Bt * (M * K + K * N) + segments * 5 * Bt * M * N * 4,
                9 * 2 * Bt * M * N * K, hw.int8_ops)
    if entry == "mgs_matmul_dmac_partials":
        return (Bt * (M * K + K * N + segments * 4 * M * N),
                Bt * M * N * K * DMAC_OPS_PER_PRODUCT, hw.int32_ops)
    if entry == "mgs_matmul_dmac_combine":
        return (Bt * M * N * (segments * 4 + 4) + 4 * scale_elems,
                2 * segments * Bt * M * N, hw.fp32_flops)
    if entry == "mgs_matmul_dmac":
        return (Bt * (M * K + K * N + 4 * M * N),
                Bt * M * N * K * DMAC_OPS_PER_PRODUCT, hw.int32_ops)
    raise ValueError(f"unknown kernel entry {entry!r}")


def kernel_bound(entry: str, shape: Sequence[int], *, segments: int = 1,
                 scale_rows: int = 1, scale_elems: int = 1,
                 hw: Hardware = H100_SXM) -> Tuple[float, str]:
    """The bound of one launch (:func:`kernel_work`)."""
    nbytes, ops, rate = kernel_work(entry, shape, segments=segments,
                                    scale_rows=scale_rows,
                                    scale_elems=scale_elems, hw=hw)
    return bound(nbytes, ops, rate, hw=hw)


def b1_bound(Bt, M, K, N, hw: Hardware = H100_SXM):
    """B1's and B3's bound."""
    return kernel_bound("mgs_matmul_exact_fused", (Bt, M, K, N), hw=hw)


def b1_partials_bound(Bt, M, K, N, segments: int, hw: Hardware = H100_SXM):
    """B1's (or B3's) partials entry over a cut of ``K``."""
    return kernel_bound("mgs_matmul_exact_partials", (Bt, M, K, N),
                        segments=segments, hw=hw)


def b1_flush_bound(Bt, M, N, segments: int, scale_elems: int = 1,
                   hw: Hardware = H100_SXM):
    """B1's flush entry over ``segments`` segments of class planes."""
    return kernel_bound("mgs_matmul_exact_flush", (Bt, M, 0, N),
                        segments=segments, scale_elems=scale_elems, hw=hw)


def b2_bound(N, T, D, keys, table_entries, scale_rows: int = 1,
             hw: Hardware = H100_SXM):
    """B2's bound over ``keys`` live keys (counted whole blocks)."""
    return kernel_bound("mgs_flash_attention", (N, T, D, keys, table_entries),
                        scale_rows=scale_rows, hw=hw)


def b4_bound(Bt, M, K, N, hw: Hardware = H100_SXM):
    """B4's bound."""
    return kernel_bound("mgs_matmul_exact", (Bt, M, K, N), hw=hw)


def dmac_bound(Bt, M, K, N, hw: Hardware = H100_SXM):
    """B5's bound."""
    return kernel_bound("mgs_matmul_dmac", (Bt, M, K, N), hw=hw)


def b4_partials_bound(Bt, M, K, N, segments: int,
                      hw: Hardware = H100_SXM):
    """B4's partials entry over a cut of ``K``."""
    return kernel_bound("mgs_matmul_exact_limb_partials", (Bt, M, K, N),
                        segments=segments, hw=hw)


def dmac_partials_bound(Bt, M, K, N, n_bins: int, hw: Hardware = H100_SXM):
    """B5's partials entry over a cut of ``K`` (``n_bins`` a output)."""
    return kernel_bound("mgs_matmul_dmac_partials", (Bt, M, K, N),
                        segments=n_bins, hw=hw)


def dmac_combine_bound(Bt, M, N, n_bins: int, scale_elems: int = 1,
                       hw: Hardware = H100_SXM):
    """B5's combine entry over ``n_bins`` bins an output."""
    return kernel_bound("mgs_matmul_dmac_combine", (Bt, M, 0, N),
                        segments=n_bins, scale_elems=scale_elems, hw=hw)
