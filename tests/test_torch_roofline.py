"""The port's cell vocabulary and H100 roofline against the reference's
(``repro_torch.configs`` / ``repro_torch.launch.roofline`` against
``repro.configs`` / ``repro.launch.roofline``).

* ``ShapeConfig``, ``SHAPES``, ``MeshConfig`` and ``shape_applicable``
  equal the reference's, entry for entry, for every arch x shape.
* Given the same cost, memory and collectives, ``analyze`` gives the
  reference's report field for field, with ``H100_SXM`` handed to the
  reference through ``hw=``; ``model_flops`` is the reference's.
* The ring traffic of a list of collectives as ``RankMesh`` counts them
  (kind, payload, group size) equals ``parse_collectives`` on HLO lines
  with the same ops.
* Each kernel bound moved out of ``chip_smoke.py`` gives the numbers that
  script computed, at the ``PERF.md`` section 6 shapes (the script's own
  formulas are kept here as the record).
"""

import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro import configs as rc  # noqa: E402
from repro.configs import base as rbase  # noqa: E402
from repro.launch import roofline as rrl  # noqa: E402

from repro_torch import configs as tc  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.launch import roofline as rl  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small ops: one intra-op thread, so that test workers running
    side by side do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_shapes_equal_the_reference():
    assert list(tc.SHAPES) == list(rc.SHAPES)
    for name, s in tc.SHAPES.items():
        r = rc.SHAPES[name]
        assert dataclasses.asdict(s) == dataclasses.asdict(r)
        assert s.is_decode == r.is_decode
    assert ([f.name for f in dataclasses.fields(tbase.ShapeConfig)]
            == [f.name for f in dataclasses.fields(rbase.ShapeConfig)])


@pytest.mark.parametrize("shape,axes", [((16, 16), ("data", "model")),
                                        ((2, 16, 16),
                                         ("pod", "data", "model")),
                                        ((1,), ("data",))])
def test_mesh_config_equals_the_reference(shape, axes):
    t, r = tbase.MeshConfig(shape, axes), rbase.MeshConfig(shape, axes)
    assert dataclasses.asdict(t) == dataclasses.asdict(r)
    assert t.n_devices == r.n_devices == math.prod(shape)


@pytest.mark.parametrize("arch", list(rc.ARCHS))
def test_shape_applicable_equals_the_reference(arch):
    assert list(tc.ARCHS) == list(rc.ARCHS)
    for name in rc.SHAPES:
        assert tc.shape_applicable(tc.get_config(arch), tc.SHAPES[name]) == \
            rc.shape_applicable(rc.get_config(arch), rc.SHAPES[name]), name


COSTS = [  # (flops, bytes accessed, collective bytes): each term binds once
    (3.7e15, 2.1e12, 4.0e10),
    (1.0e12, 9.9e11, 0.0),
    (5.0e11, 1.0e9, 6.4e11),
    (0.0, 0.0, 0.0),
]


@pytest.mark.parametrize("flops,nbytes,coll", COSTS)
def test_analyze_and_model_flops_equal_the_reference(flops, nbytes, coll):
    mem = {"argument_bytes": 1.5e10, "live_bytes": 2.0e10}
    per_op = {"all-reduce": coll * 0.75, "all-gather": coll * 0.25}
    mflops = rl.model_flops(7_000_000_000, 7_000_000_000, 32768, "prefill")
    assert mflops == rrl.model_flops(7_000_000_000, 7_000_000_000, 32768,
                                     "prefill")
    assert rl.model_flops(10, 4, 3, "train") == \
        rrl.model_flops(10, 4, 3, "train") == 72.0
    kw = dict(arch="deepseek-7b", shape="prefill_32k", mesh_name="16x16",
              n_devices=256, cost={"flops": flops, "bytes accessed": nbytes},
              mem=mem, mflops=mflops, collective_bytes=coll,
              collective_per_op=per_op)
    got = rl.analyze(**kw).to_json()
    want = rrl.analyze(**kw, hw=rl.H100_SXM).to_json()
    assert got == want
    assert got["bottleneck"] == max(
        ("compute", flops / 989e12), ("memory", nbytes / 3.35e12),
        ("collective", coll / 450e9), key=lambda t: t[1])[0]


def _hlo_line(i, op, dtype, dims, groups):
    shape = f"{dtype}[{','.join(str(d) for d in dims)}]"
    if op == "all-reduce":
        tail = "to_apply=%add"
    elif op == "all-gather":
        tail = "dimensions={0}"
    else:
        tail = ""
    n, g = groups
    return (f"  %c{i} = {shape}{{0}} {op}({shape}{{0}} %p{i}), "
            f"replica_groups=[{n},{g}]<=[{n * g}], {tail}")


# (RankMesh kind, payload elements, dtype, group size, mesh size)
OPS = [("all_reduce_sum", 4096, "s32", 2, 8),
       ("all_reduce_max", 1, "f32", 4, 8),
       ("agree", 3, "s32", 8, 8),
       ("all_gather", 1024, "bf16", 2, 8),
       ("all_gather", 333, "f32", 4, 16),
       ("all_reduce_sum", 10, "s32", 1, 1),
       ("barrier", 0, "s32", 8, 8)]
_ITEM = {"s32": 4, "f32": 4, "bf16": 2}


def test_ring_traffic_equals_parse_collectives():
    lines, ops = [], []
    for i, (kind, n, dt, g, world) in enumerate(OPS):
        nbytes = n * _ITEM[dt]
        ops.append((kind, nbytes, g))
        if kind == "barrier":
            continue
        op = "all-gather" if kind == "all_gather" else "all-reduce"
        # the HLO names an all-gather's result: the group's payloads
        dims = [n * g] if op == "all-gather" else [n]
        lines.append(_hlo_line(i, op, dt, dims, (world // g, g)))
    hlo = "\n".join(lines) + "\n"
    want = rrl.parse_collectives(hlo)
    got = rl.collective_traffic(ops)
    assert got.bytes_per_device == pytest.approx(want.bytes_per_device,
                                                 rel=1e-12)
    assert got.per_op.keys() == want.per_op.keys()
    for k in got.per_op:
        assert got.per_op[k] == pytest.approx(want.per_op[k], rel=1e-12)
    assert got.counts == want.counts
    assert [o["group"] for o in got.ops] == [o["group"] for o in want.ops]
    assert [o["bytes"] for o in got.ops] == [o["bytes"] for o in want.ops]


def test_h100_record():
    hw = rl.H100_SXM
    assert (hw.peak_flops, hw.int8_ops, hw.hbm_bw) == (989e12, 1979e12,
                                                       3.35e12)
    assert hw.int32_ops == 132 * 64 * 1.98e9
    assert hw.ici_bw == hw.link_bw == 450e9
    assert 80e9 < hw.hbm_bytes < 86e9


# chip_smoke.py's formulas before they moved into the package (the same
# numbers PERF.md section 6 reports)
_HBM, _INT8, _INT32 = 3.35e12, 1979e12, 132 * 64 * 1.98e9


def _old_bound(nbytes, ops):
    t_mem, t_ops = nbytes / _HBM * 1e3, ops / _INT8 * 1e3
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")


def _old_b1(Bt, M, K, N):
    return _old_bound(Bt * M * K + Bt * K * N + Bt * M * N * 4 + Bt * 4,
                      9 * 2 * Bt * M * N * K)


def _old_b4(Bt, M, K, N):
    return _old_bound(3 * Bt * (M * K + K * N) + 4 * Bt * M * N,
                      9 * 2 * Bt * M * N * K)


def _old_dmac(Bt, M, K, N):
    t_mem = Bt * (M * K + K * N + 4 * M * N) / _HBM * 1e3
    t_ops = Bt * M * N * K * 4 / _INT32 * 1e3
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")


def _old_b2(N, T, D, keys, table, rows_per_key):
    nbytes = (N * T * D + 2 * keys * D + 3 * rows_per_key * keys * 4
              + N * T * D * 4 + table * 4 + N * 4)
    return _old_bound(nbytes, 2 * 9 * 2 * T * D * keys)


# (Bt, M, K, N) of PERF.md section 6 and chip_smoke.py's timed shapes, with
# the rounded bound PERF.md prints where it prints one
MM_SHAPES = [((1, 4, 4096, 4096), None), ((1, 4, 4096, 11008), 0.0135),
             ((1, 4, 11008, 4096), None), ((1, 4, 4096, 102400), None),
             ((1, 128, 4096, 11008), 0.0525), ((128, 32, 128, 1024), None),
             ((128, 32, 1024, 128), None), ((1, 512, 384, 32768), 0.0586)]


@pytest.mark.parametrize("shape,printed", MM_SHAPES)
def test_b1_b4_b5_bounds_equal_chip_smokes(shape, printed):
    assert rl.b1_bound(*shape) == _old_b1(*shape)
    assert rl.kernel_bound("mgs_matmul_exact_fused_stationary", shape) == \
        _old_b1(*shape)
    assert rl.b4_bound(*shape) == _old_b4(*shape)
    assert rl.dmac_bound(*shape) == _old_dmac(*shape)
    if printed is not None:
        assert round(rl.b1_bound(*shape)[0], 4) == printed
    if shape == (1, 4, 4096, 11008):        # PERF.md: B4 0.0404, B5 0.0431
        assert round(rl.b4_bound(*shape)[0], 4) == 0.0404
        assert rl.dmac_bound(*shape)[1] == "operations"
        assert round(rl.dmac_bound(*shape)[0], 4) == 0.0431


def test_partials_and_flush_bounds_equal_chip_smokes():
    """Rank 0's half of decode wd (4 x 5504 @ 5504 x 4096, one segment):
    PERF.md's 0.0068 and 0.00012 ms."""
    Bt, M, Kl, N, nseg = 1, 4, 5504, 4096, 1
    pbytes = nseg * 5 * Bt * M * N * 4
    assert rl.b1_partials_bound(Bt, M, Kl, N, nseg) == _old_bound(
        Bt * M * Kl + Bt * Kl * N + pbytes, 9 * 2 * Bt * M * N * Kl)
    assert rl.b1_flush_bound(Bt, M, N, nseg) == _old_bound(
        pbytes + Bt * M * N * 4 + 4, 5 * nseg * 2 * Bt * M * N)
    assert round(rl.b1_partials_bound(Bt, M, Kl, N, nseg)[0], 4) == 0.0068
    assert round(rl.b1_flush_bound(Bt, M, N, nseg)[0], 5) == 0.00012


def test_closing_entries_count_scales_as_stored_at_the_float32_rate():
    """B5's combine and B1's flush read their scale and bias as stored (a
    broadcast dim once) and do float32 arithmetic: rank 0's half of
    decode wd under a slice's scale, 16 E4M3 bins an output."""
    hw = rl.H100_SXM
    assert hw.fp32_flops == 67e12
    Bt, M, N, nb = 1, 4, 4096, 16
    nbytes, ops, rate = rl.kernel_work("mgs_matmul_dmac_combine",
                                       (Bt, M, 0, N), segments=nb)
    assert (nbytes, ops, rate) == (Bt * M * N * (4 * nb + 4) + 4,
                                   2 * nb * Bt * M * N, hw.fp32_flops)
    assert rl.dmac_combine_bound(Bt, M, N, nb) == (nbytes / hw.hbm_bw * 1e3,
                                                   "bytes")
    assert round(rl.dmac_combine_bound(Bt, M, N, nb)[0], 6) == 0.000333
    # a row's scale times a column's is stored whole
    assert rl.kernel_work("mgs_matmul_dmac_combine", (Bt, M, 0, N),
                          segments=nb, scale_elems=M * N)[0] == \
        nbytes + 4 * (M * N - 1)
    nbytes, ops, rate = rl.kernel_work("mgs_matmul_exact_flush",
                                       (Bt, M, 0, N), segments=2,
                                       scale_elems=0)
    assert (nbytes, rate) == (2 * 5 * Bt * M * N * 4 + Bt * M * N * 4,
                              hw.fp32_flops)


# B2: the dense entry (scale rows shared by the slice's rows) at 128 slices
# of head dim 128 and granite-moe's 2 rows; the paged / verify entries at
# 4 slots x 32 heads and 256 / 1024 / 4096 live keys a slot (a row each)
B2_CASES = [(128, 1, 128, 128 * 640, 128 * 8, 1),
            (32, 2, 64, 32 * 128, 32, 1),
            (128, 1, 128, 128 * 256, 128 * 2, 1),
            (128, 4, 128, 128 * 1024, 128 * 8, 4),
            (128, 1, 128, 128 * 4096, 128 * 32, 1)]


@pytest.mark.parametrize("case", B2_CASES)
def test_b2_bound_equals_chip_smokes(case):
    assert rl.b2_bound(*case) == _old_b2(*case)
    assert rl.kernel_bound("mgs_flash_attention", case[:5],
                           scale_rows=case[5]) == _old_b2(*case)
