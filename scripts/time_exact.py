#!/usr/bin/env python3
"""Time the exact kernels B1, B3, B4 and B2 of one source tree on one GPU.

    python3 scripts/time_exact.py [--src DIR] [--label NAME]
                                  [--kernels matmul|b2|all]

``matmul``: ``mgs_matmul_exact_fused`` (B1, packed codes) and
``mgs_matmul_exact`` (B4, limb planes) at ``chip_smoke.py``'s B1 and B4
shapes, and B3 (``mgs_matmul_exact_fused(schedule="activation")``) beside B1
at its decode shapes (``B3_DECODE``), weights cycled through copies larger
than L2. ``b2``: ``mgs_flash_blocks`` (B2) on the arguments its entries pass
it: the dense entry at ``chip_smoke.b2_inputs`` (128 slices, ragged lengths
up to 1024), then the paged and verify (T = 4) entries at the continuous
path's width (4 slots x 32 heads, block 128, decode lengths 201, 0, 126, 2)
and with every slot at each of ``chip_smoke.B2_CONTEXTS`` live keys. Each
row is the median per-call device time with the device queue kept full
(``chip_smoke.time_ms``). Prints one JSON line ``{"label", "card",
"rows"}``. ``--src`` is the ``src/`` of the tree to time (default: this
checkout's), so two versions compare in one call on one card, for example a
``git archive`` of the parent commit unpacked under ``build/``: parent,
change, change, parent. The inputs come from this checkout's
``chip_smoke.py`` and one seed, so both trees see the same bytes.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--kernels", choices=("matmul", "b2", "all"),
                    default="all")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("time_exact: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import build_all
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED)
    rows = []
    if args.kernels != "b2":
        build_all(["mgs_matmul"])
        rows += matmul_rows(torch, cs, dev, gen)
    if args.kernels != "matmul":
        build_all(["mgs_attention"])
        rows += b2_rows(torch, cs, dev, gen)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(json.dumps({"label": args.label, "card": smi.stdout.strip(),
                      "rows": rows}), flush=True)
    return 0


def b2_rows(torch, cs, dev, gen):
    from repro_torch.core.formats import E4M3
    from repro_torch.kernels.mgs_attention import mgs_flash_blocks
    a = cs.b2_inputs(torch, dev, gen)
    args = [a[k] for k in ("q_codes", "k_pool", "v_pool", "bt", "live",
                           "qk_scale", "v_scale", "bias")]
    rows = [dict(shape="B2 dense, 128 slices, <= 1024 keys", ms=cs.time_ms(
        torch, lambda: mgs_flash_blocks(*args, E4M3), 50))]
    del a, args
    cases = [("continuous width", [201, 0, 126, 2])] + [
        (f"{k} keys", [k] * 4) for k in cs.B2_CONTEXTS]
    for label, lens in cases:
        p = cs.b2_paged_case(torch, dev, gen, lens)
        for entry, t in (("paged", 1), ("verify", p["q"].shape[1])):
            args = cs.b2_kernel_args(torch, p, t)
            rows.append(dict(shape=f"B2 {entry}, {label}", ms=cs.time_ms(
                torch, lambda: mgs_flash_blocks(*args, p["fmt"]), 50)))
        del p, args
        torch.cuda.empty_cache()
    return rows


def matmul_rows(torch, cs, dev, gen):
    from repro_torch.core.formats import E4M3, encode_bits
    from repro_torch.kernels.mgs_matmul import (
        limb_decompose, mgs_matmul_exact, mgs_matmul_exact_fused)
    shapes = list(dict.fromkeys(cs.B1_SHAPES + cs.B45_SHAPES))
    rows = []
    for name, Bt, M, K, N in shapes:
        copies = max(1, min(8, -(-200_000_000 // (Bt * K * N))))
        x = cs._margin_values(torch, (Bt, M, K), dev, gen)
        ws = [cs._margin_values(torch, (Bt, K, N), dev, gen)
              for _ in range(copies)]
        xc = encode_bits(x, E4M3)
        wcs = [encode_bits(w, E4M3) for w in ws]
        xl = limb_decompose(x).movedim(0, 1).contiguous()
        wls = [limb_decompose(w).movedim(0, 1).contiguous() for w in ws]
        it = iter(range(10**9))

        def nxt():
            return next(it) % copies
        b1 = cs.time_ms(torch, lambda: mgs_matmul_exact_fused(
            xc, wcs[nxt()], E4M3), 20)
        b4 = cs.time_ms(torch, lambda: mgs_matmul_exact(xl, wls[nxt()]), 20)
        rows.append(dict(shape=name, Bt=Bt, M=M, K=K, N=N, b1_ms=b1,
                         b4_ms=b4))
        del x, ws, xc, wcs, xl, wls
        torch.cuda.empty_cache()
    for name, Bt, M, K, N in cs.B3_DECODE:
        copies = max(1, min(8, -(-200_000_000 // (Bt * K * N))))
        xc = encode_bits(cs._margin_values(torch, (Bt, M, K), dev, gen), E4M3)
        wcs = [encode_bits(cs._margin_values(torch, (Bt, K, N), dev, gen),
                           E4M3) for _ in range(copies)]
        it = iter(range(10**9))

        def call(**kw):
            return lambda: mgs_matmul_exact_fused(
                xc, wcs[next(it) % copies], E4M3, **kw)
        b1 = cs.time_ms(torch, call(), 20)
        b3 = cs.time_ms(torch, call(schedule="activation"), 20)
        rows.append(dict(shape=name, Bt=Bt, M=M, K=K, N=N, b1_ms=b1,
                         b3_ms=b3))
        del xc, wcs
        torch.cuda.empty_cache()
    return rows


if __name__ == "__main__":
    sys.exit(main())
