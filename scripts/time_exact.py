#!/usr/bin/env python3
"""Time B1, B3 and B4, the exact limb matmuls, of one source tree on one GPU.

    python3 scripts/time_exact.py [--src DIR] [--label NAME]

Times ``mgs_matmul_exact_fused`` (B1, packed codes) and ``mgs_matmul_exact``
(B4, limb planes) at ``chip_smoke.py``'s B1 and B4 shapes, and B3
(``mgs_matmul_exact_fused(schedule="activation")``) beside B1 at its decode
shapes (``B3_DECODE``): the median
per-call device time, weights cycled through copies larger than L2, the
device queue kept full (``chip_smoke.time_ms``). Prints one JSON line
``{"label", "card", "rows"}``. ``--src`` is the ``src/`` of the tree to time
(default: this checkout's), so two versions compare in one call on one card,
for example a ``git archive`` of the parent commit unpacked under
``build/``: parent, change, change, parent.
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
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("time_exact: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.core.formats import E4M3, encode_bits
    from repro_torch.kernels import build_all
    from repro_torch.kernels.mgs_matmul import (
        limb_decompose, mgs_matmul_exact, mgs_matmul_exact_fused)
    build_all(["mgs_matmul"])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED)
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
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(json.dumps({"label": args.label, "card": smi.stdout.strip(),
                      "rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
