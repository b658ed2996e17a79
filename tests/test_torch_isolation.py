"""The port stands alone: importing ``repro_torch`` loads neither JAX nor
the reference package, and no source file of the port names them."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

SRC = Path(__file__).resolve().parents[1] / "src"
PORT = SRC / "repro_torch"
MODULES = ["repro_torch", "repro_torch.core", "repro_torch.quant",
           "repro_torch.kernels", "repro_torch.configs", "repro_torch.models",
           "repro_torch.launch.serve", "repro_torch.convert",
           "repro_torch.kernels.mgs_matmul", "repro_torch.kernels.ops",
           "repro_torch.kernels.mgs_attention", "repro_torch.kernels._cuda",
           "repro_torch.quant.kvcache", "repro_torch.quant.qmatmul",
           "repro_torch.models.attention", "repro_torch.models.transformer",
           "repro_torch.core.mgs", "repro_torch.kernels.ref",
           "repro_torch.quant.prepared", "repro_torch.quant.qeinsum",
           "repro_torch.core.markov", "repro_torch.quant.calibrate",
           "repro_torch.quant.streaming", "repro_torch.launch.mesh",
           "repro_torch.launch.replica", "repro_torch.runtime.elastic",
           "repro_torch.runtime.fault_tolerance", "repro_torch.parallel",
           "repro_torch.parallel.sharding", "repro_torch.parallel.comm"]


def test_import_leaves_jax_and_repro_unloaded():
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in MODULES)
            + "bad = sorted(m for m in sys.modules if m == 'jax' or "
              "m.startswith('jax.') or m == 'repro' or "
              "m.startswith('repro.'))\n"
              "print(repr(bad))\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_sources_name_neither_jax_nor_repro():
    pat = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b"
                     r"|from\s+repro(\.|\s)|import\s+repro\.)", re.M)
    files = sorted(PORT.rglob("*.py"))
    assert len(files) >= 20
    hits = [str(f) for f in files if pat.search(f.read_text())]
    assert hits == []
    smoke = SRC.parent / "chip_smoke.py"
    assert not pat.search(smoke.read_text())
