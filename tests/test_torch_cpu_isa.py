"""The port's CPU results do not depend on ATen's vector ISA.

ATen compiles its CPU kernels once per vector ISA (``default``, AVX2,
AVX512) and picks one at start-up (``ATEN_CPU_CAPABILITY`` overrides it);
several vectorized kernels (``softmax``, ``pow``, ``sigmoid``, ``log1p``,
``logaddexp``, ``tanh_backward``) round differently between them. Here the
same numpy-drawn weights and tokens go through the port in two
subprocesses, one under ``ATEN_CPU_CAPABILITY=default`` and one under the
host's own ISA, and every output must be bitwise equal: reduced
mgs-paper-eval's ``forward`` under ``baseline_fp32``, ``fp8_wide`` and
int8 ``wrap`` at 12 bits (the dense attention's softmax, RoPE's
frequencies), a granite-moe MoE layer (its router's softmax), reduced
falcon-mamba's ``forward`` (the softplus of its step sizes) and the
gradient of whisper-tiny's loss (the tanh-GELU's backward). The weights
are drawn with numpy: the port's own ``init_params`` draws float32
``normal_`` on the CPU, which ATen vectorizes per ISA too.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

SRC = Path(__file__).resolve().parents[1] / "src"
CASES = ("baseline_fp32", "fp8_wide", "int8_wrap_12", "moe_router",
         "ssm_softplus", "gelu_grad")

_SCRIPT = r'''
import dataclasses, sys
import numpy as np
import torch
torch.set_num_threads(1)
from repro_torch.configs import reduced_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import forward, loss_fn
from repro_torch.models.transformer import param_shapes
from repro_torch.models.moe import moe_apply
from repro_torch.quant import QuantConfig


def weights(cfg, seed=0):
    rng = np.random.default_rng(seed)

    def draw(tree):
        if isinstance(tree, dict):
            return {k: draw(v) for k, v in tree.items()}
        return (rng.normal(0, 1, tree) / np.sqrt(tree[-1])).astype(
            np.float32)
    return draw(param_shapes(cfg))


def tokens(cfg, B=2, T=16, seed=1):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, T)).astype(np.int64))


F32 = dict(compute_dtype="float32", param_dtype="float32")
MODES = {"baseline_fp32": {}, "fp8_wide": dict(dtype="fp8_e4m3", accum="wide"),
         "int8_wrap_12": dict(dtype="int8", accum="wrap", narrow_bits=12)}
out = {}
cfg = dataclasses.replace(reduced_config("mgs-paper-eval"), **F32)
params = params_from_numpy(weights(cfg))
with torch.no_grad():
    for name, q in MODES.items():
        c = dataclasses.replace(cfg, quant=QuantConfig(**q))
        out[name] = forward(params, c, {"tokens": tokens(c)})[0]
    c = dataclasses.replace(reduced_config("granite-moe-1b-a400m"), **F32)
    p = params_from_numpy(weights(c))["layers"]["moe"]
    p = {k: v[0] for k, v in p.items()}
    x = torch.from_numpy(np.random.default_rng(2).normal(
        0, 1, (2, 16, c.d_model)).astype(np.float32))
    y, aux = moe_apply(p, x, c)
    out["moe_router"] = torch.cat([y.reshape(-1), aux.reshape(1)])
    c = dataclasses.replace(reduced_config("falcon-mamba-7b"), **F32)
    out["ssm_softplus"] = forward(params_from_numpy(weights(c)), c,
                                  {"tokens": tokens(c)})[0]
c = dataclasses.replace(reduced_config("whisper-tiny"), **F32)
p = params_from_numpy(weights(c))
leaves = []


def req(t):
    if isinstance(t, dict):
        return {k: req(v) for k, v in t.items()}
    leaves.append(t.requires_grad_(True))
    return t


toks = tokens(c, T=9)
batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
         "audio_embeds": torch.from_numpy(np.random.default_rng(3).normal(
             0, 1, (2, c.encoder_len, c.d_model)).astype(np.float32))}
total, _ = loss_fn(req(p), c, batch)
total.backward()
out["gelu_grad"] = torch.cat([t.grad.reshape(-1) for t in leaves
                              if t.grad is not None])
np.savez(sys.argv[1], **{k: v.detach().numpy() for k, v in out.items()})
'''


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small ops: one intra-op thread, so that test workers running
    side by side do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(tmp: Path, capability):
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    env.pop("ATEN_CPU_CAPABILITY", None)
    if capability is not None:
        env["ATEN_CPU_CAPABILITY"] = capability
    path = tmp / f"out_{capability or 'native'}.npz"
    subprocess.run([sys.executable, "-c", _SCRIPT, str(path)], env=env,
                   check=True, timeout=600)
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("isa")
    return _run(tmp, "default"), _run(tmp, None)


@pytest.mark.parametrize("case", CASES)
def test_port_outputs_bitwise_equal_across_cpu_isas(outputs, case):
    default, native = outputs
    a, b = default[case], native[case]
    assert a.shape == b.shape and np.isfinite(a).all()
    assert a.tobytes() == b.tobytes(), (
        case, int((a != b).sum()), float(np.abs(a - b).max()))
