"""Port parity for the training runtime: the data pipeline, checkpoints,
fault tolerance and the training loop (``repro_torch.data``,
``repro_torch.runtime``, ``repro_torch.launch.train``).

* ``SyntheticLM`` batches bitwise equal to the reference's for several
  ``(seed, step, host_slice)``.
* Counterparts of ``tests/test_runtime.py``: checkpoint round trip,
  atomicity, pruning, ignored partial directories, the async writer, a
  missing key, crashes mid-write and during the manifest, the async
  writer's crash; preemption (signal, off the main thread, context
  manager), backoff, recovery with its structured log line, stragglers;
  the data pipeline's determinism, resume and structure. (Elastic mesh
  planning is held in ``tests/test_torch_fleet.py``.)
* bfloat16 leaves round-trip bitwise as their 16-bit words with
  ``"bfloat16"`` in the manifest, and a reference bfloat16 checkpoint
  restores bitwise; ``AsyncCheckpointer.save`` copies a CPU tensor, so an
  in-place update after it returns does not reach the file.
* ``train_loop`` stopped by its preemption handler after 3 of 6 steps and
  resumed from its last checkpoint, and one that crashes and recovers
  through ``run_with_recovery``: both bitwise equal (state and losses) to
  an uninterrupted run on the CPU.
* A reference checkpoint restores in the port: the reference's
  ``train_loop`` (reduced mgs-paper-eval, float32 compute) writes step 4;
  the port's ``train_loop`` resumes from it (parameters, AdamW state,
  data state; every leaf bitwise the file's) and its step-4 loss and grad
  norm match the reference's uninterrupted step 4 within 1e-5 (relative).
"""

import dataclasses
import json
import os
import signal
import threading
import time
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import reduced_config as r_reduced  # noqa: E402
from repro.data import DataConfig as RDataConfig  # noqa: E402
from repro.data import SyntheticLM as RSyntheticLM  # noqa: E402
from repro.launch.mesh import make_mesh  # noqa: E402
from repro.launch.train import TrainLoopConfig as RLoop  # noqa: E402
from repro.launch.train import train_loop as r_train_loop  # noqa: E402
from repro.runtime import checkpoint as r_ckpt  # noqa: E402
from repro.train import OptConfig as ROptConfig  # noqa: E402

from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.launch.train import TrainLoopConfig, train_loop  # noqa: E402
from repro_torch.runtime import checkpoint as ckpt  # noqa: E402
from repro_torch.runtime.fault_tolerance import (  # noqa: E402
    PreemptionHandler, StragglerMonitor, backoff_delay, run_with_recovery)
from repro_torch.train import OptConfig  # noqa: E402
from repro_torch.tree import flatten_with_paths  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small ops: one intra-op thread, so that test workers running
    side by side do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree():
    return {"params": {"w": torch.arange(12.0).reshape(3, 4),
                       "b": torch.ones(4)},
            "opt": {"step": torch.tensor(7, dtype=torch.int32)}}


def _equal_trees(a, b):
    fa, fb = flatten_with_paths(a), flatten_with_paths(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, k
        assert torch.equal(fa[k], fb[k]), k


# ---------------------------------------------------------------------------
# the data pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,vocab,hs", [(0, 256, None), (5, 32768, None),
                                           (3, 1000, (2, 6))])
def test_batches_bitwise_equal_the_reference(seed, vocab, hs):
    cfg = dict(vocab=vocab, seq_len=24, global_batch=8, seed=seed)
    ours = SyntheticLM(DataConfig(**cfg), host_slice=hs)
    ref = RSyntheticLM(RDataConfig(**cfg), host_slice=hs)
    for step in (0, 1, 7, 10_000):
        a, b = ours.make_batch(step), ref.make_batch(step)
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    for _ in range(2):
        a, b = next(ours), next(ref)
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert ours.state_dict() == ref.state_dict()


def test_data_pipeline_determinism_and_resume():
    cfg = DataConfig(vocab=1000, seq_len=32, global_batch=4, seed=5)
    a = SyntheticLM(cfg)
    first = [next(a) for _ in range(3)]
    b = SyntheticLM(cfg)
    b.load_state_dict({"step": 2, "seed": 5})
    np.testing.assert_array_equal(first[2]["tokens"], next(b)["tokens"])
    np.testing.assert_array_equal(first[0]["tokens"][:, 1:],
                                  first[0]["labels"][:, :-1])


def test_data_pipeline_has_learnable_structure():
    cfg = DataConfig(vocab=512, seq_len=256, global_batch=8, seed=1)
    t = SyntheticLM(cfg).make_batch(0)["tokens"]
    assert float(np.mean(t[:, 2:] == t[:, :-2])) > 0.2


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    d = str(tmp_path / "ck")
    tree = _tree()
    ckpt.save(d, 7, tree, extra={"data": {"step": 7, "seed": 0}})
    step, restored, extra = ckpt.restore(d, template=tree)
    assert step == 7 and extra["data"]["step"] == 7
    _equal_trees(tree, restored)


def test_checkpoint_atomicity_no_tmp_left(tmp_path):
    d = str(tmp_path / "ck")
    ckpt.save(d, 1, _tree())
    assert not any(n.endswith(".tmp") for n in os.listdir(d))
    assert ckpt.latest_step(d) == 1


def test_checkpoint_prune_keeps_newest(tmp_path):
    d = str(tmp_path / "ck")
    for s in (1, 2, 3, 4, 5):
        ckpt.save(d, s, _tree(), keep=2)
    assert sorted(int(n.split("_")[1]) for n in os.listdir(d)) == [4, 5]


def test_partial_tmp_dir_is_ignored(tmp_path):
    d = str(tmp_path / "ck")
    ckpt.save(d, 3, _tree())
    os.makedirs(os.path.join(d, "step_00000009.tmp"))  # crashed save
    assert ckpt.latest_step(d) == 3
    os.makedirs(os.path.join(d, "step_00000011"))      # no manifest
    assert ckpt.latest_step(d) == 3


def test_async_checkpointer(tmp_path):
    d = str(tmp_path / "ck")
    saver = ckpt.AsyncCheckpointer(keep=2)
    tree = _tree()
    saver.save(d, 10, tree)
    saver.wait()
    step, restored, _ = ckpt.restore(d, template=tree)
    assert step == 10
    _equal_trees(tree, restored)


def test_restore_missing_key_raises(tmp_path):
    d = str(tmp_path / "ck")
    ckpt.save(d, 1, {"a": torch.ones(3)})
    with pytest.raises(KeyError):
        ckpt.restore(d, template={"a": torch.ones(3), "b": torch.ones(2)})


def test_checkpoint_crash_mid_write_keeps_prior_restore_point(tmp_path,
                                                              monkeypatch):
    d = str(tmp_path / "ck")
    tree = _tree()
    ckpt.save(d, 5, tree, extra={"mark": "good"})
    calls = {"n": 0}
    real_save = np.save

    def crashing_save(f, arr, *a, **k):
        calls["n"] += 1
        if calls["n"] == 2:
            raise OSError("disk died mid-write")
        return real_save(f, arr, *a, **k)

    monkeypatch.setattr(np, "save", crashing_save)
    with pytest.raises(OSError):
        ckpt.save(d, 6, tree)
    monkeypatch.undo()
    assert ckpt.latest_step(d) == 5
    step, restored, extra = ckpt.restore(d, template=tree)
    assert step == 5 and extra["mark"] == "good"
    _equal_trees(tree, restored)
    ckpt.save(d, 6, tree)          # the stale .tmp is replaced
    assert ckpt.latest_step(d) == 6


def test_checkpoint_crash_during_manifest_keeps_prior(tmp_path, monkeypatch):
    d = str(tmp_path / "ck")
    tree = _tree()
    ckpt.save(d, 1, tree)

    def crashing_dump(obj, f, *a, **k):
        raise OSError("crash during manifest")

    monkeypatch.setattr(json, "dump", crashing_dump)
    with pytest.raises(OSError):
        ckpt.save(d, 2, tree)
    monkeypatch.undo()
    assert ckpt.latest_step(d) == 1
    assert ckpt.restore(d, template=tree)[0] == 1


def test_async_checkpointer_surfaces_crash_and_recovers(tmp_path,
                                                        monkeypatch):
    d = str(tmp_path / "ck")
    tree = _tree()
    saver = ckpt.AsyncCheckpointer()
    saver.save(d, 1, tree)
    saver.wait()

    def crashing_save(f, arr, *a, **k):
        raise OSError("async disk death")

    monkeypatch.setattr(np, "save", crashing_save)
    saver.save(d, 2, tree)
    with pytest.raises(OSError):
        saver.wait()
    monkeypatch.undo()
    assert ckpt.latest_step(d) == 1
    saver.save(d, 2, tree)
    saver.wait()
    assert ckpt.latest_step(d) == 2


def test_bfloat16_leaves_round_trip_as_their_words(tmp_path):
    d = str(tmp_path / "ck")
    w = (torch.randn(5, 7, generator=torch.Generator().manual_seed(0))
         * 3).to(torch.bfloat16)
    tree = {"w": w, "step": torch.tensor(3, dtype=torch.int32)}
    ckpt.save(d, 1, tree)
    with open(os.path.join(d, "step_00000001", "manifest.json")) as f:
        meta = json.load(f)["keys"]["w"]
    assert meta["dtype"] == "bfloat16" and meta["shape"] == [5, 7]
    words = np.load(os.path.join(d, "step_00000001", meta["file"]))
    assert words.dtype.itemsize == 2
    np.testing.assert_array_equal(words.view(np.int16),
                                  w.view(torch.int16).numpy())
    _, restored, _ = ckpt.restore(d, template=tree)
    _equal_trees(tree, restored)
    _, flat, _ = ckpt.restore(d)
    assert torch.equal(flat["w"], w)


def test_reference_bfloat16_checkpoint_restores_bitwise(tmp_path):
    d = str(tmp_path / "ck")
    x = np.random.default_rng(0).normal(0, 2, (6, 3)).astype(np.float32)
    r_ckpt.save(d, 2, {"p": {"w": jnp.asarray(x, jnp.bfloat16),
                             "b": jnp.asarray(x[0])}})
    want = torch.from_numpy(x).to(torch.bfloat16)
    _, got, _ = ckpt.restore(d, template={"p": {
        "w": torch.zeros(6, 3, dtype=torch.bfloat16), "b": torch.zeros(3)}})
    assert got["p"]["w"].dtype == torch.bfloat16
    assert torch.equal(got["p"]["w"], want)
    assert torch.equal(got["p"]["b"], torch.from_numpy(x[0]))


def test_async_save_copies_a_cpu_tensor(tmp_path, monkeypatch):
    """The writer thread is held back until the caller has updated the
    tensor in place: the file still holds the value at ``save``."""
    d = str(tmp_path / "ck")
    w = torch.zeros(4)
    gate = threading.Event()
    real_save = np.save

    def slow_save(f, arr, *a, **k):
        gate.wait(5)
        return real_save(f, arr, *a, **k)

    monkeypatch.setattr(np, "save", slow_save)
    saver = ckpt.AsyncCheckpointer()
    saver.save(d, 1, {"w": w})
    w.add_(1.0)
    gate.set()
    saver.wait()
    monkeypatch.undo()
    assert torch.equal(ckpt.restore(d, template={"w": w})[1]["w"],
                       torch.zeros(4))


# ---------------------------------------------------------------------------
# fault tolerance
# ---------------------------------------------------------------------------

def test_preemption_handler():
    h = PreemptionHandler(signals=(signal.SIGUSR1,))
    assert not h.should_stop
    os.kill(os.getpid(), signal.SIGUSR1)
    time.sleep(0.05)
    assert h.should_stop
    h.restore()


def test_preemption_handler_off_main_thread_is_warned_noop():
    out = {}

    def build():
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            h = PreemptionHandler()
            out["warned"] = any(issubclass(x.category, RuntimeWarning)
                                for x in w)
        out["installed"] = h.installed
        out["stop_before"] = h.should_stop
        h.request_stop()
        out["stop_after"] = h.should_stop
        h.restore()

    t = threading.Thread(target=build)
    t.start()
    t.join(10)
    assert not t.is_alive()
    assert out == {"warned": True, "installed": False,
                   "stop_before": False, "stop_after": True}


def test_preemption_handler_context_manager():
    prev = signal.getsignal(signal.SIGUSR1)
    with PreemptionHandler(signals=(signal.SIGUSR1,)) as h:
        assert h.installed
        os.kill(os.getpid(), signal.SIGUSR1)
        time.sleep(0.05)
        assert h.should_stop
    assert signal.getsignal(signal.SIGUSR1) is prev


def test_backoff_delay_deterministic_capped():
    a = [backoff_delay(i, base_s=0.05, cap_s=2.0, seed=3)
         for i in range(1, 10)]
    assert a == [backoff_delay(i, base_s=0.05, cap_s=2.0, seed=3)
                 for i in range(1, 10)]
    assert a != [backoff_delay(i, base_s=0.05, cap_s=2.0, seed=4)
                 for i in range(1, 10)]
    assert all(0 < d <= 2.0 for d in a)
    clean = [backoff_delay(i, base_s=0.05, cap_s=2.0, jitter=0.0, seed=0)
             for i in range(1, 8)]
    assert clean[:3] == [0.05, 0.1, 0.2] and clean[-1] == 2.0
    assert backoff_delay(5, base_s=0.0) == 0.0


def test_run_with_recovery_structured_logging(capsys):
    seen, calls = [], []

    def run(resume):
        calls.append(resume)
        if len(calls) < 3:
            raise RuntimeError("node failure")
        return 7

    steps = iter([None, 40, 80])
    assert run_with_recovery(run, lambda: next(steps), max_restarts=3,
                             backoff_s=0.001, seed=11,
                             on_attempt=seen.append) == 7
    lines = [json.loads(ln) for ln in capsys.readouterr().err.splitlines()
             if ln.strip().startswith("{")]
    events = [e for e in lines if e.get("event") == "recovery_restart"]
    assert [e["attempt"] for e in events] == [1, 2]
    assert [e["resume_step"] for e in events] == [None, 40]
    assert all("node failure" in e["error"] for e in events)
    assert events == seen
    assert events[0]["backoff_s"] == pytest.approx(
        backoff_delay(1, base_s=0.001, cap_s=30.0, seed=11), abs=1e-6)


def test_run_with_recovery_restores_and_exhausts():
    calls = []

    def run(resume):
        calls.append(resume)
        if len(calls) < 3:
            raise RuntimeError("node failure")
        return 100

    steps = iter([None, 40, 80])
    assert run_with_recovery(run, lambda: next(steps), max_restarts=3) == 100
    assert calls == [None, 40, 80]

    def always(resume):
        raise RuntimeError("always fails")

    with pytest.raises(RuntimeError):
        run_with_recovery(always, lambda: None, max_restarts=2)


def test_straggler_monitor_flags_slow_host_and_stays_quiet():
    m = StragglerMonitor(n_hosts=8, threshold=1.5, min_steps=4)
    for _ in range(10):
        times = [100.0] * 8
        times[3] = 240.0
        m.record(times)
    rep = m.plan()
    assert rep.slow_hosts == [3] and rep.action == "grace_restart"
    assert rep.worst_ratio > 2.0
    q = StragglerMonitor(n_hosts=4, min_steps=4)
    for _ in range(6):
        q.record([100.0, 102.0, 98.0, 101.0])
    assert q.plan().action == "none"


# ---------------------------------------------------------------------------
# the training loop
# ---------------------------------------------------------------------------

def _loop(d=None, steps=6, **kw):
    return TrainLoopConfig(steps=steps, global_batch=2, seq_len=8,
                           log_every=1, ckpt_every=2, ckpt_dir=d, **kw)


_CFG = dataclasses.replace(reduced_config("mgs-paper-eval"), n_layers=2)
_OPT = OptConfig(lr=3e-3, warmup_steps=2, total_steps=6)


class _StopAfter:
    """A preemption handler that asks to stop at its ``n``-th poll (or
    raises there, a crash)."""

    def __init__(self, n, crash=False):
        self.n, self.crash, self.polls = n, crash, 0

    @property
    def should_stop(self):
        self.polls += 1
        if self.polls == self.n and self.crash:
            raise RuntimeError("node failure")
        return self.polls == self.n


@pytest.fixture(scope="module")
def uninterrupted():
    return train_loop(_CFG, _loop(), device="cpu", opt_cfg=_OPT)


def _losses(out):
    return {h["step"]: h["loss"] for h in out["history"]}


def test_preempted_and_resumed_loop_is_bitwise_uninterrupted(tmp_path,
                                                             uninterrupted):
    d = str(tmp_path / "ck")
    first = train_loop(_CFG, _loop(d), device="cpu", opt_cfg=_OPT,
                       handler=_StopAfter(3))
    assert sorted(_losses(first)) == [0, 1, 2]
    assert ckpt.latest_step(d) == 3       # the step reached, not 6
    rest = train_loop(_CFG, _loop(d), device="cpu", opt_cfg=_OPT,
                      resume_step=ckpt.latest_step(d))
    assert sorted(_losses(rest)) == [3, 4, 5]
    want = _losses(uninterrupted)
    assert {**_losses(first), **_losses(rest)} == want
    _equal_trees(rest["state"], uninterrupted["state"])
    assert ckpt.latest_step(d) == 6


def test_crashed_loop_recovers_bitwise(tmp_path, uninterrupted):
    d = str(tmp_path / "ck")
    handlers = iter([_StopAfter(3, crash=True), _StopAfter(0)])
    resumes, outs = [], []

    def run(resume):
        resumes.append(resume)
        outs.append(train_loop(_CFG, _loop(d), device="cpu", opt_cfg=_OPT,
                               resume_step=resume, handler=next(handlers)))
        return 6

    assert run_with_recovery(run, lambda: ckpt.latest_step(d)) == 6
    assert resumes == [None, 2]          # the checkpoint before the crash
    assert sorted(_losses(outs[0])) == [2, 3, 4, 5]
    _equal_trees(outs[0]["state"], uninterrupted["state"])


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    """Reduced mgs-paper-eval at float32 compute (batch 2 x 16): the
    reference writes step 4, the port resumes there."""
    f32 = dict(compute_dtype="float32", param_dtype="float32")
    tcfg = dataclasses.replace(reduced_config("mgs-paper-eval"), **f32)
    rcfg = dataclasses.replace(r_reduced("mgs-paper-eval"), **f32)
    opt = dict(lr=3e-3, warmup_steps=2, total_steps=5)
    loop = dict(global_batch=2, seq_len=16, log_every=1, ckpt_every=100)
    mesh = make_mesh((1, 1), ("data", "model"))
    d = str(tmp_path / "ref")
    r_train_loop(rcfg, RLoop(steps=4, ckpt_dir=d, **loop), mesh,
                 opt_cfg=ROptConfig(**opt))
    ref = r_train_loop(rcfg, RLoop(steps=5, **loop), mesh,
                       opt_cfg=ROptConfig(**opt))
    want = {h["step"]: h for h in ref["history"]}[4]
    assert ckpt.latest_step(d) == 4

    _, flat, extra = ckpt.restore(d, 4)
    assert extra["data"]["seed"] == 0 and int(flat["opt/step"]) == 4
    out = train_loop(tcfg, TrainLoopConfig(steps=5, ckpt_dir=d, **loop),
                     device="cpu", opt_cfg=OptConfig(**opt), resume_step=4)
    got = out["history"]
    assert [h["step"] for h in got] == [4]
    assert got[0]["loss"] == pytest.approx(want["loss"], rel=1e-5)
    assert got[0]["grad_norm"] == pytest.approx(want["grad_norm"], rel=1e-5)
    assert int(out["state"]["opt"]["step"]) == 5
    # what the port restored is bitwise the reference's files
    state4 = train_loop(tcfg, TrainLoopConfig(steps=4, ckpt_dir=d, **loop),
                        device="cpu", opt_cfg=OptConfig(**opt),
                        resume_step=4)["state"]
    for k, v in flatten_with_paths(state4).items():
        assert torch.equal(v, flat[k].to(v.dtype)), k
