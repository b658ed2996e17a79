"""The port's replica fleet (``repro_torch.launch.replica``), its fault
injection and health (``runtime.fault_tolerance``), slot sub-meshes
(``launch.mesh``) and re-meshing (``runtime.elastic``).

The reference gives a fleet several devices through
``XLA_FLAGS=--xla_force_host_platform_device_count=N`` in subprocesses
(``tests/test_replica.py``, ``tests/test_failover.py``); the port runs its
counterparts in process, over CPU slots (``virtual_devices("cpu", n)``).

Against the reference: the injector's fired log for the same specs and
seed, ``backoff_delay``, ``plan_mesh``, the slot ids ``replacement_mesh``
keeps, and the fleet's tokens on reduced deepseek-7b under the whole-model
bar of ``tests/test_torch_model.py``. Inside the port, bitwise: the fleet
against one engine under both schedulers, after a retry, a requeue, a
rebuild and a dead replica; the continuous fleet against one continuous
engine; replay by version on a rebuilt replica; ``PREP_STATS`` flat in R
and across recovery.

Deadlines and backoffs are short, and every wait has a timeout, so a hung
worker fails its test instead of stalling the suite.
"""

import dataclasses
import sys
import threading
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.launch import mesh as r_mesh  # noqa: E402
from repro.runtime import elastic as r_elastic  # noqa: E402
from repro.runtime import fault_tolerance as r_ft  # noqa: E402

from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.kernels import _cuda  # noqa: E402
from repro_torch.launch.mesh import (SubMesh, batch_axes,  # noqa: E402
                                     carve_submeshes, virtual_devices)
from repro_torch.launch.replica import (ReplicaServeDriver,  # noqa: E402
                                        transfer_tree)
from repro_torch.launch.serve import (ContinuousBatchingEngine,  # noqa: E402
                                      Request, ServeEngine)
from repro_torch.launch.serve import main as serve_main  # noqa: E402
from repro_torch.models import init_cache, init_params  # noqa: E402
from repro_torch.quant import PREP_STATS, clear_prepared_cache  # noqa: E402
from repro_torch.quant import config as tq  # noqa: E402
from repro_torch.runtime import elastic, fault_tolerance as ft  # noqa: E402
from repro_torch.runtime.fault_tolerance import (  # noqa: E402
    DeadlineExceeded, FaultInjector, FaultSpec, InjectedFault,
    PoisonedDeviceError, ReplicaHealth)

T = 60          # seconds any fleet wait may take before the test fails


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small ops: one intra-op thread, so that test workers running
    side by side do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(**quant):
    return dataclasses.replace(reduced_config("deepseek-7b"),
                               quant=tq.FP8_MGS_SERVE_KV.replace(**quant))


@pytest.fixture(scope="module")
def shared():
    """Reduced deepseek-7b under FP8_MGS_SERVE_KV, prepared once; the
    residual output projections x 8 so that greedy tokens vary (at the
    plain seed-0 init every request echoes its last token)."""
    cfg = _cfg()
    params = init_params(cfg, seed=0)
    params["layers"]["attn"]["wo"] *= 8.0
    params["layers"]["ffn"]["wd"] *= 8.0
    engine = ServeEngine(cfg, batch=2, max_len=24, params=params,
                         device="cpu")
    want = _requests(cfg, 12)
    engine.run(want)
    return SimpleNamespace(cfg=cfg, params=engine.params, engine=engine,
                           want=want)


def _requests(cfg, n, max_new=3, rid0=0, seed=0):
    rng = np.random.default_rng(seed)
    return [Request(rid=rid0 + i, prompt=rng.integers(1, cfg.vocab, 8)
                    .astype(np.int32), max_new_tokens=max_new)
            for i in range(n)]


def _tokens(reqs):
    return [r.out_tokens for r in reqs]


def _driver(h, replicas=2, slots=None, **kw):
    return ReplicaServeDriver(
        h.cfg, replicas, batch=2, max_len=24, params=h.params,
        devices=virtual_devices("cpu", slots or replicas), **kw)


def _prefill_logits(engine, cfg):
    toks = np.stack([r.prompt for r in _requests(cfg, 2)])
    cache = init_cache(cfg, 2, 24, device=engine.device)
    with torch.no_grad():
        lg, _ = engine._prefill(toks, cache, engine._calib_state)
    return lg.float().numpy()


def _drain_results(driver, futs):
    driver.drain(T)
    return [f.result(T) for f in futs]


# ---------------------------------------------------------------------------
# fault injection, health, backoff (port and reference)
# ---------------------------------------------------------------------------


def test_fault_injector_deterministic_addressing():
    spec = FaultSpec(kind="raise", replica=1, group=2, count=2)
    inj = FaultInjector([spec], seed=7)
    b0 = inj.bind(0)
    for _ in range(5):            # replica 0 never targeted
        b0.before_group()
    b1 = inj.bind(1)
    b1.before_group()             # group 0: clean
    b1.before_group()             # group 1: clean
    with pytest.raises(InjectedFault):
        b1.before_group()         # group 2: fires
    with pytest.raises(InjectedFault):
        b1.before_group()         # group 3: count=2 window
    b1.before_group()             # group 4: past the window
    assert [(e["replica"], e["group"]) for e in inj.fired()] == [(1, 2),
                                                                 (1, 3)]


def test_fault_injector_decode_step_and_any_replica():
    inj = FaultInjector([FaultSpec(kind="raise", replica=-1, group=0,
                                   after_decode_steps=2)])
    b = inj.bind(3)
    b.before_group()              # group start clean
    b.on_decode(1)                # step 1 clean
    with pytest.raises(InjectedFault):
        b.on_decode(2)            # fires mid-stream
    assert inj.fired()[0]["step"] == 2


def test_fault_injector_probability_is_seed_deterministic():
    spec = FaultSpec(kind="raise", replica=-1, group=0, count=64,
                     probability=0.5)

    def firing_groups(seed):
        b = FaultInjector([spec], seed=seed).bind(0)
        out = []
        for g in range(64):
            try:
                b.before_group()
            except InjectedFault:
                out.append(g)
        return out

    a, b_, c = firing_groups(1), firing_groups(1), firing_groups(2)
    assert a == b_ and a != c and 0 < len(a) < 64


def _drive(mod, specs, seed):
    """The same call sequence on an injector of ``mod`` (port or
    reference): 3 replicas x 6 groups x 3 decode steps, every fault
    swallowed; returns (kind, replica, group, step) of each fired event."""
    inj = mod.FaultInjector([mod.FaultSpec(**s) for s in specs], seed=seed)
    for g in range(6):
        for rep in (0, 1, 2):
            b = inj.bind(rep)
            try:
                b.before_group()
                for step in (1, 2, 3):
                    b.on_decode(step)
            except mod.InjectedFault:
                pass
    return [(e["kind"], e["replica"], e["group"], e["step"])
            for e in inj.fired()]


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_fault_injector_fires_as_the_reference(seed):
    specs = [dict(kind="raise", replica=-1, group=0, count=6,
                  probability=0.4),
             dict(kind="poison", replica=1, group=2, after_decode_steps=2,
                  device_ids=(4, 5)),
             dict(kind="hang", replica=2, group=1, count=2, hang_s=0.001,
                  after_decode_steps=3),
             dict(kind="raise", replica=0, group=3, after_decode_steps=1,
                  probability=0.7)]
    got = _drive(ft, specs, seed)
    assert got == _drive(r_ft, specs, seed)
    assert len({k for k, *_ in got}) >= 2


def test_fault_injector_counts_executions_across_threads():
    """Several replicas' workers start groups at once: each replica's
    execution counter loses no update (the lock), so every fault fires
    exactly at its address."""
    specs = [FaultSpec(kind="raise", replica=r, group=37) for r in range(8)]
    inj = FaultInjector(specs)
    hits = []

    def worker(rep):
        b = inj.bind(rep)
        for _ in range(50):
            try:
                b.before_group()
            except InjectedFault:
                hits.append(rep)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(r % 8,))
                   for r in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(T)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert sorted(hits) == list(range(8))       # group 37 of each, once
    assert inj._exec == {r: 100 for r in range(8)}


def test_launch_counts_lose_no_update_across_threads():
    """The fleet's workers count kernel launches from several threads."""
    name = "mgs_flash_attention"
    before = _cuda.LAUNCHES[name]

    def worker():
        for _ in range(2000):
            _cuda.count_launch(name)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(T)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert _cuda.LAUNCHES[name] - before == 16 * 2000
    _cuda.LAUNCHES[name] = before


def test_poison_spec_requires_devices_and_carries_ids():
    with pytest.raises(ValueError):
        FaultSpec(kind="poison")
    with pytest.raises(ValueError):
        FaultSpec(kind="melt")
    b = FaultInjector([FaultSpec(kind="poison", device_ids=(3, 5))]).bind(0)
    with pytest.raises(PoisonedDeviceError) as ei:
        b.before_group()
    assert ei.value.device_ids == (3, 5)
    assert isinstance(ei.value, InjectedFault)


def test_replica_health_state_machine():
    h = ReplicaHealth(ema=0.5, unhealthy_after=2)
    assert h.state == "healthy" and h.schedulable()
    h.record_failure(RuntimeError("x"))
    assert h.state == "suspect" and h.schedulable()
    h.record_failure()
    assert h.state == "unhealthy" and not h.schedulable()
    h.record_success(1.0)
    assert h.state == "healthy"
    h.record_success(3.0)
    assert h.latency_ema == pytest.approx(2.0)     # 0.5*1 + 0.5*3
    h.force("rebuilding")
    assert h.state == "rebuilding" and not h.schedulable()
    h.force("dead")
    assert h.state == "dead"
    with pytest.raises(ValueError):
        h.force("zombie")
    h.reset()
    assert h.state == "healthy" and h.latency_ema is None
    snap = h.snapshot()
    assert snap["failures"] == 2 and snap["last_error"] == "RuntimeError: x"
    h.record_success(10.0)
    assert h.is_straggler(1.0) and not h.is_straggler(None)


def test_backoff_and_plan_mesh_match_the_reference():
    for seed in (0, 1, 7):
        for attempt in range(1, 8):
            kw = dict(base_s=0.05, cap_s=1.0, seed=seed)
            assert ft.backoff_delay(attempt, **kw) == \
                r_ft.backoff_delay(attempt, **kw)
    assert ft.backoff_delay(3, base_s=0.0) == 0.0
    for n in (1, 2, 3, 8, 12, 256, 512, 1024):
        for mp in (1, 2, 4):
            if n < mp:
                with pytest.raises(ValueError):
                    elastic.plan_mesh(n, mp)
                continue
            assert elastic.plan_mesh(n, mp) == r_elastic.plan_mesh(n, mp)


# ---------------------------------------------------------------------------
# slots, sub-meshes, re-meshing
# ---------------------------------------------------------------------------


def test_carve_submeshes_slots_and_errors():
    slots = virtual_devices("cpu", 8)
    assert [s.id for s in slots] == list(range(8))
    meshes = carve_submeshes(2, model_parallel=1, devices=slots)
    assert [m.shape for m in meshes] == [{"data": 4, "model": 1}] * 2
    assert meshes[0].ids == [0, 1, 2, 3] and meshes[1].ids == [4, 5, 6, 7]
    assert all(m.device == torch.device("cpu") for m in meshes)
    one = carve_submeshes(1, devices=virtual_devices("cpu", 1))
    assert one[0].shape == {"data": 1, "model": 1}
    left = carve_submeshes(3, model_parallel=1, devices=slots,
                           exclude=(0, 5))
    assert [m.ids for m in left] == [[1, 2], [3, 4], [6, 7]]
    assert [m.shape for m in left] == [{"data": 2, "model": 1}] * 3
    with pytest.raises(ValueError):
        carve_submeshes(3, devices=slots)              # 8 % 3
    with pytest.raises(ValueError):
        carve_submeshes(0, devices=slots)
    with pytest.raises(ValueError):
        carve_submeshes(2, model_parallel=3, devices=slots)
    with pytest.raises(NotImplementedError, match="A12.2"):
        carve_submeshes(2, devices=slots)              # default mp = 4
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            carve_submeshes(1)


@pytest.mark.parametrize("axes", [
    ("data", "model"), ("pod", "data", "model"), ("model",), ("pod",)])
def test_batch_axes_match_the_reference(axes):
    mesh = SimpleNamespace(axis_names=axes)
    assert batch_axes(mesh) == r_mesh.batch_axes(mesh)
    sub = carve_submeshes(1, devices=virtual_devices("cpu", 1))[0]
    assert batch_axes(sub) == r_mesh.batch_axes(sub) == ("data",)


def _fake_ref_mesh(data, model):
    devs = np.asarray([SimpleNamespace(id=i) for i in range(data * model)],
                      dtype=object).reshape(data, model)
    return SimpleNamespace(devices=devs, shape={"data": data,
                                                "model": model})


@pytest.mark.parametrize("data,model,exclude", [
    (1, 1, ()), (4, 1, (0,)), (8, 1, (2, 5)), (6, 1, (1,)),
    (4, 2, (3,)), (3, 2, (0, 1)), (4, 1, (0, 1, 2))])
def test_replacement_mesh_keeps_the_reference_ids(monkeypatch, data, model,
                                                  exclude):
    """The reference's ``replacement_mesh`` on a grid of stand-in devices
    (its ``Mesh`` replaced by a plain record for the call) keeps the same
    ids, in the same grid, as the port's over slots."""
    monkeypatch.setattr(r_elastic, "Mesh", lambda grid, axes: SimpleNamespace(
        devices=grid, shape=dict(zip(axes, grid.shape))))
    ref = r_elastic.replacement_mesh(_fake_ref_mesh(data, model),
                                     exclude=exclude)
    mesh = SubMesh(np.asarray(virtual_devices("cpu", data * model),
                              dtype=object).reshape(data, model))
    got = elastic.replacement_mesh(mesh, exclude=exclude)
    assert got.shape == dict(ref.shape)
    assert got.ids == [d.id for d in ref.devices.flat]
    assert not set(got.ids) & set(exclude)


def test_replacement_mesh_raises_when_nothing_is_left():
    mesh = carve_submeshes(1, devices=virtual_devices("cpu", 1))[0]
    assert elastic.replacement_mesh(mesh).shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError):
        elastic.replacement_mesh(mesh, exclude=(0,))


def test_transfer_tree_is_the_identity_on_its_device(shared):
    before = dict(PREP_STATS)
    moved = transfer_tree(shared.params, "cpu")
    wq, wq2 = (p["layers"]["attn"]["wq"] for p in (shared.params, moved))
    assert wq2 is wq and moved["embed"] is shared.params["embed"]
    assert dict(PREP_STATS) == before


# ---------------------------------------------------------------------------
# the engine seam
# ---------------------------------------------------------------------------


def test_engine_seam_deadline_and_recovery(shared):
    """An injected hang trips the watchdog; an abort trips it too; the
    engine stays serviceable and a clean re-run after the caller's reset
    reproduces the tokens bitwise."""
    inj = FaultInjector([FaultSpec(kind="hang", replica=0, group=0,
                                   hang_s=0.1)])
    got = _requests(shared.cfg, 2)
    with pytest.raises(DeadlineExceeded):
        shared.engine.run(got, injector=inj.bind(0), deadline_s=0.02)
    assert inj.fired()[0]["kind"] == "hang"
    with pytest.raises(DeadlineExceeded, match="aborted"):
        shared.engine.run(got, should_abort=lambda: True)
    for r in got:
        r.out_tokens.clear()
        r.done = False
    shared.engine.run(got)
    assert _tokens(got) == _tokens(shared.want[:2])
    cont = ContinuousBatchingEngine(
        dataclasses.replace(shared.cfg, quant=tq.FP8_MGS_SERVE_PAGED),
        slots=1, max_len=24, device="cpu")
    with pytest.raises(NotImplementedError):
        cont.run([], deadline_s=1.0)


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------


def test_single_replica_matches_engine(shared):
    got = _requests(shared.cfg, 5)
    with _driver(shared, 1) as driver:
        stats = driver.run(got, timeout=T)
    assert _tokens(got) == _tokens(shared.want[:5])
    assert stats["requests"] == 5 and stats["groups"] == 3   # 2 + 2 + 1
    assert stats["decode_tokens"] == 15 and stats["replicas"] == 1
    assert stats["decode_steps"] == 3 * 2    # the last token needs no step


def test_two_replicas_bitwise_and_planes_prepared_once(shared):
    """R = 2: tokens and the second replica's prefill logits bitwise one
    engine's, disjoint slots, and the planes prepared once: a fleet built
    from raw weights prepares as many as one engine does."""
    cfg = shared.cfg
    raw = init_params(cfg, seed=1)
    n0 = PREP_STATS["prepared"]
    driver = ReplicaServeDriver(cfg, 2, batch=2, max_len=24, params=raw,
                                devices=virtual_devices("cpu", 2))
    n_driver = PREP_STATS["prepared"] - n0
    clear_prepared_cache()
    n1 = PREP_STATS["prepared"]
    engine = ServeEngine(cfg, batch=2, max_len=24, params=raw, device="cpu")
    assert n_driver == PREP_STATS["prepared"] - n1 > 0
    try:
        assert not set(driver.meshes[0].ids) & set(driver.meshes[1].ids)
        wq = [e.params["layers"]["attn"]["wq"] for e in driver.engines]
        assert wq[1] is wq[0]                       # shared, not copied
        got, want = _requests(cfg, 6), _requests(cfg, 6)
        stats = driver.run(got, timeout=T)
    finally:
        driver.close(T)
    engine.run(want)
    assert _tokens(got) == _tokens(want)
    assert stats["groups_per_replica"] == [2, 1]
    assert (_prefill_logits(driver.engines[1], cfg)
            == _prefill_logits(engine, cfg)).all()


@pytest.mark.parametrize("scheduler", ["round_robin", "least_loaded"])
def test_two_replicas_match_one_engine_under_both_schedulers(shared,
                                                             scheduler):
    got = _requests(shared.cfg, 12)
    with _driver(shared, 2, scheduler=scheduler) as driver:
        driver.warmup(prompt_len=8, max_new=3)
        stats = driver.run(got, timeout=T)
    assert _tokens(got) == _tokens(shared.want)
    assert stats["scheduler"] == scheduler and stats["requests"] == 12
    assert sum(stats["groups_per_replica"]) == 6


def test_concurrent_submits_drain(shared):
    """Concurrent submitters, both policies: every future resolves, every
    request completes, nothing is left queued; groups form in arrival
    order, so tokens match one engine's on the same grouping."""
    for policy in ("round_robin", "least_loaded"):
        with _driver(shared, 2, scheduler=policy) as driver:
            driver.warmup(prompt_len=8, max_new=3)
            reqs = _requests(shared.cfg, 10)
            futs = [None] * len(reqs)
            lock = threading.Lock()
            order = []

            def submitter(lo, hi):
                for i in range(lo, hi):
                    with lock:
                        futs[i] = driver.submit(reqs[i])
                        order.append(i)

            threads = [threading.Thread(target=submitter, args=(0, 5)),
                       threading.Thread(target=submitter, args=(5, 10))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(T)
            done = _drain_results(driver, futs)
            stats = driver.stats()
            assert not driver._pending and sum(driver._inflight) == 0
        assert all(f.done() for f in futs), policy
        assert sorted(len(r.out_tokens) for r in done) == [3] * 10
        assert stats["requests"] == 10
        assert all(g > 0 for g in stats["groups_per_replica"]), policy
        single = [dataclasses.replace(reqs[i], out_tokens=[], done=False)
                  for i in order]
        shared.engine.run(single)
        assert [r.out_tokens for r in single] == \
            [reqs[i].out_tokens for i in order]


def test_calibration_built_once_and_shared(shared):
    """``calibrate()`` records on replica 0 only and installs the same
    table everywhere; tokens are unchanged (the planned periods are past
    every K)."""
    cfg = dataclasses.replace(shared.cfg,
                              quant=shared.cfg.quant.replace(
                                  flush_target=1e-6))
    h = SimpleNamespace(cfg=cfg, params=shared.params)
    with _driver(h, 2) as driver:
        before = _requests(cfg, 4)
        driver.run(before, timeout=T)
        table = driver.calibrate()
        after = _requests(cfg, 4)
        driver.run(after, timeout=T)
        pairs = [e.cfg.quant.calibration for e in driver.engines]
        sig = [e.params["layers"]["ffn"]["wg"].act_sigma
               for e in driver.engines]
        head = [e.params["unembed_prepared"].act_sigma
                for e in driver.engines]
        versions = [e.table_version for e in driver.engines]
    assert len(table) > 0 and table.sigma("logits") is not None
    assert all(p == pairs[0] and p is not None for p in pairs)
    assert all(s is not None for s in sig + head)
    assert versions == [1, 1] and {r.table_version for r in after} == {1}
    assert _tokens(before) == _tokens(after) == _tokens(shared.want[:4])


def test_transient_fault_retries_in_place(shared):
    """A mid-decode crash (partial out_tokens) is retried on the same
    replica after a reset; tokens bitwise, health back to healthy."""
    inj = FaultInjector([FaultSpec(kind="raise", replica=0, group=1,
                                   after_decode_steps=2)])
    got = _requests(shared.cfg, 5)
    with _driver(shared, 1, injector=inj, max_retries=2,
                 backoff_base_s=0.001) as driver:
        stats = driver.run(got, timeout=T)
        health = driver.stats()["health"]
    assert _tokens(got) == _tokens(shared.want[:5])
    assert stats["retries"] == 1 and stats["failovers"] == 0
    assert inj.fired()[0]["step"] == 2
    assert health[0]["state"] == "healthy" and health[0]["failures"] == 1


def test_rebuilds_itself_when_no_survivors(shared):
    """R = 1, retries exhausted: the groups are held through the rebuild
    and served by the replacement; zero drops, bitwise, nothing prepared."""
    inj = FaultInjector([FaultSpec(kind="raise", replica=0, group=0,
                                   count=2)])
    got = _requests(shared.cfg, 4)
    with _driver(shared, 1, injector=inj, max_retries=1,
                 backoff_base_s=0.001) as driver:
        old = driver.engines[0]
        n0 = PREP_STATS["prepared"]
        stats = driver.run(got, timeout=T)
        builds = PREP_STATS["prepared"] - n0
        events = [e["event"] for e in driver.events()]
        assert driver.engines[0] is not old
    assert _tokens(got) == _tokens(shared.want[:4])
    assert stats["failovers"] == 1 and stats["rebuilds"] == 1
    assert builds == 0
    assert "drain_requeue" in events and "rebuilt" in events


def test_failover_requeues_onto_survivor(shared):
    """R = 2: replica 0 fails persistently; its queued + in-flight groups
    requeue onto replica 1, tokens bitwise, the rebuild prepares nothing."""
    inj = FaultInjector([FaultSpec(kind="raise", replica=0, group=0,
                                   count=9)])
    got = _requests(shared.cfg, 8)
    with _driver(shared, 2, model_parallel=1, injector=inj, max_retries=1,
                 backoff_base_s=0.001) as driver:
        n0 = PREP_STATS["prepared"]
        futs = driver.submit_many(got)
        done = _drain_results(driver, futs)
        builds = PREP_STATS["prepared"] - n0
        stats = driver.stats()
        events = driver.events()
    assert _tokens(got) == _tokens(shared.want[:8])
    assert all(len(r.out_tokens) == 3 for r in done)
    assert stats["requeued_requests"] > 0
    assert stats["failovers"] == 1 and stats["rebuilds"] == 1
    assert builds == 0
    assert [h["state"] for h in stats["health"]] == ["healthy", "healthy"]
    assert "drain_requeue" in [e["event"] for e in events]
    rebuilt = [e["recovery_s"] for e in events if e["event"] == "rebuilt"]
    assert rebuilt and rebuilt[0] > 0


def test_poisoned_slot_bitwise_recovery(shared):
    """R = 2 over 8 slots: slot 0 poisoned mid-decode of replica 0's second
    group; zero drops, the replica re-meshes on 2 of its 3 survivors
    (the largest divisor of its data width 4), tokens and the rebuilt
    replica's prefill logits bitwise one engine's, PREP_STATS flat."""
    inj = FaultInjector([FaultSpec(kind="poison", replica=0, group=1,
                                   after_decode_steps=2, device_ids=(0,))])
    got = _requests(shared.cfg, 12)
    with _driver(shared, 2, slots=8, model_parallel=1, injector=inj,
                 backoff_base_s=0.001) as driver:
        assert driver.meshes[0].shape == {"data": 4, "model": 1}
        driver.warmup(prompt_len=8, max_new=3)
        n0 = PREP_STATS["prepared"]
        futs = driver.submit_many(got)
        done = _drain_results(driver, futs)
        builds = PREP_STATS["prepared"] - n0
        stats = driver.stats()
        ids = driver.meshes[0].ids
        lg = _prefill_logits(driver.engines[0], shared.cfg)
    assert _tokens(got) == _tokens(shared.want)
    assert all(f.done() and len(r.out_tokens) == 3
               for f, r in zip(futs, done))
    assert builds == 0
    assert 0 not in ids and len(ids) == 2
    assert (lg == _prefill_logits(shared.engine, shared.cfg)).all()
    assert stats["failovers"] == 1 and stats["rebuilds"] == 1
    assert stats["retries"] == 0          # poison skips the retry budget
    assert [h["state"] for h in stats["health"]] == ["healthy", "healthy"]


def test_dead_replica_drains_to_survivors(shared):
    """Poisoning a replica's only slot leaves nothing to rebuild on: it goes
    dead, yet all its traffic completes on the survivor."""
    inj = FaultInjector([FaultSpec(kind="poison", replica=0, group=0,
                                   device_ids=(0,))])
    got = _requests(shared.cfg, 8)
    with _driver(shared, 2, injector=inj, backoff_base_s=0.001) as driver:
        _drain_results(driver, driver.submit_many(got))
        stats = driver.stats()
        with pytest.raises(RuntimeError, match="no schedulable"):
            driver.health[1].force("rebuilding")
            driver.submit_many(_requests(shared.cfg, 2))
        driver.health[1].force(None)
    assert _tokens(got) == _tokens(shared.want[:8])
    assert [h["state"] for h in stats["health"]] == ["dead", "healthy"]
    assert stats["rebuilds"] == 0
    assert stats["groups_per_replica"][1] == 4   # every group, requeued too


def test_kill_replica_mid_drain_zero_dropped(shared):
    """The chaos case at 8 slots: replica 0 killed mid-drain by persistent
    faults; zero dropped, every token bitwise, nothing prepared."""
    inj = FaultInjector([FaultSpec(kind="raise", replica=0, group=0,
                                   count=9)])
    got = _requests(shared.cfg, 8)
    with _driver(shared, 2, slots=8, model_parallel=1, injector=inj,
                 max_retries=1, backoff_base_s=0.001) as driver:
        n0 = PREP_STATS["prepared"]
        done = _drain_results(driver, driver.submit_many(got))
        stats = driver.stats()
        assert PREP_STATS["prepared"] == n0
    assert all(len(r.out_tokens) == 3 for r in done)
    assert _tokens(got) == _tokens(shared.want[:8])
    assert stats["failovers"] >= 1 and stats["requeued_requests"] > 0


def test_fleet_version_push_replay_and_rebuild_history(shared):
    """``calibrate()`` to v1, a no-drain push of v2 under traffic, a
    poisoned slot: the rebuilt replica holds the donor's versions and
    tables, a v1 request replays on it with the donor's bits, and the
    shared streaming calibrator is re-attached at the replica's gate."""
    cfg = dataclasses.replace(shared.cfg,
                              quant=shared.cfg.quant.replace(
                                  flush_target=1e-6))
    h = SimpleNamespace(cfg=cfg, params=shared.params)
    inj = FaultInjector([FaultSpec(kind="poison", replica=0, group=2,
                                   device_ids=(0,))])
    with _driver(h, 2, slots=4, model_parallel=1, injector=inj,
                 backoff_base_s=0.001) as driver:
        t1 = driver.calibrate()
        assert [e.table_version for e in driver.engines] == [1, 1]
        cal = driver.enable_streaming(seed=7, sample_period=2,
                                      sigma_rtol=0.0, min_calls=1)
        assert [e._stream_seed for e in driver.engines] == [7, 8]
        first = _requests(cfg, 4)
        driver.run(first, timeout=T)
        assert {r.table_version for r in first} == {1}
        futs = driver.submit_many(_requests(cfg, 4, rid0=10, seed=1))
        v2 = driver.apply_calibration(
            t1.refreshed([(s, v * 1.5) for s, v in t1.to_pairs()]))
        post = _requests(cfg, 4, rid0=20, seed=2)
        futs += driver.submit_many(post)
        done = _drain_results(driver, futs)
        stats = driver.stats()
        engines = list(driver.engines)
        rep0, st0 = engines[0].replay(first[0], group=first[:2])
        rep1, st1 = engines[1].replay(first[0], group=first[:2])
        routed, _ = driver.replay(first[0], group=first[:2])
        with pytest.raises(KeyError):
            driver.replay(post[0], version=42, group=post[:2])
        versions = [e.table_version for e in engines]
        tables = [{v: t.to_pairs() for v, t in e._tables.items()}
                  for e in engines]
        plans = [dict(e._flush_host) for e in engines]
        report = driver.maybe_refresh_calibration()
        events = [e["event"] for e in driver.events()]
    assert v2 == 2 and {r.table_version for r in post} == {2}
    assert all(len(r.out_tokens) == 3 for r in done)
    assert stats["failovers"] == 1 and stats["rebuilds"] == 1
    assert [h["state"] for h in stats["health"]] == ["healthy", "healthy"]
    assert versions == [2, 2]
    assert sorted(tables[0]) == [1, 2] and tables[0] == tables[1]
    assert plans[0] == plans[1]
    assert engines[0]._streaming is cal and engines[0]._stream_seed == 7
    assert rep0.out_tokens == rep1.out_tokens == routed.out_tokens \
        == first[0].out_tokens
    assert all((a == b).all() for a, b in zip(st0["logits"][first[0].rid],
                                               st1["logits"][first[0].rid]))
    assert report is not None
    assert [e.table_version for e in engines] == [3, 3]
    assert events[:1] == ["calib_swap"] and "rebuilt" in events
    assert events[-2:] == ["calib_swap", "calib_refresh"]


def test_continuous_fleet_matches_one_continuous_engine(shared):
    """R = 2 continuous replicas over ragged traffic: every request's tokens
    bitwise one continuous engine's (the slot engine's outputs do not
    depend on neighbours or admission)."""
    cfg = dataclasses.replace(
        shared.cfg, quant=tq.FP8_MGS_SERVE_PAGED.replace(block_k=32))
    rng = np.random.default_rng(7)
    plens, news = (5, 11, 3, 8, 14, 6, 9), (4, 3, 5, 2, 4, 3, 2)
    prompts = [rng.integers(1, cfg.vocab, n).astype(np.int32) for n in plens]

    def reqs():
        return [Request(rid=i, prompt=p.copy(), max_new_tokens=m)
                for i, (p, m) in enumerate(zip(prompts, news))]

    single = ContinuousBatchingEngine(cfg, slots=3, max_len=48,
                                      params=shared.params, device="cpu")
    single.warmup([8, 16], max_new=2)
    want = reqs()
    single.serve(want)
    with pytest.raises(ValueError, match="group-mode"):
        ReplicaServeDriver(cfg, 2, batch=3, max_len=48, continuous=True,
                           injector=FaultInjector(),
                           devices=virtual_devices("cpu", 2))
    got = reqs()
    with ReplicaServeDriver(cfg, 2, batch=3, max_len=48, continuous=True,
                            params=single.params,
                            devices=virtual_devices("cpu", 2)) as driver:
        driver.warmup(plen_buckets=[8, 16], max_new=2)
        futs = driver.submit_many(got[:4])
        futs += driver.submit_many(got[4:])
        done = _drain_results(driver, futs)
        stats = driver.stats()
    assert [r.rid for r in done] == list(range(len(got)))
    assert _tokens(got) == _tokens(want)
    assert stats["requests"] == len(got)
    assert stats["decode_tokens"] == sum(news)
    # the step count depends on scheduling; the traffic bounds it: each
    # request takes max_new - 1 steps on its replica, at most 3 a step
    need = sum(m - 1 for m in news)
    assert -(-need // 3) <= stats["decode_steps"] <= need


def test_fleet_tokens_match_the_reference_engine():
    """The fleet against the reference's ``ServeEngine``: reduced
    deepseek-7b from ``params_from_numpy`` weights at float32 compute;
    ``check_group_parity`` holds one port engine to the reference under
    the whole-model bar (tokens equal, logits within 5% / 1% of the scale),
    and R = 2 replicas on those planes give that engine's tokens."""
    import test_torch_model as tm
    eng, treqs = tm._check_group_parity(
        "deepseek-7b", tm._weights("deepseek-7b"), "packed", 0)
    got = [Request(rid=i, prompt=p, max_new_tokens=4)
           for i, p in enumerate(tm._prompts())]
    with ReplicaServeDriver(eng.cfg, 2, batch=2, max_len=16,
                            params=eng.params,
                            devices=virtual_devices("cpu", 2)) as driver:
        stats = driver.run(got, timeout=T)
    assert _tokens(got) == _tokens(treqs)
    assert stats["groups_per_replica"] == [1, 1]


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_cli_replicas_serve_on_cpu_slots(capsys):
    args = ["--arch", "deepseek-7b", "--reduced", "--batch", "2",
            "--n-requests", "4", "--prompt-len", "8", "--max-new", "3",
            "--quant", "fp8-mgs-serve-kv", "--device", "cpu"]
    serve_main(args)
    one = capsys.readouterr().out.splitlines()
    serve_main(args + ["--replicas", "2", "--scheduler", "least_loaded"])
    two = capsys.readouterr().out.splitlines()
    assert "'replicas': 2" in two[0] and "least_loaded" in two[0]
    assert two[1:] == one[1:]                     # the requests' tokens


@pytest.mark.parametrize("flags,reason", [
    (["--replicas", "2", "--no-deterministic"], "incompatible"),
    (["--no-deterministic"], "A12.2"),
    (["--mesh", "2x1"], "A12.2"),
    (["--replicas", "2", "--continuous", "--quant", "fp8-mgs-serve-paged"],
     "single-engine")])
def test_cli_refuses_what_the_fleet_does_not_serve(capsys, flags, reason):
    """What the fleet does not serve is refused; a mesh of ranks under the
    default unquantized model (raw weights) is served now, with the 1x1
    engine's tokens."""
    args = ["--reduced", "--device", "cpu"]
    if flags == ["--mesh", "2x1"]:
        serve_main(args)
        one = capsys.readouterr().out.splitlines()
        serve_main(args + flags)
        two = capsys.readouterr().out.splitlines()
        assert "'mesh': '2x1'" in two[0]
        assert two[1:] == one[1:]
        return
    with pytest.raises(SystemExit):
        serve_main(args + flags)
    assert reason in capsys.readouterr().err
