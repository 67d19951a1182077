"""The port's churn simulator (volcano_tpu_torch/sim), held against the
JAX package's (volcano_tpu/sim) on the CPU.

Every case of tests/test_sim.py runs against the port at
``device="cpu"``: event plumbing, determinism through each entry surface
(double run, dumped-trace replay, repro-bundle replay), fault injection,
and each invariant checker aimed at a deliberately broken fixture. Then
parity: the same seeded churn config (``_small_cfg``, every injection
on) through both packages' ``run_sim`` must give equal bind, outcome and
ledger fingerprints and equal counters. Last, the store checkpoint the
failover scenario's snapshot restart uses: ``encode_object`` equal to
the reference's byte for byte on every kind the port stores, and a
``save_store`` -> ``load_store`` round trip.

Tolerance: exact (sha256 fingerprints, counters, JSON bytes).
"""

import json
import os

import pytest

from volcano_tpu.apiserver import ObjectStore as RefStore
from volcano_tpu.apiserver import codec as ref_codec
from volcano_tpu.framework.solver import reset_breaker
from volcano_tpu.sim import engine as ref_engine
from volcano_tpu.sim.faults import FaultConfig as RefFaultConfig
from volcano_tpu.sim.workload import WorkloadConfig as RefWorkloadConfig
from volcano_tpu.utils import test_utils as ref_tu
from volcano_tpu_torch.apiserver import ObjectStore
from volcano_tpu_torch.apiserver import codec
from volcano_tpu_torch.apiserver.persistence import load_store, save_store
from volcano_tpu_torch.apiserver.store import KINDS
from volcano_tpu_torch.models import objects as obj
from volcano_tpu_torch.models.job_info import TaskStatus
from volcano_tpu_torch.sim.engine import SimConfig, SimEngine, run_sim
from volcano_tpu_torch.sim.events import (EventQueue, make_event,
                                          validate_event)
from volcano_tpu_torch.sim.faults import FaultConfig
from volcano_tpu_torch.sim.invariants import (CycleContext,
                                              check_gang_atomicity,
                                              check_no_orphans,
                                              check_node_accounting,
                                              check_queue_quota,
                                              check_snapshot_coherence)
from volcano_tpu_torch.sim.replay import load_bundle, replay_bundle
from volcano_tpu_torch.sim.workload import (WorkloadConfig, dump_trace,
                                            load_trace, synthesize_arrivals)
from volcano_tpu_torch.utils import test_utils as tu
from volcano_tpu_torch.utils.clock import FakeClock

# what the parity cases compare besides the three fingerprints
COUNTERS = ("resync_retries", "quarantined", "restarts", "fenced_writes",
            "divergence_repairs", "watch_drops", "cycle_modes",
            "quiet_cycles")


def _small_kw(seed, ticks, workload_cls, faults_cls):
    """tests/test_sim.py's fast churn config exercising every injection
    path, as keyword arguments of either package's SimConfig."""
    return dict(
        seed=seed, ticks=ticks, n_nodes=12, node_cpu="16", node_mem="32Gi",
        resident_jobs=4, resident_gang=4,
        workload=workload_cls(seed=seed, horizon_s=float(ticks),
                              arrival_rate=0.8,
                              duration_min_s=3.0, duration_max_s=10.0),
        faults=faults_cls(seed=seed, bind_fail_rate=0.05,
                          api_latency_s=0.001, flap_rate=0.08,
                          flap_down_s=3.0, kill_rate=0.03, kill_down_s=4.0,
                          storm_rate=0.05, storm_fraction=0.2),
        fail_rate=0.2)


def _small_cfg(seed=11, ticks=12, **kw):
    base = _small_kw(seed, ticks, WorkloadConfig, FaultConfig)
    base["device"] = "cpu"
    base.update(kw)
    return SimConfig(**base)


def _ref_small_cfg(seed=11, ticks=12):
    return ref_engine.SimConfig(**_small_kw(seed, ticks, RefWorkloadConfig,
                                            RefFaultConfig))


def fingerprints(r) -> dict:
    """The bind, outcome and ledger fingerprints and the counters of a
    SimResult of either package."""
    out = {"bind": r.bind_fingerprint(), "outcome": r.outcome_fingerprint(),
           "ledger": r.ledger.get("fingerprint")}
    out.update({k: getattr(r, k) for k in COUNTERS})
    return out


# -- event plumbing ---------------------------------------------------------


def test_event_queue_orders_by_time_then_insertion():
    q = EventQueue()
    q.push(make_event(2.0, "b"))
    q.push(make_event(1.0, "a"))
    q.push(make_event(2.0, "c"))        # same time as "b": insertion order
    assert [e.kind for e in q.pop_until(2.0)] == ["a", "b", "c"]
    assert len(q) == 0


def test_validate_event_rejects_garbage():
    for bad in ({}, {"at": 1.0}, {"kind": "x"}, {"at": "z", "kind": "x"},
                {"at": 1.0, "kind": ""}):
        with pytest.raises(ValueError):
            validate_event(bad)


def test_trace_io_round_trip(tmp_path):
    events = synthesize_arrivals(WorkloadConfig(seed=3, horizon_s=30.0))
    path = str(tmp_path / "trace.jsonl")
    dump_trace(path, events)
    loaded = load_trace(path)
    assert loaded == events


# -- determinism ------------------------------------------------------------


def test_same_seed_bit_identical_binds():
    r1 = run_sim(_small_cfg())
    r2 = run_sim(_small_cfg())
    assert r1.bind_sequence, "no binds — churn config too hostile"
    assert r1.bind_sequence == r2.bind_sequence
    assert r1.bind_fingerprint() == r2.bind_fingerprint()
    assert not r1.violations and not r2.violations


def test_different_seed_diverges():
    r1 = run_sim(_small_cfg(seed=11))
    r2 = run_sim(_small_cfg(seed=12))
    # seeds drive arrivals AND fault coins; identical output would mean
    # the seed is not actually plumbed through
    assert r1.bind_fingerprint() != r2.bind_fingerprint()


def test_trace_replay_round_trip(tmp_path):
    """A dumped applied-event stream replayed via trace_path reproduces
    the bind sequence bit-identically (generators out of the loop)."""
    r1 = run_sim(_small_cfg())
    path = str(tmp_path / "applied.jsonl")
    dump_trace(path, r1.events_applied)
    cfg = _small_cfg()
    cfg.trace_path = path
    r2 = run_sim(cfg)
    assert r2.bind_sequence == r1.bind_sequence


# -- fault injection smoke --------------------------------------------------


def test_fault_injection_smoke():
    """Bind failures, node flaps/kills and evict storms all fire, the
    cluster keeps making progress, and the invariant catalog stays
    clean throughout."""
    eng = SimEngine(_small_cfg(ticks=16))
    r = eng.run()
    kinds = {e.kind for e in r.events_applied}
    assert "job_arrival" in kinds
    assert "node_drain" in kinds or "node_kill" in kinds
    assert "evict_storm" in kinds
    assert eng.binder.failed_keys, "bind-failure injection never fired"
    assert r.bind_sequence, "no binds under churn"
    assert not r.violations
    # ticks recorded for every cycle, with monotonically advancing vtime
    times = [t.vtime for t in r.ticks]
    assert times == sorted(times) and len(r.ticks) == 16
    # the port's tick record also carries the flush and the audit
    assert all(t.flush_ms >= 0.0 and t.audit_ms > 0.0 for t in r.ticks)


def test_api_latency_charges_virtual_clock():
    cfg = _small_cfg(ticks=4)
    cfg.faults.api_latency_s = 0.5
    eng = SimEngine(cfg)
    r = eng.run()
    # each bind slept 0.5 virtual seconds: vtime must exceed ticks * tick_s
    assert r.ticks[-1].vtime > 4.0 + 0.5 * min(4, len(r.bind_sequence))


# -- invariant checkers vs deliberately-broken fixtures ---------------------


@pytest.fixture()
def settled_engine():
    """A small run with churn disabled: clean state to corrupt."""
    cfg = _small_cfg(ticks=4, fail_rate=0.0,
                     faults=FaultConfig(seed=1),
                     workload=WorkloadConfig(seed=1, horizon_s=4.0,
                                             arrival_rate=0.5))
    eng = SimEngine(cfg)
    r = eng.run()
    assert not r.violations
    return eng


def _ctx(eng, **kw):
    return CycleContext(store=eng.store, cache=eng.cache, **kw)


def test_node_accounting_catches_overcommit(settled_engine):
    eng = settled_engine
    node = next(n for n in eng.cache.nodes.values() if n.tasks)
    node.idle.milli_cpu = -5000.0        # forged overcommit
    out = check_node_accounting(_ctx(eng))
    assert any("overcommitted" in v.detail or "idle" in v.detail
               for v in out), out


def test_node_accounting_catches_used_drift(settled_engine):
    eng = settled_engine
    node = next(n for n in eng.cache.nodes.values() if n.tasks)
    node.used.milli_cpu += 7000.0        # used no longer matches residents
    out = check_node_accounting(_ctx(eng))
    assert any("drifted" in v.detail for v in out), out


def test_gang_atomicity_catches_partial_gang(settled_engine):
    eng = settled_engine
    jkey, job = next((k, j) for k, j in eng.cache.jobs.items()
                     if j.pod_group is not None and j.min_available >= 2)
    # forge a partial gang: exactly one task allocated, rest pending
    tasks = list(job.tasks.values())
    job.task_status_index.clear()
    job.task_status_index[TaskStatus.Bound] = {tasks[0].uid: tasks[0]}
    job.task_status_index[TaskStatus.Pending] = {
        t.uid: t for t in tasks[1:]}
    out = check_gang_atomicity(_ctx(eng))
    assert any(jkey in v.detail for v in out), out
    # ...and the exemptions hold: churn-dirty or previously-ready gangs
    # draining down are not violations
    assert not check_gang_atomicity(_ctx(eng, dirty_jobs={jkey}))
    assert not check_gang_atomicity(_ctx(eng, ever_ready={jkey}))


def test_queue_quota_catches_fresh_overshoot(settled_engine):
    eng = settled_engine
    q = next(iter(eng.cache.queues.values()))
    # forge a capability far below what is already allocated
    q.queue.spec.capability = {"cpu": "1m"}
    out = check_queue_quota(_ctx(eng))
    assert any(q.name in v.detail for v in out), out
    # grandfathered queues (already over before the cycle) are exempt
    assert not check_queue_quota(_ctx(eng, queues_over_before={q.name}))


def test_queue_quota_partial_capability_constrains_named_dims_only(
        settled_engine):
    """A capability naming only cpu constrains only cpu: reading the
    absent memory dim as memory=0 would mark the queue over capability
    from tick 0 and grandfather it out of the check forever."""
    from volcano_tpu_torch.sim.invariants import queues_over_capability
    eng = settled_engine
    q = next(iter(eng.cache.queues.values()))
    # generous cpu-only cap: allocated memory alone must NOT trip it
    q.queue.spec.capability = {"cpu": "100000"}
    assert q.name not in queues_over_capability(eng.cache)
    # tight cpu-only cap: cpu overshoot still detected
    q.queue.spec.capability = {"cpu": "1m"}
    assert q.name in queues_over_capability(eng.cache)


def test_no_orphans_catches_pod_on_missing_node(settled_engine):
    eng = settled_engine
    pod = next(p for p in eng.store.list_refs("pods") if p.spec.node_name)
    pod.spec.node_name = "node-does-not-exist"
    out = check_no_orphans(_ctx(eng))
    assert any("gone from the store" in v.detail for v in out), out


def test_no_orphans_catches_unaccounted_pod(settled_engine):
    eng = settled_engine
    node = next(n for n in eng.cache.nodes.values() if n.tasks)
    key = next(iter(node.tasks))
    del node.tasks[key]                  # node no longer accounts for it
    out = check_no_orphans(_ctx(eng))
    assert any("not accounted" in v.detail for v in out), out


def test_snapshot_coherence_catches_idle_drift(settled_engine):
    eng = settled_engine
    snap = eng.cache.snapshot()
    name = next(n for n in snap.nodes)
    snap.nodes[name].idle.milli_cpu += 3000.0
    out = check_snapshot_coherence(_ctx(eng, snapshot=snap))
    assert any("drifted" in v.detail and name in v.detail
               for v in out), out


def test_snapshot_coherence_catches_missing_node(settled_engine):
    eng = settled_engine
    snap = eng.cache.snapshot()
    name = next(n for n in snap.nodes)
    del snap.nodes[name]
    out = check_snapshot_coherence(_ctx(eng, snapshot=snap))
    assert any("missing from" in v.detail for v in out), out


# -- violation -> repro bundle -> replay ------------------------------------


def _sabotage_after(eng, monkeypatch, ticks_done):
    """Corrupt a node's accounting after ``ticks_done`` recorded ticks,
    through the kubelet step, so the checker fires mid-run."""
    orig = eng._kubelet_step

    def sabotage():
        orig()
        if len(eng.result.ticks) >= ticks_done:
            for n in eng.cache.nodes.values():
                if n.tasks:
                    n.idle.milli_cpu = -1e6
                    break
    monkeypatch.setattr(eng, "_kubelet_step", sabotage)


def test_violation_dumps_replayable_bundle(tmp_path, monkeypatch):
    """A run that violates an invariant writes a repro bundle; replaying
    the bundle reproduces the same bind prefix (the violation itself is
    engine-state corruption the replay does not re-forge, so only the
    determinism half is asserted)."""
    cfg = _small_cfg(ticks=6)
    cfg.repro_dir = str(tmp_path)
    eng = SimEngine(cfg)
    _sabotage_after(eng, monkeypatch, 2)
    r = eng.run()
    assert r.violations
    assert r.repro_paths, "violation did not produce a repro bundle"
    bundle_dir = r.repro_paths[0]
    bundle = load_bundle(bundle_dir)
    assert bundle["seed"] == cfg.seed
    assert bundle["config"]["device"] == "cpu"
    assert os.path.exists(os.path.join(bundle_dir, "events.jsonl"))
    assert bundle["violations"]
    # the bundle's flight-recorder trace rides along when available
    trace_path = os.path.join(bundle_dir, "trace.json")
    if os.path.exists(trace_path):
        with open(trace_path) as f:
            assert "traceEvents" in json.load(f)
    # replay (uncorrupted) runs the same config prefix deterministically
    rep = replay_bundle(bundle_dir, use_trace=True, device="cpu")
    assert rep.bind_sequence == r.bind_sequence[:len(rep.bind_sequence)]
    assert rep.bind_sequence


def test_stop_on_violation_halts_run(tmp_path, monkeypatch):
    cfg = _small_cfg(ticks=10)
    cfg.repro_dir = str(tmp_path)
    eng = SimEngine(cfg)
    _sabotage_after(eng, monkeypatch, 1)
    r = eng.run()
    assert r.violations
    assert len(r.ticks) < 10             # halted before the horizon


# -- parity with the reference's simulator ----------------------------------


@pytest.mark.parametrize("seed", [3, 5, 11, 12, 17, 29])
def test_run_sim_matches_reference(seed):
    """Both packages' run_sim on one seeded churn config with every
    injection on: equal fingerprints and counters, no violation."""
    reset_breaker()
    ref = ref_engine.run_sim(_ref_small_cfg(seed=seed))
    port = run_sim(_small_cfg(seed=seed))
    assert not ref.violations and not port.violations
    assert port.bind_sequence == ref.bind_sequence
    assert port.evict_sequence == ref.evict_sequence
    assert fingerprints(port) == fingerprints(ref)
    assert [(t.vtime, t.events, t.new_binds, t.pods, t.nodes)
            for t in port.ticks] == \
        [(t.vtime, t.events, t.new_binds, t.pods, t.nodes)
         for t in ref.ticks]


def test_sim_config_round_trips_with_device():
    cfg = _small_cfg()
    back = SimConfig.from_dict(json.loads(json.dumps(cfg.to_dict())))
    assert back == cfg and back.device == "cpu"


# -- the store checkpoint ---------------------------------------------------


def _populate(store, t, kw):
    """One object of each of the main kinds, made by the ``build_*``
    helpers of package ``t``'s test_utils, with nested types, quantities
    and labels, and uids fixed (a generated uid counts the objects the
    process made before)."""
    objs = [("queues", t.build_queue("q1", weight=3,
                                     capability={"cpu": "64"})),
            ("nodes", t.build_node(
                "n0", {"cpu": "32", "memory": "64Gi", "pods": "110"},
                labels={"topology.kubernetes.io/zone": "z0"})),
            ("podgroups", t.build_pod_group(
                "pg0", "ns1", "q1", 2, phase="Inqueue",
                priority_class="hi"))]
    objs += [("pods", t.build_pod(
        "ns1", f"pg0-{i}", "n0" if i else "", "Pending",
        {"cpu": "2", "memory": "4Gi"}, groupname="pg0",
        labels={"app": "a"}, priority=7)) for i in range(2)]
    for kind, o in objs:
        o.metadata.uid = f"uid-{kind}-{o.metadata.name}"
        store.create(kind, o, **kw)
    return store


def _other_kinds(o):
    """One object each of the remaining kinds, from objects module ``o``."""
    meta = o.ObjectMeta
    return [
        ("priorityclasses", o.PriorityClass(metadata=meta(name="hi"),
                                            value=100)),
        ("resourcequotas", o.ResourceQuota(
            metadata=meta(name="rq", namespace="ns1"))),
        ("numatopologies", o.Numatopology(metadata=meta(name="n0"))),
        ("configmaps", o.ConfigMap(metadata=meta(name="cm",
                                                 namespace="ns1"),
                                   data={"k": "v"})),
        ("persistentvolumeclaims", o.PersistentVolumeClaim(
            metadata=meta(name="c0", namespace="ns1"))),
        ("persistentvolumes", o.PersistentVolume(metadata=meta(name="v0"))),
        ("jobs", o.Job(
            metadata=meta(name="j0", namespace="ns1"),
            spec=o.JobSpec(min_available=2, tasks=[o.TaskSpec(
                name="t", replicas=2, policies=[o.LifecyclePolicy(
                    event=o.JobEvent.POD_FAILED,
                    action=o.JobAction.RESTART_TASK)])]))),
        ("commands", o.Command(metadata=meta(name="c0", namespace="ns1"),
                               action=o.JobAction.ABORT_JOB,
                               target_name="j0")),
        ("services", o.Service(metadata=meta(name="s0", namespace="ns1"),
                               selector={"a": "b"}, ports=[22])),
        ("secrets", o.Secret(metadata=meta(name="k0", namespace="ns1"),
                             data={"id_rsa": b"\x00\x01key"})),
        ("networkpolicies", o.NetworkPolicy(
            metadata=meta(name="np0", namespace="ns1"),
            pod_selector={"a": "b"}, ingress_from_selector={"a": "b"})),
    ]


def test_encode_object_matches_reference_byte_for_byte():
    """Every kind the port stores encodes to the reference's JSON bytes,
    and decodes back to an equal object."""
    from volcano_tpu.models import objects as ref_obj
    from volcano_tpu.utils.clock import FakeClock as RefClock
    ref = _populate(RefStore(clock=RefClock(start=1.0)), ref_tu,
                    {"skip_admission": True})
    port = _populate(ObjectStore(clock=FakeClock(start=1.0)), tu, {})
    for (kind, r), (_, p) in zip(_other_kinds(ref_obj), _other_kinds(obj)):
        p.metadata.uid = r.metadata.uid = f"uid-{kind}"
        ref.create(kind, r, skip_admission=True)
        port.create(kind, p)
    assert set(codec.KIND_TYPES) == KINDS
    for kind in sorted(codec.KIND_TYPES):
        rs = sorted(ref.list(kind), key=lambda o: o.metadata.name)
        ps = sorted(port.list(kind), key=lambda o: o.metadata.name)
        assert len(ps) == len(rs) >= 1, kind
        for r, p in zip(rs, ps):
            want = json.dumps(ref_codec.encode_object(kind, r),
                              sort_keys=False)
            got = json.dumps(codec.encode_object(kind, p), sort_keys=False)
            assert got == want, kind
            assert codec.decode_object(kind, json.loads(got)) == p, kind


def _checkpoint(tmp_path, name, store, save, load):
    """Save ``store`` and load it into a fresh store of its package;
    returns (restored, count, payload)."""
    path = str(tmp_path / name)
    count = save(store, path)
    with open(path) as f:
        payload = json.load(f)
    restored, n = load(path)
    assert n == count
    return restored, count, payload


def test_save_load_round_trip_matches_reference(tmp_path):
    """One store of every kind per package, a raised fence floor, saved
    and restored: the snapshot files carry the same objects, allocation
    counter and fence floor as the reference's, and the restored stores
    hold the same objects (their restart-local rvs included), anchor the
    sequencer at the saved counter with an empty journal and leave the
    floor to the next lease acquisition, as the reference does."""
    from volcano_tpu.apiserver import persistence as ref_persistence
    from volcano_tpu.models import objects as ref_obj
    from volcano_tpu.utils.clock import FakeClock as RefClock
    ref = _populate(RefStore(clock=RefClock(start=1.0)), ref_tu,
                    {"skip_admission": True})
    port = _populate(ObjectStore(clock=FakeClock(start=1.0)), tu, {})
    for (kind, r), (_, p) in zip(_other_kinds(ref_obj), _other_kinds(obj)):
        p.metadata.uid = r.metadata.uid = f"uid-{kind}"
        ref.create(kind, r, skip_admission=True)
        port.create(kind, p)
    for s in (ref, port):
        s.advance_fence(4)
    r_back, r_count, r_payload = _checkpoint(
        tmp_path, "ref.json", ref, ref_persistence.save_store,
        ref_persistence.load_store)
    p_back, p_count, p_payload = _checkpoint(
        tmp_path, "port.json", port, save_store, load_store)
    assert p_count == r_count == sum(len(port.list(k)) for k in KINDS)
    # the reference's store has kinds the port's lacks, all empty here
    r_objects = r_payload.pop("objects")
    p_objects = p_payload.pop("objects")
    assert p_payload == r_payload
    assert p_objects == {k: v for k, v in r_objects.items() if k in KINDS}
    assert not any(v for k, v in r_objects.items() if k not in KINDS)
    assert p_payload["fence_floor"] == 4
    assert p_payload["resource_version"] == port._rv
    for kind in sorted(KINDS):
        want = {ref.key_of(kind, o): ref_codec.encode_object(kind, o)
                for o in r_back.list(kind)}
        got = {port.key_of(kind, o): codec.encode_object(kind, o)
               for o in p_back.list(kind)}
        assert got == want, kind
        # everything but the restart-local rv survives the round trip
        for o in port.list(kind):
            back = p_back.get(kind, o.metadata.name, o.metadata.namespace)
            back.metadata.resource_version = o.metadata.resource_version
            assert back == o, kind
    assert p_back.current_rv() == p_back._rv == port._rv == r_back._rv
    assert not p_back._journal and not p_back._journal_parked
    events, _, resync = p_back.events_since(1, timeout=0.05)
    assert resync and not events
    assert p_back.fence_floor() == r_back.fence_floor() == 0
    # new writes journal contiguously from the anchor
    q = p_back.get("queues", "q1")
    q.spec.weight = 9
    p_back.update("queues", q)
    events, rv, resync = p_back.events_since(port._rv, timeout=1.0)
    assert not resync and [e[0] for e in events] == [port._rv + 1]


def test_snapshot_during_inflight_reservation_restores_consistent(tmp_path):
    """tests/test_failover.py's TestParkedJournalRestore on the port's
    store: a snapshot taken while a sharded bind has rvs reserved but
    unpublished restores with the sequencer re-anchored."""
    store = _populate(ObjectStore(), tu, {})
    pre_tail = store.current_rv()
    with store._lock:
        store._rv += 4
        store._inflight["pods"].update({"ns1/pg0-0", "ns1/pg0-1"})
        q = store.get("queues", "q1")
        q.spec.weight = 7
        store._rv += 1
        q.metadata.resource_version = store._rv
        store._objects["queues"]["q1"] = q
        store._journal_append_locked(store._rv, "MODIFIED", "queues", q)
    assert store._journal_parked
    assert store.current_rv() == pre_tail
    alloc = store._rv
    path = str(tmp_path / "mid-flight.json")
    save_store(store, path)
    with store._lock:            # release the frozen reservation
        store._inflight["pods"].clear()
    restored, _ = load_store(path)
    assert restored.current_rv() == restored._rv >= alloc
    assert not restored._journal_parked
    assert not restored._inflight["pods"]
    assert restored.get("queues", "q1").spec.weight == 7


def test_restored_store_takes_the_native_bind_clone(tmp_path, monkeypatch):
    """Pods decoded by load_store go through the sharded bind's native
    clone like created ones: a bulk bind above the serial threshold on
    the restored store clones every shard natively (no hand-back to the
    Python loop) and binds every pod."""
    from volcano_tpu_torch.models.job_info import _fastmodel
    fm = _fastmodel()
    native = fm.bind_clone_pods
    calls = []

    def tap(pods, hosts, rv_start):
        out = native(pods, hosts, rv_start)
        calls.append(out is not None)
        return out
    monkeypatch.setattr(fm, "bind_clone_pods", tap)
    store = ObjectStore()
    store.create("nodes", tu.build_node("n0", {"cpu": "10000",
                                               "memory": "10000Gi",
                                               "pods": "100000"}))
    n = ObjectStore.SHARD_SERIAL_MAX + 8
    for i in range(n):
        store.create("pods", tu.build_pod("ns", f"p-{i}", "", "Pending",
                                          {"cpu": "1", "memory": "1Gi"}))
    path = str(tmp_path / "snap.json")
    save_store(store, path)
    restored, _ = load_store(path)
    restored.SHARD_TARGET = 128          # several shards for 520 pods
    assert ObjectStore.NATIVE_PUBLISH
    pairs, missing = restored.bind_pods(
        [(p.metadata.name, p.metadata.namespace, "n0")
         for p in restored.list_refs("pods")])
    assert len(pairs) == n and not missing
    assert calls and all(calls)
    assert all(p.spec.node_name == "n0" for p in restored.list("pods"))
    assert restored.current_rv() == restored._rv


# -- the simulator-driven incremental-vs-full equivalence -------------------


def _churn_kw(kind, workload_cls, faults_cls):
    """tests/test_incremental.py's _churn_cfg for either package."""
    base = dict(seed=11, ticks=40, tick_s=1.0, n_nodes=32,
                node_cpu="16", node_mem="32Gi", repro_dir=None)
    if kind == "quiet":
        return dict(base, resident_jobs=10, resident_gang=4,
                    workload=workload_cls(seed=11, horizon_s=5.0,
                                          arrival_rate=0.4),
                    faults=faults_cls(seed=11))
    if kind == "bursty":
        return dict(base, resident_jobs=24, resident_gang=8,
                    workload=workload_cls(seed=11, horizon_s=30.0,
                                          arrival_rate=1.0),
                    faults=faults_cls(seed=11), fail_rate=0.1)
    return dict(base, resident_jobs=12, resident_gang=4,   # node-flap
                workload=workload_cls(seed=11, horizon_s=30.0,
                                      arrival_rate=0.4),
                faults=faults_cls(seed=11, flap_rate=0.08,
                                  flap_down_s=5.0),
                fail_rate=0.05)


@pytest.mark.parametrize("kind", ["quiet", "bursty", "flap"])
def test_incremental_vs_full_equivalence(kind):
    """tests/test_incremental.py::test_incremental_vs_full_equivalence on
    the port: the persistent patched snapshot against a full rebuild
    every tick, bind for bind and ledger for ledger, per churn regime;
    and both equal to the reference's incremental run."""
    r_incr = run_sim(SimConfig(
        **_churn_kw(kind, WorkloadConfig, FaultConfig), incremental=True,
        device="cpu"))
    r_full = run_sim(SimConfig(
        **_churn_kw(kind, WorkloadConfig, FaultConfig), incremental=False,
        device="cpu"))
    assert not r_incr.violations and not r_full.violations
    assert r_incr.cycle_modes.get("incremental", 0) > 0
    assert r_full.cycle_modes == {"legacy": 40}
    assert r_incr.bind_fingerprint() == r_full.bind_fingerprint()
    assert r_incr.ledger.get("fingerprint") == \
        r_full.ledger.get("fingerprint")
    if kind == "quiet":
        assert r_incr.quiet_cycles > 0
    reset_breaker()
    ref = ref_engine.run_sim(ref_engine.SimConfig(
        **_churn_kw(kind, RefWorkloadConfig, RefFaultConfig),
        incremental=True))
    assert fingerprints(r_incr) == fingerprints(ref)


def test_kept_gangs_without_new_placements_match_reference():
    """A cycle whose solve places nothing while elastic gangs stay kept
    (ready, with pending tasks the cluster cannot hold): the deferred
    staging has no per-job totals then and must take the per-job path,
    as the reference's does (the explain gate's shape, seed 47, whose
    second tick raised AttributeError before)."""
    from volcano_tpu.sim import cli as ref_cli
    from volcano_tpu_torch.sim import cli as port_cli
    reset_breaker()
    ref_cfg = ref_cli.constraint_config(seed=47, ticks=6, nodes=16)
    port_cfg = port_cli.constraint_config(seed=47, ticks=6, nodes=16,
                                          device="cpu")
    ref_cfg.repro_dir = port_cfg.repro_dir = None
    ref = ref_engine.run_sim(ref_cfg)
    port = run_sim(port_cfg)
    assert not ref.violations and not port.violations
    assert port.evict_sequence == ref.evict_sequence
    assert fingerprints(port) == fingerprints(ref)


# -- the CLI: replay, explain, the device ------------------------------------


def test_replay_verb_reproduces_reference_bundle(tmp_path, monkeypatch):
    """A forced violation's bundle from each package, replayed through
    each package's ``replay`` verb (the port's also on the reference's
    bundle): the same bind prefix and fingerprints, exit code 0 (the
    uncorrupted replay is clean)."""
    from tests.test_torch_sim_gates import run_verb, summary_facts
    bundles = {}
    for side, make in (("ref", lambda: ref_engine.SimEngine(
                            _ref_small_cfg(ticks=6))),
                       ("port", lambda: SimEngine(_small_cfg(ticks=6)))):
        reset_breaker()
        eng = make()
        eng.cfg.repro_dir = str(tmp_path / side)
        _sabotage_after(eng, monkeypatch, 2)
        r = eng.run()
        assert r.violations and r.repro_paths
        bundles[side] = r.repro_paths[0]
    ref_rc, ref = run_verb("ref", ["replay", "--bundle", bundles["ref"],
                                   "--use-trace"])
    assert ref_rc == 0 and not ref["reproduced"] and ref["binds"]
    for bundle in (bundles["port"], bundles["ref"]):
        rc, port = run_verb("port", ["replay", "--bundle", bundle,
                                     "--use-trace"])
        assert rc == 0 and not port["reproduced"]
        assert port["original_violations"] == ref["original_violations"]
        assert summary_facts(port) == summary_facts(ref)


def test_explain_gate_matches_reference():
    from tests.test_torch_sim_gates import hold_verb
    ref, port = hold_verb(["explain", "--ticks", "40"], "explain")
    # the explain fingerprints differ by design: a record names its
    # kernel's route, and its float scores agree within 1e-6
    # (tests/test_torch_explain.py holds the records field by field)
    assert port["records"] == ref["records"]
    assert port["victim_records"] == ref["victim_records"]


def test_cli_needs_a_device_or_cpu(monkeypatch, capsys):
    """Without a GPU a verb exits non-zero unless given ``--device cpu``
    (federation's in-process gate too); the verb whose layer is not
    ported exits 2 naming where it waits, and the host-only durability
    gate takes no device."""
    import torch

    from volcano_tpu_torch.sim import cli
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["smoke"]) == 2
    assert "no CUDA device" in capsys.readouterr().err
    assert cli.main(["mesh", "--ticks", "3"]) == 2
    assert "ROADMAP item 13" in capsys.readouterr().err
    assert cli.main(["federation", "--ticks", "3"]) == 2
    assert "no CUDA device" in capsys.readouterr().err
    assert set(cli.WAITING) == {"mesh"}
    with pytest.raises(SystemExit):
        cli.main(["durability", "--device", "cpu"])
    with pytest.raises(SystemExit):
        cli.main(["smoke", "--device", "cpu", "--no-such-flag"])
