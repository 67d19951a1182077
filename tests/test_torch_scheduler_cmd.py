"""The scheduler binary of the port (``cmd/scheduler.py``) and what it
drives, held against the JAX package: leader election
(tests/test_infra.py::TestLeaderElection, tests/test_failover.py::
TestElectorFencing and ::TestStandby), out-of-tree plugin loading
(tests/test_infra.py::TestDynamicPluginLoading, with a plugin that
subclasses the port's ``Plugin``), the conf hot reload
(tests/test_concurrency.py::test_conf_hot_reload_under_fire, and the
file watcher), the flags, ``run_scheduler`` with ``--leader-elect
--device cpu`` binding as the reference's ``run_scheduler`` on one seeded
store, and ``--server`` failing.

Election cases run the same steps on each package's store, elector and
FakeClock and must give the same callback order, leadership, tokens and
fence floors. Every thread a test starts (electors, watchers, scheduler
loops, cache executors) is stopped by it. Tolerance: exact.
"""

import argparse
import random
import textwrap
import threading
import time

import pytest
import torch

import volcano_tpu.cmd.scheduler as ref_cmd
import volcano_tpu.scheduler as ref_scheduler_mod
import volcano_tpu.trace.tracer as ref_tracer
import volcano_tpu_torch.cmd.scheduler as port_cmd
import volcano_tpu_torch.scheduler as port_scheduler_mod
import volcano_tpu_torch.trace.tracer as port_tracer
from tests.test_torch_cycle import PORT, REF, conf, make_spec, populate
from volcano_tpu.apiserver.store import FencedError as RefFenced
from volcano_tpu.trace.pending import REASON_NOT_LEADER as REF_NOT_LEADER
from volcano_tpu.utils.clock import FakeClock as RefClock
from volcano_tpu.utils.leaderelection import FENCE_KEY as REF_FENCE_KEY
from volcano_tpu.utils.leaderelection import LeaderElector as RefElector
from volcano_tpu_torch.apiserver.store import FencedError as PortFenced
from volcano_tpu_torch.framework import registry as port_registry
from volcano_tpu_torch.trace.pending import \
    REASON_NOT_LEADER as PORT_NOT_LEADER
from volcano_tpu_torch.utils.clock import FakeClock as PortClock
from volcano_tpu_torch.utils.filewatcher import FileWatcher
from volcano_tpu_torch.utils.leaderelection import FENCE_KEY as PORT_FENCE_KEY
from volcano_tpu_torch.utils.leaderelection import \
    LeaderElector as PortElector

JOIN_S = 10.0

CONF = """
actions: "enqueue, allocate"
tiers:
- plugins:
  - name: priority
  - name: gang
- plugins:
  - name: drf
  - name: predicates
  - name: proportion
  - name: nodeorder
  - name: binpack
"""


class Side:
    def __init__(self, name, pkg, clock, elector, fence_key, fenced,
                 not_leader, tracer, cmd, scheduler_mod, update_kw):
        self.name, self.pkg, self.Clock = name, pkg, clock
        self.Elector, self.FENCE_KEY, self.Fenced = elector, fence_key, fenced
        self.NOT_LEADER, self.tracer, self.cmd = not_leader, tracer, cmd
        self.scheduler_mod = scheduler_mod
        # the reference's store runs admission on a plain update
        self.update_kw = update_kw

    def store(self, clock=None):
        return self.pkg.Store(clock=clock) if clock is not None \
            else self.pkg.Store()


SIDES = {
    "ref": Side("ref", REF, RefClock, RefElector, REF_FENCE_KEY, RefFenced,
                REF_NOT_LEADER, ref_tracer, ref_cmd, ref_scheduler_mod,
                {"skip_admission": True}),
    "port": Side("port", PORT, PortClock, PortElector, PORT_FENCE_KEY,
                 PortFenced, PORT_NOT_LEADER, port_tracer, port_cmd,
                 port_scheduler_mod, {}),
}


def elector(side, store, ident, events, clock, lease=15.0):
    return side.Elector(
        store, ident, lease_name="vc-test", lease_duration=lease,
        clock=clock,
        on_started_leading=lambda: events.append(f"{ident}:start"),
        on_stopped_leading=lambda: events.append(f"{ident}:stop"),
        on_new_leader=lambda who: events.append(f"{ident}:sees:{who}"))


def on_both(case):
    """Run ``case(side)`` on both packages; what it returns must be
    equal."""
    ref = case(SIDES["ref"])
    port = case(SIDES["port"])
    assert port == ref
    return port


def pending_pod(side, store):
    tu = side.pkg.tu
    return store.create("pods", tu.build_pod(
        "ns1", "p", "", "Pending", tu.build_resource_list("1", "1Gi"),
        "pg"))


# -- tests/test_infra.py::TestLeaderElection -----------------------------------

def first_candidate_wins(side):
    clock = side.Clock(0.0)
    store = side.store(clock)
    events = []
    a = elector(side, store, "a", events, clock)
    b = elector(side, store, "b", events, clock)
    assert a.step() is True
    assert b.step() is False
    assert "a:start" in events and "b:sees:a" in events
    return events


def lease_renewal(side):
    clock = side.Clock(0.0)
    store = side.store(clock)
    events = []
    a = elector(side, store, "a", events, clock)
    b = elector(side, store, "b", events, clock)
    a.step()
    for _ in range(5):
        clock.advance(10)   # inside the 15 s lease each time
        assert a.step() is True
        assert b.step() is False
    return events, a.fencing_token, store.fence_floor()


def takeover_after_expiry(side):
    clock = side.Clock(0.0)
    store = side.store(clock)
    events = []
    a = elector(side, store, "a", events, clock)
    b = elector(side, store, "b", events, clock)
    a.step()
    clock.advance(20)   # a went silent past the lease
    assert b.step() is True
    assert "b:start" in events
    assert a.step() is False
    assert "a:stop" in events
    return events, b.fencing_token


def release_hands_over(side):
    clock = side.Clock(0.0)
    store = side.store(clock)
    events = []
    a = elector(side, store, "a", events, clock)
    b = elector(side, store, "b", events, clock)
    a.step()
    a.release()
    clock.advance(1)   # well inside the lease
    assert b.step() is True
    return events, b.fencing_token


@pytest.mark.parametrize("case", [first_candidate_wins, lease_renewal,
                                  takeover_after_expiry, release_hands_over],
                         ids=lambda c: c.__name__)
def test_leader_election_matches_reference(case):
    on_both(case)


# -- tests/test_failover.py::TestElectorFencing ---------------------------------

def token_bumps(side):
    clock = side.Clock(0.0)
    store = side.store(clock)
    events = []
    a = elector(side, store, "a", events, clock)
    b = elector(side, store, "b", events, clock)
    assert a.step() is True
    assert (a.fencing_token, store.fence_floor()) == (1, 1)
    a.release()
    assert b.step() is True
    assert (b.fencing_token, store.fence_floor()) == (2, 2)
    clock.advance(5)   # a renewal keeps the token and the floor
    assert b.step() is True
    assert b.fencing_token == 2
    lease = store.get("configmaps", "vc-test", "volcano-system")
    assert lease.data[side.FENCE_KEY] == "2"
    return events, dict(lease.data)


def restarted_incarnation(side):
    clock = side.Clock(0.0)
    store = side.store(clock)
    a1 = elector(side, store, "a", [], clock)
    assert a1.step() is True and a1.fencing_token == 1
    a2 = elector(side, store, "a", [], clock)   # the restarted process
    clock.advance(1)
    assert a2.step() is True
    assert (a2.fencing_token, store.fence_floor()) == (2, 2)
    pod = pending_pod(side, store)
    with pytest.raises(side.Fenced):
        store.update("pods", pod, fence=a1.fencing_token, **side.update_kw)
    return store.fenced_writes


def lapse_takeover_fences(side):
    clock = side.Clock(0.0)
    store = side.store(clock)
    events = []
    a = elector(side, store, "a", events, clock)
    b = elector(side, store, "b", events, clock)
    a.step()
    b.step()
    clock.advance(20)
    assert b.step() is True
    assert (b.fencing_token, store.fence_floor()) == (2, 2)
    assert a.step() is False
    assert events.index("b:start") < events.index("a:stop")
    assert not (a.is_leader and b.is_leader)
    pod = pending_pod(side, store)
    with pytest.raises(side.Fenced):
        store.update("pods", pod, fence=a.fencing_token, **side.update_kw)
    return events, store.fenced_writes


def release_stops_before_clearing(side):
    clock = side.Clock(0.0)
    store = side.store(clock)
    events = []
    b = elector(side, store, "b", events, clock)

    def stopped():
        events.append("a:stop")
        # while a's stop callback runs, the lease is still held
        assert b.step() is False

    a = side.Elector(store, "a", lease_name="vc-test", clock=clock,
                     on_stopped_leading=stopped)
    a.step()
    a.release()
    assert events and events[0] == "a:stop"
    assert not a.is_leader
    assert b.step() is True
    assert events.index("a:stop") < events.index("b:start")
    return events


def renew_after_clock_jump(side):
    clock = side.Clock(0.0)
    store = side.store(clock)
    events = []
    a = elector(side, store, "a", events, clock)
    b = elector(side, store, "b", events, clock)
    a.step()
    clock.advance(100)   # lapsed from every view
    assert a.step() is True   # unchallenged, the leader renews
    assert a.fencing_token == 1
    lease = store.get("configmaps", "vc-test", "volcano-system")
    assert float(lease.data["renewTime"]) == 100.0
    clock.advance(100)   # the standby races first this time
    assert b.step() is True
    assert b.fencing_token == 2
    assert a.step() is False
    assert "a:stop" in events
    return events


@pytest.mark.parametrize("case", [token_bumps, restarted_incarnation,
                                  lapse_takeover_fences,
                                  release_stops_before_clearing,
                                  renew_after_clock_jump],
                         ids=lambda c: c.__name__)
def test_elector_fencing_matches_reference(case):
    on_both(case)


# -- tests/test_failover.py::TestStandby ---------------------------------------

def standby_run_once(side):
    clock = side.Clock(0.0)
    store = side.store(clock)
    tu = side.pkg.tu
    store.create("queues", tu.build_queue("default", weight=1))
    store.create("nodes", tu.build_node("n0", {"cpu": "32",
                                               "memory": "64Gi"}))
    store.create("podgroups", tu.build_pod_group("pg0", "ns1", "default",
                                                 3, phase="Inqueue"))
    for t in range(3):
        store.create("pods", tu.build_pod(
            "ns1", f"pg0-{t}", "", "Pending",
            tu.build_resource_list("1", "1Gi"), "pg0"))
    standby = side.Elector(store, "standby", lease_name="vc-test",
                           clock=clock)
    other = side.Elector(store, "leader", lease_name="vc-test", clock=clock)
    other.step()
    standby.step()
    cache = side.pkg.Cache(store)
    cache.run()
    kw = {"device": "cpu"} if side.name == "port" else {}
    sched = side.pkg.Scheduler(store, scheduler_conf=CONF, cache=cache,
                               clock=clock, elector=standby, **kw)
    was_enabled = side.tracer.is_enabled()
    side.tracer.enable()
    try:
        side.tracer.set_pending_report(None)
        sched.run_once()
        report = side.tracer.pending_report()
        assert report is not None
        assert report["idle_reason"] == side.NOT_LEADER
        assert side.NOT_LEADER in report["reasons"]
        assert store.get("pods", "pg0-0", "ns1").spec.node_name == ""
        # the cache stamps its writes with the elector's token
        assert cache.fence_source() == standby.fencing_token
    finally:
        if not was_enabled:
            side.tracer.disable()
        sched.stop()
        cache.stop()
    return report["reasons"], report["pending_jobs"]


def test_standby_run_once_skips_and_surfaces_reason():
    on_both(standby_run_once)


def test_leader_schedules_again_after_winning_the_lease_back():
    """A leader that loses its lease stops its cycle loop, and when it
    wins the lease back it schedules again under the higher token. (The
    reference's Scheduler keeps its stop flag set, so it would renew the
    lease and never schedule; the port begins each leadership with a
    fresh stop event.)"""
    side = SIDES["port"]
    clock = PortClock(0.0)
    store = side.store(clock)
    tu = side.pkg.tu
    store.create("queues", tu.build_queue("default", weight=1))
    store.create("nodes", tu.build_node("n0", {"cpu": "32",
                                               "memory": "64Gi"}))

    def gang(name):
        store.create("podgroups", tu.build_pod_group(
            name, "ns1", "default", 3, phase="Inqueue"))
        for t in range(3):
            store.create("pods", tu.build_pod(
                "ns1", f"{name}-{t}", "", "Pending",
                tu.build_resource_list("1", "1Gi"), name))

    def bound(name):
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            sched.cache.flush_executors()
            if all(store.get("pods", f"{name}-{t}", "ns1").spec.node_name
                   for t in range(3)):
                return True
            time.sleep(0.02)
        return False

    gang("pg0")
    a = PortElector(store, "a", lease_name="vc-test", clock=clock,
                    on_started_leading=lambda: sched.start(),
                    on_stopped_leading=lambda: sched.stop())
    b = PortElector(store, "b", lease_name="vc-test", clock=clock)
    sched = side.pkg.Scheduler(store, scheduler_conf=CONF,
                               schedule_period=0.02, clock=clock,
                               elector=a, device="cpu")
    try:
        assert a.step() is True
        assert bound("pg0")
        first = sched.thread
        clock.advance(20)   # a's lease lapses and b takes it
        assert b.step() is True
        assert a.step() is False
        first.join(JOIN_S)
        assert not first.is_alive()
        b.release()
        gang("pg1")
        assert a.step() is True
        assert a.fencing_token == 3 == store.fence_floor()
        assert sched.thread is not first and sched.thread.is_alive()
        assert bound("pg1")
    finally:
        a.release()
        sched.stop()
        if sched.thread is not None:
            sched.thread.join(JOIN_S)
        sched.cache.stop()
    assert not sched.thread.is_alive()


# -- tests/test_infra.py::TestDynamicPluginLoading ------------------------------

PLUGIN = textwrap.dedent("""
    from volcano_tpu_torch.framework.plugin import Plugin

    OPENED = []

    class MyPlugin(Plugin):
        def __init__(self, arguments=None):
            self.arguments = arguments
        def name(self):
            return "my-plugin"
        def on_session_open(self, ssn):
            OPENED.append(len(ssn.jobs))

    def Name():
        return "my-plugin"

    def New(arguments):
        return MyPlugin(arguments)
""")


@pytest.fixture
def plugin_dir(tmp_path, monkeypatch):
    """A plugins directory with one good plugin, one ``_``-prefixed file
    and one that does not parse; the port's registry is restored after
    the test."""
    (tmp_path / "myplugin.py").write_text(PLUGIN)
    (tmp_path / "_ignored.py").write_text("raise RuntimeError('no')")
    (tmp_path / "broken.py").write_text("this is ( not python")
    port_registry.get_action("allocate")   # the builtins, registered first
    monkeypatch.setattr(port_registry, "_plugin_builders",
                        dict(port_registry._plugin_builders))
    return tmp_path


def test_load_plugins_dir(plugin_dir):
    loaded = port_registry.load_plugins_dir(str(plugin_dir))
    assert loaded == ["my-plugin"]
    builder = port_registry.get_plugin_builder("my-plugin")
    assert builder is not None
    plugin = builder({})
    assert plugin.name() == "my-plugin"
    from volcano_tpu_torch.framework.plugin import Plugin
    assert isinstance(plugin, Plugin)


def test_missing_plugins_dir_is_noop():
    assert port_registry.load_plugins_dir("/nonexistent/path") == []


# -- tests/test_concurrency.py::test_conf_hot_reload_under_fire -----------------

def reload_under_fire(side, tmp_path):
    conf_path = tmp_path / f"{side.name}.yaml"
    conf_path.write_text(CONF)
    tu = side.pkg.tu
    store = side.store()
    cache = side.pkg.Cache(store, binder=tu.FakeBinder(store),
                           evictor=tu.FakeEvictor(store))
    cache.run()
    kw = {"device": "cpu"} if side.name == "port" else {}
    sched = side.pkg.Scheduler(store, scheduler_conf_path=str(conf_path),
                               cache=cache, **kw)
    store.create("queues", tu.build_queue("default", weight=1))
    store.create("nodes", tu.build_node("n0", {"cpu": "8",
                                               "memory": "16Gi"}))
    store.create("podgroups", tu.build_pod_group("pg", "ns1", "default", 1,
                                                 phase="Inqueue"))
    store.create("pods", tu.build_pod("ns1", "p0", "", "Pending",
                                      tu.build_resource_list("1", "1Gi"),
                                      "pg"))
    stop = threading.Event()
    errors = []

    def reloader(tid):
        rng = random.Random(tid)
        try:
            while not stop.is_set():
                if rng.random() < 0.5:
                    conf_path.write_text(CONF)
                else:
                    conf_path.write_text("actions: [this is : not valid")
                sched.load_scheduler_conf()
        except Exception as e:   # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=reloader, args=(t,))
               for t in range(3)]
    for t in threads:
        t.start()
    try:
        for _ in range(20):
            sched.run_once()
    finally:
        stop.set()
        for t in threads:
            t.join(JOIN_S)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    assert sched.conf.actions == ["enqueue", "allocate"]
    assert cache.flush_executors(timeout=30)
    binds = dict(cache.binder.binds)
    cache.stop()
    return binds


def test_conf_hot_reload_under_fire(tmp_path):
    assert on_both(lambda side: reload_under_fire(side, tmp_path)) \
        == {"ns1/p0": "n0"}


def test_watch_conf_reloads_within_two_intervals(tmp_path):
    """``Scheduler.watch_conf``: a rewritten conf file is the running conf
    within two 1 s polls; a broken rewrite keeps it; ``stop`` ends the
    watcher's thread."""
    path = tmp_path / "scheduler.yaml"
    path.write_text(CONF)
    store = PORT.Store()
    sched = PORT.Scheduler(store, scheduler_conf_path=str(path),
                           device="cpu")
    sched.watch_conf()
    watcher = sched._watcher
    try:
        time.sleep(0.05)
        path.write_text(CONF.replace('"enqueue, allocate"', '"allocate"'))
        deadline = time.monotonic() + 2 * watcher.interval + 0.5
        while sched.conf.actions != ["allocate"] and \
                time.monotonic() < deadline:
            time.sleep(0.05)
        assert sched.conf.actions == ["allocate"]
        path.write_text("actions: [this is : not valid")
        time.sleep(2 * watcher.interval + 0.2)
        assert sched.conf.actions == ["allocate"]
    finally:
        sched.stop()
        watcher._thread.join(JOIN_S)
    assert not watcher._thread.is_alive()


def test_file_watcher_survives_a_failing_callback(tmp_path):
    path = tmp_path / "f"
    path.write_text("a")
    calls = []

    def on_change():
        calls.append(1)
        raise ValueError("callback failure")

    watcher = FileWatcher(str(path), on_change, interval=0.05)
    watcher.start()
    try:
        for text in ("b", "cc"):
            time.sleep(0.1)
            path.write_text(text)
            deadline = time.monotonic() + 2.0
            n = len(calls)
            while len(calls) == n and time.monotonic() < deadline:
                time.sleep(0.02)
    finally:
        watcher.stop(timeout=JOIN_S)
    assert not watcher._thread.is_alive()
    assert len(calls) >= 2


# -- the flags ------------------------------------------------------------------

def flags(cmd):
    parser = argparse.ArgumentParser()
    cmd.add_flags(parser)
    return {a.dest: a.default for a in parser._actions if a.dest != "help"}


def test_flags_are_the_reference_flags_and_device():
    ref, port = flags(ref_cmd), flags(port_cmd)
    assert port.pop("device") is None
    assert port == ref
    parser = argparse.ArgumentParser()
    port_cmd.add_flags(parser)
    args = parser.parse_args(["--leader-elect", "--schedule-period", "0.5",
                              "--plugins-dir", "/x", "--device", "cpu",
                              "--percentage-nodes-to-find", "30",
                              "--scheduler-conf", "c.yaml"])
    assert (args.leader_elect, args.schedule_period, args.plugins_dir,
            args.device, args.scheduler_conf) == \
        (True, 0.5, "/x", "cpu", "c.yaml")


def test_server_exits_non_zero(capsys):
    assert port_cmd.main(["--server", "http://127.0.0.1:1",
                          "--device", "cpu"]) != 0
    assert "apiserver/remote.py" in capsys.readouterr().err


def test_version_prints_and_exits(capsys):
    with pytest.raises(SystemExit) as e:
        port_cmd.main(["--version"])
    assert e.value.code == 0
    assert "volcano-tpu-torch version" in capsys.readouterr().out


def test_main_needs_a_gpu_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cmd.main(["--listen-address", "127.0.0.1:0"])


# -- run_scheduler against the reference's ------------------------------------

def drive(side, tmp_path, monkeypatch, plugins_dir=None):
    """Candidates through ``side``'s run_scheduler (--leader-elect) on one
    seeded store: the leader's first cycle, then its binds. The schedule
    period is long, so exactly one cycle runs. The port runs two
    candidates; the reference one, since its identity (host and process)
    is the same for two candidates of one process."""
    spec = make_spec(5, n_nodes=16, n_jobs=12, gang=(2, 5))
    store = side.pkg.Store()
    populate(side.pkg, store, spec)
    text = conf()
    if plugins_dir is not None:
        text = text.replace("  - name: nodeorder",
                            "  - name: nodeorder\n  - name: my-plugin")
    path = tmp_path / f"{side.name}-conf.yaml"
    path.write_text(text)
    cycles = []
    original = side.scheduler_mod.Scheduler.run_once

    def counted(self):
        original(self)
        cycles.append(self)

    monkeypatch.setattr(side.scheduler_mod.Scheduler, "run_once", counted)
    argv = ["--leader-elect", "--scheduler-conf", str(path),
            "--schedule-period", "60"]
    if side.name == "port":
        argv += ["--device", "cpu"]
    if plugins_dir is not None:
        argv += ["--plugins-dir", str(plugins_dir)]
    parser = argparse.ArgumentParser()
    side.cmd.add_flags(parser)
    args = parser.parse_args(argv)
    scheds = [side.cmd.run_scheduler(store, args)
              for _ in range(2 if side.name == "port" else 1)]
    try:
        deadline = time.monotonic() + 60.0
        while not cycles and time.monotonic() < deadline:
            time.sleep(0.02)
        assert cycles, "the leader ran no cycle"
        leader = cycles[0]
        assert leader.elector.is_leader
        for standby in scheds:
            if standby is not leader:
                assert not standby.elector.is_leader
                assert standby.elector.identity != leader.elector.identity
        assert store.fence_floor() == leader.elector.fencing_token == 1
        leader.cache.flush_executors()
        binds = {f"{p.metadata.namespace}/{p.metadata.name}":
                 p.spec.node_name for p in store.list("pods")
                 if p.spec.node_name}
    finally:
        for s in scheds:
            s.elector.stop()
            s.elector._thread.join(JOIN_S)
            s.stop()
        for s in scheds:
            assert not s.elector._thread.is_alive()
            s.cache.stop()
    return binds


def test_run_scheduler_binds_as_the_reference(tmp_path, monkeypatch):
    ref = drive(SIDES["ref"], tmp_path, monkeypatch)
    port = drive(SIDES["port"], tmp_path, monkeypatch)
    assert port == ref
    assert port


def test_run_scheduler_loads_the_plugins_dir(tmp_path, monkeypatch,
                                             plugin_dir):
    assert drive(SIDES["port"], tmp_path, monkeypatch,
                 plugins_dir=plugin_dir)
    builder = port_registry.get_plugin_builder("my-plugin")
    # the leader's session opened the out-of-tree plugin
    assert builder.__globals__["OPENED"]
