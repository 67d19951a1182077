"""The port's replication follower half (volcano_tpu_torch/replication/:
follower, federation, election) held against the JAX package's.

* The cases of tests/test_replication.py run on the port (``port_cases``):
  frames installed at the leader's rvs, fencing of a deposed leader's
  frames, the catch-up relist and the snapshot bootstrap, the replica
  set's hubs, handoffs and audit, the ``/replicate`` transport, the shared
  frame encoding, the rv-keyed fault coin's double run (on the CPU), the
  atomic snapshot install, the elector's restart fencing, the shared
  backoff and the client's replica failover.
* Side by side: the same seeded writes through both packages' replica
  sets give the same mirror fingerprints, fence counts, handoff
  placements and reports; both packages' elector seams give the same
  tokens; a plain follower apiserver of the port refuses writes (the
  reference's takes them, ROADMAP.md).

Tolerance: exact.
"""

import importlib
import json
import random
import urllib.request

import pytest

from tests.torch_reference_cases import port_cases

_rep = port_cases("test_replication", replace=[
    ("""        from volcano_tpu_torch.framework.solver import reset_breaker
        from volcano_tpu_torch.sim.cli import failover_config""",
     """        from volcano_tpu_torch.sim.cli import failover_config"""),
    ("""            reset_breaker()
            m.reset()
            cfg = failover_config(seed=29, ticks=100, nodes=64)""",
     """            m.reset()
            cfg = failover_config(seed=29, ticks=100, nodes=64,
                                  device="cpu")""")])
TestApplyReplicated = _rep.TestApplyReplicated
TestFencing = _rep.TestFencing
TestGapRecovery = _rep.TestGapRecovery
TestReplicaSet = _rep.TestReplicaSet
TestHTTPReplication = _rep.TestHTTPReplication
TestSharedEncoding = _rep.TestSharedEncoding
TestRvDeterminism = _rep.TestRvDeterminism
TestSnapshotBootstrapAtomicity = _rep.TestSnapshotBootstrapAtomicity
TestElectorRestartFencing = _rep.TestElectorRestartFencing
TestSeededBackoffShared = _rep.TestSeededBackoffShared
TestClientReplicaFailover = _rep.TestClientReplicaFailover


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _kinds():
    """The kinds both stores keep (the reference keeps a few more, which
    these histories leave empty)."""
    return sorted(_mod("volcano_tpu_torch", "apiserver.store").KINDS)


def _fingerprints(pkg, store):
    fp = _mod(pkg, "cache.cache").SchedulerCache._fingerprint
    return {kind: fp({store.key_of(kind, o):
                      (o.metadata.resource_version, o)
                      for o in store.list_refs(kind)})
            for kind in _kinds()}


def _audit(audit: dict) -> dict:
    """An audit with its fingerprints over the shared kinds; the rest
    must be empty."""
    out = dict(audit, fingerprints={})
    for name, per in audit["fingerprints"].items():
        assert all(v == [0, 0, 0] for k, v in per.items()
                   if k not in _kinds()), per
        out["fingerprints"][name] = {k: per[k] for k in _kinds()}
    return out


def _replica_set_run(pkg, seed: int) -> dict:
    """A seeded write history through one package's replica set: creates,
    updates and deletes on the leader, a follower killed and its cursors
    handed off, a forced journal gap, an election and a deposed leader's
    frame. Returns what both packages must agree on."""
    store_mod = _mod(pkg, "apiserver.store")
    tu = _mod(pkg, "utils.test_utils")
    rs_mod = _mod(pkg, "replication.federation")
    faults = _mod(pkg, "sim.faults")
    rng = random.Random(seed)
    leader = store_mod.ObjectStore()
    rs = rs_mod.ReplicaSet(leader, followers=3, shards=2)
    for i in range(8):
        leader.create("nodes", tu.build_node(f"n{i}", {"cpu": "8"}))
    subs = {}
    for i in range(24):
        cid = f"c-{i}"
        home = rs.place_subscriber(cid)
        subs[cid] = (home, rs.hub_of(home).subscribe(cid, since_rv=0))
    names = []
    for step in range(120):
        op = rng.random()
        if op < 0.6 or not names:
            name = f"p{step}"
            leader.create("pods", tu.build_pod("default", name, "",
                                               "Pending", {"cpu": "1"}))
            names.append(name)
        elif op < 0.85:
            p = leader.get("pods", rng.choice(names))
            p.spec.node_name = f"n{rng.randrange(8)}"
            leader.update("pods", p, skip_admission=True)
        else:
            leader.delete("pods", names.pop(rng.randrange(len(names))),
                          "default", skip_admission=True)
        if step % 10 == 9:
            rs.sync()
            rs.pump()
        if step == 40:
            rs.kill("replica-3")
        if step == 70:
            faults.FlakyWatch.force_gap(leader)
    handoffs = {}
    for cid, (home, sub) in sorted(subs.items()):
        if home == "replica-3":
            handoffs[cid] = rs.handoff(sub, 0)[0]
    # the deposed leader's frame: collected under the current epoch,
    # shipped after the election
    leader.create("pods", tu.build_pod("default", "late", "", "Pending",
                                       {"cpu": "1"}))
    target = rs.followers[0]
    stale = rs.epoch
    entries, _, _, _ = rs.source.collect(target.applied_rv(), 0.0,
                                         epoch=stale)
    rs.advance_epoch()
    with pytest.raises(store_mod.FencedError):
        target.apply_frame(entries, epoch=stale)
    for f in rs.followers:
        if f.name not in rs.dead:
            f.sync_to_head()
    audit = rs.audit()
    report = rs.report()
    return {"homes": {cid: home for cid, (home, _) in subs.items()},
            "handoffs": handoffs, "audit": _audit(audit),
            "leader_fp": _fingerprints(pkg, leader),
            "mirror_fp": {f.name: _fingerprints(pkg, f.store)
                          for f in rs.followers},
            "followers": report["followers"], "epoch": report["epoch"],
            "dead": report["dead"],
            "cursor_handoffs": report["cursor_handoffs"]}


@pytest.mark.parametrize("seed", [3, 11])
def test_replica_set_matches_reference(seed):
    ref = _replica_set_run("volcano_tpu", seed)
    port = _replica_set_run("volcano_tpu_torch", seed)
    assert port == ref
    assert port["audit"]["verdict"] == "identical"
    live = [f for f in port["followers"] if f["name"] != "replica-3"]
    assert all(port["mirror_fp"][f["name"]] == port["leader_fp"]
               for f in live)
    assert port["followers"][0]["fenced_frames"] == 1
    assert sum(f["snapshot_bootstraps"] for f in live) >= 1
    assert port["handoffs"] and set(port["handoffs"].values()) <= {
        "replica-0", "replica-1", "replica-2"}


def _elector_tokens(pkg) -> list:
    """Three candidates on one lease board and a fake clock: lapses,
    restarts and takeovers; the promotions each saw and the fence floor
    after each round."""
    store_mod = _mod(pkg, "apiserver.store")
    election = _mod(pkg, "replication.election")
    clock = _mod(pkg, "utils.clock").FakeClock(0.0)
    store = store_mod.ObjectStore()
    board = election.LeaseBoard(store=store, clock=clock)
    seen = {n: [] for n in ("r0", "r1", "r2")}
    electors = {n: election.EpochElector(
        n, board, on_promote=seen[n].append, lease_duration=3.0 + i,
        retry_period=1.0, clock=clock) for i, n in enumerate(seen)}
    trace = []
    for rnd in range(24):
        for n, e in electors.items():
            if rnd >= 6 and n == "r0" and rnd < 14:
                continue                   # r0 stops renewing for a while
            if rnd == 18 and n == "r1":
                e.restart()
            e.step()
        trace.append((board.peek()["holder"], board.peek()["token"],
                      store.fence_floor()))
        clock.advance(1.0)
    return [trace, seen]


def test_elector_seam_matches_reference():
    ref = _elector_tokens("volcano_tpu")
    port = _elector_tokens("volcano_tpu_torch")
    assert port == ref
    assert len({t for _, t, _ in port[0]}) >= 2     # a takeover happened


def test_lease_board_push_monotonic_like_reference():
    def run(pkg):
        election = _mod(pkg, "replication.election")
        store = _mod(pkg, "apiserver.store").ObjectStore()
        clock = _mod(pkg, "utils.clock").FakeClock(5.0)
        board = election.LeaseBoard(store=store, clock=clock)
        board.seed("r0", "http://a")
        views = [board.peek()]
        for holder, token in (("r0", 1), ("r1", 1), ("r1", 2), ("r0", 1),
                              ("r1", 2), ("r2", 4), ("r1", 3)):
            clock.advance(0.5)
            views.append(board.receive(holder, token, f"http://{holder}"))
        return views, store.fence_floor()
    assert run("volcano_tpu_torch") == run("volcano_tpu")


def test_plain_follower_apiserver_refuses_writes():
    """A follower apiserver's mirror takes writes from the leader's
    journal only: a write answers 503 with the leader's url, ``/leader``
    names the leader, and a read carries the mirror's staleness."""
    from volcano_tpu_torch.apiserver.http import (ApiError, StoreClient,
                                                  StoreHTTPServer)
    from volcano_tpu_torch.apiserver.store import ObjectStore
    from volcano_tpu_torch.replication.follower import (
        FollowerReplica, FollowerRole, HTTPReplicationSource)
    from volcano_tpu_torch.utils.test_utils import build_pod

    leader = ObjectStore()
    lsrv = StoreHTTPServer(leader, port=0)
    lsrv.start()
    lurl = f"http://127.0.0.1:{lsrv.port}"
    f = FollowerReplica("f1", HTTPReplicationSource(lurl))
    fsrv = StoreHTTPServer(f.store, port=0, member=FollowerRole(f))
    fsrv.start()
    furl = f"http://127.0.0.1:{fsrv.port}"
    try:
        leader.create("pods", build_pod("default", "a", "", "Pending",
                                        {"cpu": "1"}))
        f.sync_to_head()
        with pytest.raises(ApiError) as ei:
            StoreClient(furl).create("pods", build_pod(
                "default", "b", "", "Pending", {"cpu": "1"}))
        assert ei.value.code == 503 and ei.value.retry_after == 1.0
        assert f.store.get("pods", "b") is None
        info = json.loads(urllib.request.urlopen(furl + "/leader").read())
        assert info["role"] == "follower" and info["url"] == lurl
        assert not info["accepts_writes"]
        # a client of both replicas writes through the follower's hint
        c = StoreClient([furl, lurl], client_id="both")
        c.create("pods", build_pod("default", "c", "", "Pending",
                                   {"cpu": "1"}))
        assert leader.get("pods", "c") is not None
        with urllib.request.urlopen(furl + "/apis/pods") as r:
            assert r.headers["X-Volcano-Role"] == "follower"
            assert int(r.headers["X-Volcano-Applied-Rv"]) == 1
    finally:
        fsrv.stop()
        lsrv.stop()


def test_sim_config_takes_the_reference_bundles_rv_coin():
    """A repro bundle of the reference naming the rv-keyed watch coin
    loads into the port's SimConfig with that coin, and the engine's
    FlakyWatch keys on the delivered object's rv."""
    from volcano_tpu.sim.cli import failover_config as ref_failover
    from volcano_tpu_torch.sim.engine import SimConfig
    from volcano_tpu_torch.sim.faults import FlakyWatch
    from volcano_tpu_torch.utils.test_utils import build_pod
    ref = ref_failover(seed=29, ticks=10, nodes=16)
    ref.faults.watch_coin = "rv"
    cfg = SimConfig.from_dict(json.loads(json.dumps(ref.to_dict())))
    assert cfg.faults.watch_coin == "rv"
    watch = FlakyWatch(seed=5, drop_rate=0.5, coin=cfg.faults.watch_coin)
    pod = build_pod("default", "p", "", "Pending", {"cpu": "1"})
    fates = []
    for rv in (3, 4, 3):
        pod.metadata.resource_version = rv
        fates.append(watch._coin("MODIFIED", pod))
    assert fates[0] == fates[2]      # same rv, same fate: no sequence
