"""Elector-driven epochs (the port's own copy of
volcano_tpu/replication/election.py): the seam between the
LeaderElector and the replication fence machinery.

Three layers, smallest first:

``EpochElector``
    Wraps :class:`~volcano_tpu_torch.utils.leaderelection.LeaderElector` so
    that winning the lease *promotes an epoch*: ``on_promote(token)``
    fires with the fencing token every time this candidate (re)acquires
    leadership.  ``restart()`` simulates a process restart of the same
    identity — a fresh incarnation deliberately does NOT inherit its
    predecessor's token, so the old incarnation's writes are fenced (the
    rule).  This is the seam the in-process federation gate and the
    virtual-clock tests drive; no harness calls ``advance_epoch``.

``LeaseBoard``
    A single-lease, store-shaped side channel for *process mode*.  The
    elector duck-types its store (get/create/update + advance_fence);
    in a multi-process deployment the lease must NOT live in the
    replicated object space — renewals would consume journal rvs at
    timing-dependent counts and break the double-run rv fingerprints.
    The board holds exactly one ConfigMap-shaped lease per process,
    replicated peer-to-peer by ``POST /lease/<sender>`` pushes, and
    delegates ``advance_fence`` to the real ObjectStore so every
    observed token raises the local fence floor.

``FederationMember``
    The per-apiserver runtime: runs the elector against its local
    board, pushes lease renewals to peers while leading, follows the
    current holder via :class:`FollowerReplica` otherwise, and reports
    a degraded role (reads-only, structured 503 for writes) when the
    lease has lapsed and nobody has won it yet.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, List, Optional

from ..apiserver.store import ConflictError
from ..models.objects import ConfigMap, ObjectMeta
from ..utils.leaderelection import (FENCE_KEY, HOLDER_KEY, LOCK_NAMESPACE,
                                    RENEW_KEY, LeaderElector)

#: lease data key carrying the holder's advertised base url (process
#: mode only; the in-proc gate has no sockets so it never sets one).
URL_KEY = "holderUrl"

DEFAULT_LEASE_NAME = "vc-apiserver"

log = logging.getLogger(__name__)


class _PerfClock:
    """Monotonic clock for lease expiry in process mode.

    Wall time (``time.time``) can step backwards under NTP; a lapsed
    lease decision must never un-lapse.  ``perf_counter`` is the one
    clock source for this.
    """

    def now(self) -> float:
        return time.perf_counter()

    def sleep(self, seconds: float) -> None:  # pragma: no cover - unused
        time.sleep(seconds)


class EpochElector:
    """LeaderElector -> epoch promotion seam.

    ``on_promote(token)`` is invoked (synchronously, from ``step()``)
    whenever this candidate acquires leadership; ``token`` is the
    monotonically increasing fencing token.  ``on_demote()`` fires when
    leadership is observed lost.
    """

    def __init__(self, identity: str, store,
                 on_promote: Callable[[int], None],
                 lease_name: str = DEFAULT_LEASE_NAME,
                 lease_duration: float = 15.0,
                 retry_period: float = 5.0,
                 clock=None,
                 on_demote: Optional[Callable[[], None]] = None):
        self.identity = identity
        self.store = store
        self.on_promote = on_promote
        self.on_demote = on_demote
        self.lease_name = lease_name
        self.lease_duration = lease_duration
        self.retry_period = retry_period
        self.clock = clock
        self.promotions = 0
        self._build()

    def _build(self) -> None:
        self.elector = LeaderElector(
            store=self.store,
            identity=self.identity,
            lease_name=self.lease_name,
            lease_duration=self.lease_duration,
            retry_period=self.retry_period,
            on_started_leading=self._started,
            on_stopped_leading=self._stopped,
            clock=self.clock,
        )

    def _started(self) -> None:
        self.promotions += 1
        self.on_promote(int(self.elector.fencing_token))

    def _stopped(self) -> None:
        if self.on_demote is not None:
            self.on_demote()

    def step(self) -> bool:
        """One election round; returns True while leading."""
        return self.elector.step()

    def token(self) -> Optional[int]:
        return self.elector.fencing_token

    def is_leader(self) -> bool:
        return self.elector.is_leader

    def release(self) -> None:
        self.elector.release()

    def restart(self) -> None:
        """Simulate a process restart of this candidate.

        The new incarnation shares the identity but NOT the in-memory
        token: on its next acquisition ``_next_token`` bumps past the
        stored token, fencing every write of the previous self.
        """
        self._build()


class LeaseBoard:
    """Single-lease store duck-type kept OFF the replicated rv space.

    Implements exactly the surface :class:`LeaderElector` touches
    (``get`` / ``create`` / ``update`` with conflict detection, plus
    ``advance_fence``) for one lease object.  ``receive`` installs a
    lease pushed by a peer, monotonically by fencing token, stamping
    the *local* receipt time as renewTime so expiry is judged on this
    process's own clock — no cross-host clock comparison.
    """

    def __init__(self, store=None, clock=None,
                 lease_name: str = DEFAULT_LEASE_NAME):
        self.store = store        # real ObjectStore; fence delegate
        self.clock = clock or _PerfClock()
        self.lease_name = lease_name
        self._lock = threading.Lock()
        self._lease: Optional[ConfigMap] = None
        self._version = 0

    # -- store duck-type used by LeaderElector ---------------------------

    @staticmethod
    def _clone_locked(lease: ConfigMap) -> ConfigMap:
        out = ConfigMap(
            metadata=ObjectMeta(name=lease.metadata.name,
                                namespace=lease.metadata.namespace),
            data=dict(lease.data))
        out.metadata.resource_version = lease.metadata.resource_version
        return out

    def get(self, kind: str, name: str, namespace: str = "default"):
        with self._lock:
            if self._lease is None:
                return None
            return self._clone_locked(self._lease)

    def create(self, kind: str, obj, **_kw):
        with self._lock:
            if self._lease is not None:
                raise KeyError(f"{kind}/{obj.metadata.key()}: exists")
            self._version += 1
            obj.metadata.resource_version = self._version
            self._lease = self._clone_locked(obj)
            return obj

    def update(self, kind: str, obj, **_kw):
        with self._lock:
            if self._lease is None:
                raise KeyError(f"{kind}/{obj.metadata.key()}: missing")
            if obj.metadata.resource_version \
                    != self._lease.metadata.resource_version:
                raise ConflictError(
                    f"lease {obj.metadata.name}: stale resource_version")
            self._version += 1
            obj.metadata.resource_version = self._version
            self._lease = self._clone_locked(obj)
            return obj

    def advance_fence(self, token: int) -> int:
        if self.store is not None:
            return self.store.advance_fence(token)
        return int(token)

    # -- peer push path ---------------------------------------------------

    def receive(self, holder: str, token: int, url: str = "") -> Dict:
        """Install a pushed lease if its token is not older than ours.

        Same-token pushes from the same holder refresh renewTime (the
        normal renewal heartbeat); a higher token replaces the lease
        outright (a new regime).  Either way the local fence floor is
        advanced so deposed-regime writes are rejected *here* too, not
        just at the new leader.
        """
        token = int(token)
        now = self.clock.now()
        with self._lock:
            cur = self._lease
            cur_token = int(cur.data.get(FENCE_KEY, "0")) if cur else -1
            if token < cur_token:
                return self._peek_locked()
            if (token == cur_token and cur is not None
                    and cur.data.get(HOLDER_KEY) != holder):
                return self._peek_locked()
            self._version += 1
            lease = ConfigMap(
                metadata=ObjectMeta(name=self.lease_name,
                                    namespace=LOCK_NAMESPACE),
                data={HOLDER_KEY: holder, RENEW_KEY: str(now),
                      FENCE_KEY: str(token), URL_KEY: url})
            lease.metadata.resource_version = self._version
            self._lease = lease
            out = self._peek_locked()
        self.advance_fence(token)
        return out

    def seed(self, holder: str, url: str = "", token: int = 0) -> None:
        """Install the initial leader hint at boot (token 0, so the
        first genuine acquisition supersedes it)."""
        now = self.clock.now()
        with self._lock:
            if self._lease is not None:
                return
            self._version += 1
            lease = ConfigMap(
                metadata=ObjectMeta(name=self.lease_name,
                                    namespace=LOCK_NAMESPACE),
                data={HOLDER_KEY: holder, RENEW_KEY: str(now),
                      FENCE_KEY: str(token), URL_KEY: url})
            lease.metadata.resource_version = self._version
            self._lease = lease

    def peek(self) -> Dict:
        with self._lock:
            return self._peek_locked()

    def _peek_locked(self) -> Dict:
        if self._lease is None:
            return {"holder": "", "token": -1, "url": "", "renew": 0.0}
        d = self._lease.data
        return {"holder": d.get(HOLDER_KEY, ""),
                "token": int(d.get(FENCE_KEY, "0")),
                "url": d.get(URL_KEY, ""),
                "renew": float(d.get(RENEW_KEY, "0") or 0.0)}


class FederationMember:
    """Per-process federation runtime: elect, push, follow, degrade.

    Roles:

    ``leader``    — elector holds the lease; writes accepted; renewals
                    pushed to every peer each step.
    ``follower``  — a live holder is known; a FollowerReplica mirrors
                    it; reads/watches served with a staleness bound.
    ``degraded``  — the lease lapsed and nobody (including us) has won
                    it yet; reads keep flowing, writes fail fast with
                    503 + Retry-After.
    """

    def __init__(self, name: str, store, hub=None,
                 peers: Optional[Dict[str, str]] = None,
                 advertise_url: str = "",
                 lease_duration: float = 15.0,
                 renew_interval: float = 5.0,
                 bootstrap_leader: bool = False,
                 initial_leader: str = "",
                 initial_leader_url: str = "",
                 push_timeout: float = 2.0,
                 source_timeout: float = 5.0,
                 clock=None,
                 local_recovery_floor: Optional[int] = None):
        self.name = name
        self.store = store
        self.hub = hub
        self.peers = dict(peers or {})
        self.advertise_url = advertise_url.rstrip("/")
        self.lease_duration = float(lease_duration)
        self.renew_interval = float(renew_interval)
        self.push_timeout = float(push_timeout)
        self.source_timeout = float(source_timeout)
        self.clock = clock or _PerfClock()
        self.board = LeaseBoard(store=store, clock=self.clock)
        if not bootstrap_leader and initial_leader:
            self.board.seed(initial_leader, initial_leader_url)
        self.elector = EpochElector(
            identity=name, store=self.board,
            on_promote=self._on_promote, on_demote=self._on_demote,
            lease_duration=self.lease_duration,
            retry_period=self.renew_interval, clock=self.clock)
        self._lock = threading.Lock()
        self._role = "degraded" if not (bootstrap_leader or initial_leader) \
            else ("leader" if bootstrap_leader else "follower")
        self._follower = None          # FollowerReplica while following
        self._needs_bootstrap = True   # first follow / post-deposition
        # federation restart fast path (docs/design/durability.md): the
        # fence floor the local WAL recovery re-anchored, consumed
        # one-shot at the first follow.  The local log is trusted —
        # bootstrap skipped — only while the CURRENT leader's token is
        # <= this floor, i.e. no takeover happened since the log's last
        # durable fence record: within one regime a restarted replica's
        # log is a prefix of the leader's history (catch-up closes the
        # gap; the window-rolled case still bootstraps via the sync
        # loop).  A deposed leader's un-replicated tail occupies rvs the
        # new regime reassigned, so any epoch advance forces the
        # snapshot re-anchor instead.
        self._recovery_floor = local_recovery_floor
        self.bootstrap_skips = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.takeovers = 0
        self.demotions = 0
        self.lease_pushes = 0
        self.push_errors = 0
        self.bootstrap_failures = 0

    # -- elector callbacks (run inside step()) ----------------------------

    def _on_promote(self, token: int) -> None:
        with self._lock:
            follower = self._follower
            self._follower = None
            self._role = "leader"
        self.takeovers += 1
        if follower is not None:
            follower.stop()
        if self.hub is not None:
            self.hub.set_epoch(int(token))
        # fence floor already advanced via LeaderElector._announce_fence

    def _on_demote(self) -> None:
        with self._lock:
            self._role = "degraded"   # reconciled to follower below
            self._needs_bootstrap = True
        self.demotions += 1

    # -- control loop -----------------------------------------------------

    def step(self) -> str:
        """One election + reconcile round; returns the current role."""
        leading = self.elector.step()
        if leading:
            self._push_lease()
            return "leader"
        lease = self.board.peek()
        now = self.clock.now()
        live = (lease["holder"] != ""
                and now - lease["renew"] < self.lease_duration)
        if live and lease["holder"] != self.name and lease["url"]:
            self._ensure_following(lease["url"])
            with self._lock:
                self._role = "follower"
            return "follower"
        with self._lock:
            self._role = "degraded"
        return "degraded"

    def start(self) -> None:
        def loop() -> None:
            while not self._stop.is_set():
                try:
                    self.step()
                except Exception:
                    # a peer or the leader unreachable for a round: the
                    # next round elects and reconciles again
                    log.warning("member %s: election round failed",
                                self.name, exc_info=True)
                self._stop.wait(self.renew_interval)

        self._thread = threading.Thread(
            target=loop, name=f"member-{self.name}", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        with self._lock:
            follower = self._follower
            self._follower = None
        if follower is not None:
            follower.stop()
        if self.elector.is_leader():
            self.elector.release()

    # -- lease push / receive ---------------------------------------------

    def _push_lease(self) -> None:
        token = self.elector.token()
        if token is None:
            return
        body = {"holder": self.name, "token": int(token),
                "url": self.advertise_url}
        for peer, url in self.peers.items():
            if peer == self.name:
                continue
            try:
                reply = self._post_lease(url, body)
            except Exception:
                self.push_errors += 1
                continue
            self.lease_pushes += 1
            if reply and int(reply.get("token", -1)) > int(token):
                # a newer regime exists; install it so the next step
                # demotes us instead of fighting the lease
                self.board.receive(reply.get("holder", ""),
                                   int(reply["token"]),
                                   reply.get("url", ""))

    def _post_lease(self, base_url: str, body: Dict) -> Dict:
        import http.client
        import json as _json
        from urllib.parse import urlsplit
        parts = urlsplit(base_url)
        conn = http.client.HTTPConnection(
            parts.hostname, parts.port, timeout=self.push_timeout)
        try:
            payload = _json.dumps(body).encode()
            conn.request("POST", f"/lease/{self.name}", body=payload,
                         headers={"Content-Type": "application/json",
                                  "Content-Length": str(len(payload))})
            resp = conn.getresponse()
            data = resp.read()
            if resp.status != 200:
                raise ConnectionError(
                    f"lease push to {base_url}: HTTP {resp.status}")
            return _json.loads(data)
        finally:
            conn.close()

    def receive_lease(self, holder: str, token: int, url: str = "") -> Dict:
        """Install a lease pushed by a peer; returns our current view
        (so a deposed pusher learns about the newer regime)."""
        return self.board.receive(holder, int(token), url)

    # -- follower wiring ---------------------------------------------------

    def _ensure_following(self, url: str) -> None:
        url = url.rstrip("/")
        with self._lock:
            cur = self._follower
            needs_bootstrap = self._needs_bootstrap
        if cur is not None and cur.source.base_url == url:
            return
        if cur is not None:
            cur.stop()
            with self._lock:
                self._follower = None
            # re-point across regimes always re-anchors from a snapshot:
            # a deposed leader's mirror may have diverged without a gap
            needs_bootstrap = True
        from .follower import FollowerReplica, HTTPReplicationSource
        source = HTTPReplicationSource(url, timeout=self.source_timeout)
        follower = FollowerReplica(self.name, source, store=self.store,
                                   hub=self.hub)
        if needs_bootstrap and self._recovery_floor is not None:
            floor, self._recovery_floor = self._recovery_floor, None
            token = int(self.board.peek().get("token") or 0)
            if token <= floor:
                # local-WAL fast path candidate — but the LOCAL board is
                # not authoritative right after a restart: a takeover
                # that happened while this replica was down is only
                # learned from the new leader's lease push, which may
                # not have arrived yet.  A deposed leader's acked-but-
                # never-replicated WAL tail occupies rvs the new regime
                # reassigned, and that overlap is rv-contiguous — the
                # sync loop would resume over it with no gap to trip on
                # (silent divergence).  So confirm against the UPSTREAM:
                # its fence epoch must still be <= the recovered floor
                # (no takeover since the log's last durable fence
                # record) and the local log must not run AHEAD of its
                # head.  Probe failure keeps the snapshot bootstrap.
                try:
                    up_head = source.current_rv()
                    _, _, gone, up_epoch = source.collect(up_head,
                                                          timeout=0.0)
                    if (not gone and int(up_epoch) <= floor
                            and self.store.current_rv() <= up_head):
                        needs_bootstrap = False
                        self.bootstrap_skips += 1
                except Exception:
                    pass
        if needs_bootstrap:
            try:
                follower.bootstrap()
            except Exception:
                self.bootstrap_failures += 1
                return      # retry on the next step
        follower.start()
        with self._lock:
            self._follower = follower
            self._needs_bootstrap = False

    # -- read surface -------------------------------------------------------

    def role(self) -> str:
        with self._lock:
            return self._role

    def accepts_writes(self) -> bool:
        with self._lock:
            if self._role != "leader":
                return False
        # deposed-but-not-yet-stepped: the board already knows the new
        # regime, so stop accepting immediately
        lease = self.board.peek()
        return lease["holder"] == self.name or lease["holder"] == ""

    def leader_hint(self) -> Dict:
        lease = self.board.peek()
        now = self.clock.now()
        live = (lease["holder"] != ""
                and now - lease["renew"] < self.lease_duration)
        return {"holder": lease["holder"], "url": lease["url"],
                "token": lease["token"], "live": live}

    def staleness(self) -> Optional[Dict]:
        """Follower staleness bound: applied rv + estimated lag."""
        with self._lock:
            follower = self._follower
            role = self._role
        if role == "leader" or follower is None:
            return None
        return {"applied_rv": follower.applied_rv(),
                "lag_rvs": follower.lag_estimate(),
                "epoch": follower.epoch()}

    def retry_after(self) -> float:
        """Hint for 503 responses: one election round."""
        return max(1.0, self.renew_interval)

    def follower_report(self) -> Optional[Dict]:
        with self._lock:
            follower = self._follower
        return follower.report() if follower is not None else None

    def report(self) -> Dict:
        lease = self.board.peek()
        rep = {
            "name": self.name,
            "role": self.role(),
            "token": self.elector.token(),
            "lease_holder": lease["holder"],
            "lease_token": lease["token"],
            "takeovers": self.takeovers,
            "demotions": self.demotions,
            "lease_pushes": self.lease_pushes,
            "push_errors": self.push_errors,
            "bootstrap_failures": self.bootstrap_failures,
            "bootstrap_skips": self.bootstrap_skips,
            "fence_floor": self.store.fence_floor(),
            "accepts_writes": self.accepts_writes(),
        }
        stale = self.staleness()
        if stale is not None:
            rep["staleness"] = stale
        return rep


def elector_for_replicaset(rs, identity: str = "elector-0",
                           lease_duration: float = 15.0,
                           retry_period: float = 5.0,
                           clock=None) -> EpochElector:
    """Wire an EpochElector to an in-process ReplicaSet: acquisitions
    promote the federation epoch through ``rs.promote_epoch`` (the lease
    itself lives in the leader store, so it replicates like any object).
    """
    return EpochElector(
        identity=identity, store=rs.source.store,
        on_promote=rs.promote_epoch,
        lease_duration=lease_duration, retry_period=retry_period,
        clock=clock)


__all__: List[str] = [
    "EpochElector", "LeaseBoard", "FederationMember",
    "elector_for_replicaset", "URL_KEY", "DEFAULT_LEASE_NAME",
]
