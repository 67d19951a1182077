"""Leader election over the object store (counterpart of
volcano_tpu/utils/leaderelection.py; reference: the scheduler's
resource-lock leader election, cmd/scheduler/app/server.go:45-96
leaderelection.RunOrDie).

Candidates race on a lease held in a ConfigMap of LOCK_NAMESPACE (the
reference's configmap resource lock). The holder renews it before
``lease_duration`` runs out; a standby takes over once it has lapsed.
The callbacks are client-go's: on_started_leading, on_stopped_leading,
on_new_leader.

Fencing (docs/design/failover.md): the lease carries a monotonic fencing
token (FENCE_KEY), raised by every acquisition of a fresh elector
incarnation: a standby's takeover, and also a restarted process taking
back its own lease (the old incarnation may have writes in flight). On
acquisition the elector announces its token to the store
(``advance_fence``) before the leading callback runs; from then on the
store refuses writes stamped with an older token (FencedError), so a
deposed leader in the middle of a bind flush cannot bind after the
takeover. Renewals keep the incarnation's token.

The lease arithmetic reads the injected clock (the store's by default),
so ``step()`` drives elections deterministically on a FakeClock; ``run``
(started by ``start``) is the wall-clock loop of a deployment.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

from ..apiserver.store import ConflictError
from ..models.objects import ConfigMap, ObjectMeta
from .clock import Clock

LOCK_NAMESPACE = "volcano-system"

HOLDER_KEY = "holderIdentity"
RENEW_KEY = "renewTime"
FENCE_KEY = "fencingToken"


class LeaderElector:
    def __init__(self, store, identity: str,
                 lease_name: str = "vc-scheduler",
                 lease_duration: float = 15.0,
                 retry_period: float = 5.0,
                 on_started_leading: Optional[Callable] = None,
                 on_stopped_leading: Optional[Callable] = None,
                 on_new_leader: Optional[Callable[[str], None]] = None,
                 clock: Optional[Clock] = None):
        self.store = store
        self.identity = identity
        self.lease_name = lease_name
        self.lease_duration = lease_duration
        self.retry_period = retry_period
        self.on_started_leading = on_started_leading
        self.on_stopped_leading = on_stopped_leading
        self.on_new_leader = on_new_leader
        self.is_leader = False
        # this incarnation's fencing token, None until its first
        # acquisition; never inherited from the lease, so a restarted
        # process always raises it
        self.fencing_token: Optional[int] = None
        self.clock = clock if clock is not None else store.clock
        self._observed_leader = ""
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- the lock ------------------------------------------------------------

    def _next_token(self, lease) -> int:
        """The token this write carries: a new acquisition (the first, one
        after losing the lease, this incarnation's first) raises the
        lease's stored token; a renewal keeps the incarnation's."""
        stored = int(lease.data.get(FENCE_KEY, "0")) if lease is not None \
            else 0
        if self.fencing_token is None or not self.is_leader:
            return max(stored, self.fencing_token or 0) + 1
        return self.fencing_token

    def _try_acquire_or_renew(self) -> bool:
        now = self.clock.now()
        lease = self.store.get("configmaps", self.lease_name, LOCK_NAMESPACE)
        if lease is None:
            token = self._next_token(None)
            try:
                self.store.create("configmaps", ConfigMap(
                    metadata=ObjectMeta(name=self.lease_name,
                                        namespace=LOCK_NAMESPACE),
                    data={HOLDER_KEY: self.identity, RENEW_KEY: str(now),
                          FENCE_KEY: str(token)}))
            except KeyError:
                return False   # another candidate created it first
            self.fencing_token = token
            return True
        holder = lease.data.get(HOLDER_KEY, "")
        renew = float(lease.data.get(RENEW_KEY, "0"))
        if holder and holder != self.identity and \
                now - renew < self.lease_duration:
            self._observe(holder)
            return False
        # our lease, or a lapsed one: take or renew it. The write is
        # optimistic: a concurrent standby loses on the resource version.
        token = self._next_token(lease)
        lease.data[HOLDER_KEY] = self.identity
        lease.data[RENEW_KEY] = str(now)
        lease.data[FENCE_KEY] = str(token)
        try:
            self.store.update("configmaps", lease)
        except (ConflictError, KeyError):
            return False
        self.fencing_token = token
        return True

    def _observe(self, holder: str) -> None:
        if holder != self._observed_leader:
            self._observed_leader = holder
            if self.on_new_leader is not None:
                self.on_new_leader(holder)

    def _announce_fence(self) -> None:
        """Raise the store's write fence to this incarnation's token: from
        here on, writes stamped by any earlier incarnation are refused."""
        if self.fencing_token is not None:
            self.store.advance_fence(self.fencing_token)

    # -- the loop ------------------------------------------------------------

    def step(self) -> bool:
        """One election round; returns whether this candidate leads. The
        deterministic entry point for tests and for external pacing."""
        acquired = self._try_acquire_or_renew()
        if acquired and not self.is_leader:
            self.is_leader = True
            # fence before the leading callback: by the time this
            # candidate schedules, the old incarnation is shut out
            self._announce_fence()
            self._observe(self.identity)
            if self.on_started_leading is not None:
                self.on_started_leading()
        elif not acquired and self.is_leader:
            self.is_leader = False
            if self.on_stopped_leading is not None:
                self.on_stopped_leading()
        return self.is_leader

    def run(self) -> None:
        while not self._stop.is_set():
            self.step()
            self._stop.wait(self.retry_period)
        self.release()

    def start(self) -> threading.Thread:
        self._thread = threading.Thread(
            target=self.run, name=f"elector:{self.identity}", daemon=True)
        self._thread.start()
        return self._thread

    def stop(self, timeout: Optional[float] = None) -> None:
        """End the loop (which then releases the lease); with ``timeout``
        also wait that long for its thread."""
        self._stop.set()
        if timeout is not None and self._thread is not None:
            self._thread.join(timeout)

    def release(self) -> None:
        """Give the lease up (on shutdown), so that a standby takes over
        at its next round instead of after the lease has lapsed.

        ``on_stopped_leading`` runs, and ``is_leader`` drops, before the
        lease is cleared in the store: a standby that sees the freed lease
        never runs while this candidate still acts as leader. The fencing
        token stays in the lease: tokens rise across holders."""
        if not self.is_leader:
            return
        self.is_leader = False
        if self.on_stopped_leading is not None:
            self.on_stopped_leading()
        lease = self.store.get("configmaps", self.lease_name, LOCK_NAMESPACE)
        if lease is not None and lease.data.get(HOLDER_KEY) == self.identity:
            lease.data[HOLDER_KEY] = ""
            lease.data[RENEW_KEY] = "0"
            try:
                self.store.update("configmaps", lease)
            except (ConflictError, KeyError):
                pass   # the lease moved on; nothing of ours to clear
