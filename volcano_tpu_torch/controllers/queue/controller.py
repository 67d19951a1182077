"""Queue controller: rolls PodGroup phases into Queue.status and drives the
open/closed state machine via Command objects
(reference: pkg/controllers/queue/{queue_controller,queue_controller_action,
queue_controller_handler}.go).

The port's own copy of volcano_tpu/controllers/queue/controller.py.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, Set

from ...apiserver.store import ConflictError
from ...models import objects as obj
from ...models.objects import (JobAction, PodGroup, PodGroupPhase, Queue,
                               QueueState, QueueStatus)
from ..framework import Controller
from .state import new_state


class QueueController(Controller):
    NAME = "queue-controller"

    def __init__(self):
        self.store = None
        self.queue_work: deque = deque()
        self._pending: Set[tuple] = set()
        self.command_queue: deque = deque()
        # queue name -> set of podgroup keys (queue_controller.go podGroups map)
        self.pod_groups: Dict[str, Set[str]] = {}
        self._watches: list = []

    def initialize(self, store) -> None:
        self.store = store
        self._watches = [
            store.watch("queues", self._add_queue, self._update_queue,
                        self._delete_queue),
            store.watch("podgroups", self._add_pod_group, self._update_pod_group,
                        self._delete_pod_group),
            store.watch("commands", self._add_command, None, None,
                        filter_fn=lambda c: c.target_kind == "Queue"),
        ]

    def stop(self) -> None:
        for w in self._watches:
            self.store.unwatch(w)
        self._watches = []

    # -- handlers (queue_controller_handler.go) -----------------------------

    def _enqueue(self, name: str, action: str = "") -> None:
        key = (name, action)
        if key not in self._pending:
            self._pending.add(key)
            self.queue_work.append(key)

    def _add_queue(self, queue: Queue) -> None:
        self._enqueue(queue.metadata.name)

    def _update_queue(self, old: Queue, new: Queue) -> None:
        if old.metadata.resource_version != new.metadata.resource_version:
            self._enqueue(new.metadata.name)

    def _delete_queue(self, queue: Queue) -> None:
        self.pod_groups.pop(queue.metadata.name, None)

    def _add_pod_group(self, pg: PodGroup) -> None:
        key = f"{pg.metadata.namespace}/{pg.metadata.name}"
        self.pod_groups.setdefault(pg.spec.queue, set()).add(key)
        self._enqueue(pg.spec.queue)

    def _update_pod_group(self, old: PodGroup, new: PodGroup) -> None:
        if old.spec.queue != new.spec.queue:
            key = f"{old.metadata.namespace}/{old.metadata.name}"
            self.pod_groups.get(old.spec.queue, set()).discard(key)
            self._add_pod_group(new)
        elif old.status.phase != new.status.phase:
            self._enqueue(new.spec.queue)

    def _delete_pod_group(self, pg: PodGroup) -> None:
        key = f"{pg.metadata.namespace}/{pg.metadata.name}"
        self.pod_groups.get(pg.spec.queue, set()).discard(key)
        self._enqueue(pg.spec.queue)

    def _add_command(self, cmd: obj.Command) -> None:
        self.command_queue.append(cmd)

    # -- work loop ----------------------------------------------------------

    def process_pending(self, max_items: int = 10000) -> int:
        processed = 0
        while self.command_queue:
            cmd = self.command_queue.popleft()
            try:
                self.store.delete("commands", cmd.metadata.name,
                                  cmd.metadata.namespace, skip_admission=True)
            except KeyError:
                continue
            self._enqueue(cmd.target_name, cmd.action)
            processed += 1
        n = len(self.queue_work)
        for _ in range(min(n, max_items)):
            key = self.queue_work.popleft()
            self._pending.discard(key)
            name, action = key
            queue = self.store.get("queues", name)
            if queue is None:
                continue
            state = new_state(queue, self._sync_queue, self._open_queue,
                              self._close_queue)
            try:
                state.execute(action or JobAction.SYNC_QUEUE)
            except (ConflictError, KeyError):
                # another writer raced our get->update round trip; requeue to
                # retry against the fresh object (the reference's workqueue
                # AddRateLimited on sync failure)
                self._enqueue(name, action)
            processed += 1
        return processed

    # -- actions (queue_controller_action.go) --------------------------------

    def _pod_group_keys(self, queue_name: str) -> list:
        return sorted(self.pod_groups.get(queue_name, set()))

    def _sync_queue(self, queue: Queue, update_state) -> None:
        """Count podgroups per phase into the status (action.go:35-84)."""
        pg_keys = self._pod_group_keys(queue.metadata.name)
        status = QueueStatus()
        for key in pg_keys:
            ns, name = key.split("/", 1)
            pg = self.store.get("podgroups", name, ns)
            if pg is None:
                continue
            phase = pg.status.phase
            if phase == PodGroupPhase.PENDING:
                status.pending += 1
            elif phase == PodGroupPhase.RUNNING:
                status.running += 1
            elif phase == PodGroupPhase.UNKNOWN:
                status.unknown += 1
            elif phase == PodGroupPhase.INQUEUE:
                status.inqueue += 1
        if update_state is not None:
            update_state(status, pg_keys)
        else:
            status.state = queue.status.state
        if status == queue.status:
            return
        queue.status = status
        self.store.update("queues", queue, skip_admission=True)

    def _open_queue(self, queue: Queue, update_state) -> None:
        """action.go:86-134"""
        if queue.status.state != QueueState.OPEN:
            queue.status.state = QueueState.OPEN
            self.store.update("queues", queue, skip_admission=True)
            self.store.record_event("queues", queue, "Normal",
                                    JobAction.OPEN_QUEUE, "Open queue succeed")
        self._sync_queue(queue, update_state)

    def _close_queue(self, queue: Queue, update_state) -> None:
        """action.go:136-184"""
        if queue.status.state not in (QueueState.CLOSED, QueueState.CLOSING):
            queue.status.state = QueueState.CLOSED
            self.store.update("queues", queue, skip_admission=True)
            self.store.record_event("queues", queue, "Normal",
                                    JobAction.CLOSE_QUEUE, "Close queue succeed")
        self._sync_queue(queue, update_state)
