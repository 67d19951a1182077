"""Queue state machine (reference: pkg/controllers/queue/state/*.go).

States Open/Closed/Closing/Unknown respond to OpenQueue/CloseQueue/Sync
actions; transitions are executed through injected sync/open/close callables
that receive an ``update_state(status, pod_group_list)`` callback.

The port's own copy of volcano_tpu/controllers/queue/state.py.
"""

from __future__ import annotations

from typing import Callable, List, Optional

from ...models.objects import JobAction, Queue, QueueState, QueueStatus

UpdateQueueStatusFn = Callable[[QueueStatus, List[str]], None]
QueueActionFn = Callable[[Queue, Optional[UpdateQueueStatusFn]], None]


class State:
    def __init__(self, queue: Queue, sync_queue: QueueActionFn,
                 open_queue: QueueActionFn, close_queue: QueueActionFn):
        self.queue = queue
        self.sync_queue = sync_queue
        self.open_queue = open_queue
        self.close_queue = close_queue

    def execute(self, action: str) -> None:
        raise NotImplementedError

    # shared closing/closed decision (state/open.go:36-41 etc.)

    @staticmethod
    def _close_update(status: QueueStatus, pod_groups: List[str]) -> None:
        status.state = QueueState.CLOSED if not pod_groups else QueueState.CLOSING


class OpenState(State):
    """state/open.go"""

    def execute(self, action: str) -> None:
        if action == JobAction.OPEN_QUEUE:
            self.sync_queue(self.queue, lambda s, pgs: setattr(s, "state", QueueState.OPEN))
        elif action == JobAction.CLOSE_QUEUE:
            self.close_queue(self.queue, self._close_update)
        else:
            def update(status: QueueStatus, pod_groups: List[str]) -> None:
                spec_state = self.queue.status.state
                if not spec_state or spec_state == QueueState.OPEN:
                    status.state = QueueState.OPEN
                elif spec_state == QueueState.CLOSED:
                    self._close_update(status, pod_groups)
                else:
                    status.state = QueueState.UNKNOWN
            self.sync_queue(self.queue, update)


class ClosedState(State):
    """state/closed.go"""

    def execute(self, action: str) -> None:
        if action == JobAction.OPEN_QUEUE:
            self.open_queue(self.queue, lambda s, pgs: setattr(s, "state", QueueState.OPEN))
        elif action == JobAction.CLOSE_QUEUE:
            self.sync_queue(self.queue, lambda s, pgs: setattr(s, "state", QueueState.CLOSED))
        else:
            def update(status: QueueStatus, pod_groups: List[str]) -> None:
                spec_state = self.queue.status.state
                if spec_state == QueueState.OPEN:
                    status.state = QueueState.OPEN
                elif not spec_state or spec_state == QueueState.CLOSED:
                    status.state = QueueState.CLOSED
                else:
                    status.state = QueueState.UNKNOWN
            self.sync_queue(self.queue, update)


class ClosingState(State):
    """state/closing.go"""

    def execute(self, action: str) -> None:
        if action == JobAction.OPEN_QUEUE:
            self.open_queue(self.queue, lambda s, pgs: setattr(s, "state", QueueState.OPEN))
        elif action == JobAction.CLOSE_QUEUE:
            self.sync_queue(self.queue, self._close_update)
        else:
            def update(status: QueueStatus, pod_groups: List[str]) -> None:
                spec_state = self.queue.status.state
                if spec_state == QueueState.OPEN:
                    status.state = QueueState.OPEN
                elif spec_state == QueueState.CLOSING:
                    self._close_update(status, pod_groups)
                else:
                    status.state = QueueState.UNKNOWN
            self.sync_queue(self.queue, update)


class UnknownState(State):
    """state/unknown.go"""

    def execute(self, action: str) -> None:
        if action == JobAction.OPEN_QUEUE:
            self.open_queue(self.queue, lambda s, pgs: setattr(s, "state", QueueState.OPEN))
        elif action == JobAction.CLOSE_QUEUE:
            self.close_queue(self.queue, self._close_update)
        else:
            self.sync_queue(self.queue, lambda s, pgs: setattr(s, "state", QueueState.UNKNOWN))


_STATES = {
    QueueState.OPEN: OpenState,
    QueueState.CLOSED: ClosedState,
    QueueState.CLOSING: ClosingState,
    QueueState.UNKNOWN: UnknownState,
}


def new_state(queue: Queue, sync_queue: QueueActionFn, open_queue: QueueActionFn,
              close_queue: QueueActionFn) -> State:
    cls = _STATES.get(queue.status.state, OpenState)
    return cls(queue, sync_queue, open_queue, close_queue)
