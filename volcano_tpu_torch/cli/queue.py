"""vcctl queue subcommands (reference: pkg/cli/queue/{create,list,get,delete,
operate}.go).

The port's own copy of volcano_tpu/cli/queue.py."""

from __future__ import annotations

import time

from ..models.objects import Command, JobAction, ObjectMeta, Queue, QueueSpec
from .util import parse_resource_list, print_table

ACTION_OPEN = "open"
ACTION_CLOSE = "close"
ACTION_UPDATE = "update"


def create_queue(client, name: str, weight: int = 1,
                 capability: str = "") -> str:
    """pkg/cli/queue/create.go"""
    if not name:
        raise ValueError("queue name must be specified")
    queue = Queue(metadata=ObjectMeta(name=name),
                  spec=QueueSpec(
                      weight=weight,
                      capability=parse_resource_list(capability)
                      if capability else None))
    client.create("queues", queue)
    return f"create queue {name} successfully"


def _queue_rows(queues):
    rows = []
    for q in queues:
        rows.append([q.metadata.name, q.spec.weight, q.status.state or "Open",
                     q.status.inqueue, q.status.pending, q.status.running,
                     q.status.unknown])
    return rows


def list_queues(client) -> str:
    """pkg/cli/queue/list.go"""
    queues = sorted(client.list("queues"), key=lambda q: q.metadata.name)
    return print_table(
        ["Name", "Weight", "State", "Inqueue", "Pending", "Running", "Unknown"],
        _queue_rows(queues))


def get_queue(client, name: str) -> str:
    """pkg/cli/queue/get.go"""
    if not name:
        raise ValueError("queue name must be specified")
    q = client.get("queues", name)
    if q is None:
        raise ValueError(f"queue {name} not found")
    return print_table(
        ["Name", "Weight", "State", "Inqueue", "Pending", "Running", "Unknown"],
        _queue_rows([q]))


def delete_queue(client, name: str) -> str:
    """pkg/cli/queue/delete.go — admission enforces Closed-state-only."""
    if not name:
        raise ValueError("queue name must be specified")
    client.delete("queues", name)
    return f"delete queue {name} successfully"


def operate_queue(client, name: str, action: str, weight: int = 0) -> str:
    """pkg/cli/queue/operate.go:65-99 — open/close via Command, update=weight."""
    if not name:
        raise ValueError("queue name must be specified")
    if action == ACTION_OPEN:
        cmd_action = JobAction.OPEN_QUEUE
    elif action == ACTION_CLOSE:
        cmd_action = JobAction.CLOSE_QUEUE
    elif action == ACTION_UPDATE:
        if weight <= 0:
            raise ValueError(
                f"when {ACTION_UPDATE} a queue, weight must be specified, "
                f"the value must be greater than 0")
        q = client.get("queues", name)
        if q is None:
            raise ValueError(f"queue {name} not found")
        q.spec.weight = weight
        client.update("queues", q)
        return f"update queue {name} successfully"
    else:
        raise ValueError(
            f"invalid queue action {action!r}, valid actions are "
            f"{ACTION_OPEN}, {ACTION_CLOSE}, {ACTION_UPDATE}")
    if client.get("queues", name) is None:
        raise ValueError(f"queue {name} not found")
    client.create("commands", Command(
        metadata=ObjectMeta(
            name=f"{name}-{action}-{int(time.time() * 1000) % 100000}"),
        action=cmd_action, target_kind="Queue", target_name=name))
    return f"{action} queue {name} successfully"
