"""Statement: the transactional operation log enabling gang all-or-nothing
(counterpart of volcano_tpu/framework/statement.py; reference:
pkg/scheduler/framework/statement.go).

Evict/Pipeline/Allocate are staged against session state only; Commit
replays them against the cache (real binds and evictions), Discard rolls
them back in reverse order (statement.go:350-393).
"""

from __future__ import annotations

from typing import List, Optional

from ..models.job_info import TaskInfo, TaskStatus


class _Operation:
    def __init__(self, name: str, task: TaskInfo, reason: str = ""):
        self.name = name
        self.task = task
        self.reason = reason


class _BatchOperation:
    """One staged gang: [(task, node_info, pipelined)] applied together."""

    name = "batch"
    applied = True
    # set by Session._apply_deferred when a deferred apply failed and the
    # gang was dropped: commit must not bind it, discard must not un-stage it
    dead = False
    # set by _commit_batch once the gang's binds went to the cache: a later
    # failed deferred apply must not drop the gang then (the pods are
    # binding, so the delta accounting stands)
    committed = False

    def __init__(self, job, items):
        self.job = job
        self.items = items


class _DeferredBatch(_BatchOperation):
    """A staged gang whose object-model apply is deferred
    (Session.materialize). Until ``apply`` runs, the placements exist as
    ``task.node_name`` strings plus the job's deferred_alloc/deferred_pipe
    deltas; statuses stay Pending and node accounting is untouched."""

    applied = False

    def apply(self, ssn) -> None:
        """The postponed staging: bulk status moves, per-node bulk
        accounting, pod spec writes. All or nothing: on a failure the
        partial mutations are undone, the deltas stay in force and the
        error re-raises; ``applied`` and the deltas change only after full
        success.

        Keep in step with AllocateAction._stage_bulk's eager branch, which
        stages the same mutations across jobs."""
        if self.applied:
            return
        job = self.job
        alloc = [t for t, _, p in self.items if not p]
        pipe = [t for t, _, p in self.items if p]
        moved: List = []
        added: List = []
        try:
            if alloc:
                job.move_tasks_status_bulk(alloc, TaskStatus.Allocated)
                moved.append(alloc)
            if pipe:
                job.move_tasks_status_bulk(pipe, TaskStatus.Pipelined)
                moved.append(pipe)
            groups: dict = {}
            for task, node, pipelined in self.items:
                g = groups.setdefault((id(node), pipelined),
                                      (node, pipelined, []))
                g[2].append(task)
            for node, pipelined, tasks in groups.values():
                node.add_tasks_bulk(tasks, pipelined, share_objects=True)
                added.append((node, pipelined, tasks))
                if not pipelined:
                    name = node.name
                    for t in tasks:
                        t.pod.spec.node_name = name
        except BaseException:
            for node, pipelined, tasks in reversed(added):
                for t in tasks:
                    node.remove_task(t)
                    t.node_name = node.name   # keep the deferred marker
                    if not pipelined:
                        t.pod.spec.node_name = ""
            for tasks in reversed(moved):
                job.move_tasks_status_bulk(tasks, TaskStatus.Pending)
            raise
        self.applied = True
        job.deferred_alloc -= len(alloc)
        job.deferred_pipe -= len(pipe)

    def drop(self, ssn) -> None:
        """Discard before the apply: reverse the deltas and the
        node_name markers and fire the deallocate events; nothing else
        was mutated. Marks the op applied so a queued materialize skips
        it."""
        self.applied = True
        job = self.job
        alloc_n = sum(1 for _, _, p in self.items if not p)
        job.deferred_alloc -= alloc_n
        job.deferred_pipe -= len(self.items) - alloc_n
        for task, _, _ in self.items:
            task.node_name = ""
        ssn._fire_deallocate_batch(job, [t for t, _, _ in self.items])


class Statement:
    def __init__(self, ssn):
        self.ssn = ssn
        self.operations: List = []

    # -- evict (statement.go:61-134) --------------------------------------

    def evict(self, reclaimee: TaskInfo, reason: str) -> None:
        """Stage an eviction: session state flips to Releasing now; the pod
        delete happens at Commit."""
        job = self.ssn.jobs.get(reclaimee.job)
        if job is None:
            raise KeyError(f"failed to find job {reclaimee.job}")
        node = self.ssn.nodes.get(reclaimee.node_name)
        if node is None:
            raise KeyError(f"failed to find node {reclaimee.node_name}")
        job.move_task_status(reclaimee, TaskStatus.Releasing)
        node.transition_task(reclaimee)
        self.ssn.touched_jobs.add(reclaimee.job)
        self.ssn.touched_nodes.add(reclaimee.node_name)
        self.ssn._fire_deallocate(reclaimee)
        self.operations.append(_Operation("evict", reclaimee, reason))

    def _unevict(self, reclaimee: TaskInfo) -> None:
        job = self.ssn.jobs.get(reclaimee.job)
        node = self.ssn.nodes.get(reclaimee.node_name)
        if job is not None:
            job.move_task_status(reclaimee, TaskStatus.Running)
        if node is not None:
            node.transition_task(reclaimee)
        self.ssn._fire_allocate(reclaimee)

    # -- pipeline (statement.go:136-230) ----------------------------------

    def pipeline(self, task: TaskInfo, hostname: str) -> None:
        job = self.ssn.jobs.get(task.job)
        if job is None:
            raise KeyError(f"failed to find job {task.job}")
        node = self.ssn.nodes.get(hostname)
        if node is None:
            raise KeyError(f"failed to find node {hostname}")
        job.update_task_status(task, TaskStatus.Pipelined)
        task.node_name = hostname
        node.add_task(task)
        self.ssn.touched_jobs.add(task.job)
        self.ssn.touched_nodes.add(hostname)
        self.ssn._fire_allocate(task)
        self.operations.append(_Operation("pipeline", task))

    def _unpipeline(self, task: TaskInfo) -> None:
        job = self.ssn.jobs.get(task.job)
        node = self.ssn.nodes.get(task.node_name)
        if node is not None:
            node.remove_task(task)
        if job is not None:
            job.update_task_status(task, TaskStatus.Pending)
        task.node_name = ""
        self.ssn._fire_deallocate(task)

    # -- allocate (statement.go:232-348) ----------------------------------

    def allocate(self, task: TaskInfo, node_info) -> None:
        hostname = node_info.name if hasattr(node_info, "name") else str(node_info)
        if self.ssn.cache is not None:
            self.ssn.plan_volumes(
                task, hostname,
                getattr(self.ssn.nodes.get(hostname), "node", None))
        job = self.ssn.jobs.get(task.job)
        if job is None:
            raise KeyError(f"failed to find job {task.job}")
        node = self.ssn.nodes.get(hostname)
        if node is None:
            raise KeyError(f"failed to find node {hostname}")
        task.pod.spec.node_name = hostname
        job.update_task_status(task, TaskStatus.Allocated)
        task.node_name = hostname
        node.add_task(task)
        self.ssn.touched_jobs.add(task.job)
        self.ssn.touched_nodes.add(hostname)
        self.ssn._fire_allocate(task)
        self.operations.append(_Operation("allocate", task))

    def _unallocate(self, task: TaskInfo) -> None:
        if self.ssn.cache is not None and task.pod_volumes is not None:
            self.ssn.cache.volume_binder.release_volumes(task,
                                                         task.pod_volumes)
            task.pod_volumes = None
        job = self.ssn.jobs.get(task.job)
        node = self.ssn.nodes.get(task.node_name)
        if node is not None:
            node.remove_task(task)
        if job is not None:
            job.update_task_status(task, TaskStatus.Pending)
        task.node_name = ""
        task.pod.spec.node_name = ""
        self.ssn._fire_deallocate(task)

    # -- batch allocate (the hot path's staging) ---------------------------

    def allocate_batch(self, job, placements, keep_partial: bool = False) -> None:
        """Stage a whole gang's placements: ``[(task, node_info,
        pipelined)]``.

        Semantically identical to calling :meth:`pipeline` /
        :meth:`allocate` once per task, but the plugin event round is
        batched (one share recompute per gang instead of per task —
        EventHandler.batch_allocate_func). Tasks whose pods mount volumes
        take the per-task path because volume planning can fail per task.

        On a failed placement: with ``keep_partial`` (best-effort surplus,
        the reference's break-on-first-failure loop) the already-staged
        prefix is kept; otherwise everything — including the failing
        task's partial mutations — is rolled back and the error re-raised."""
        ssn = self.ssn
        fast = []
        for task, node, pipelined in placements:
            if ssn.cache is not None and task.has_volumes:
                if pipelined:
                    self.pipeline(task, node.name)
                else:
                    self.allocate(task, node)
                continue
            fast.append((task, node, pipelined))
        if not fast:
            return

        applied = self._stage_fast_seq(fast, keep_partial)
        if applied:
            self._touch_items(job, applied)
            ssn._fire_allocate_batch(job, [t for t, _, _ in applied])
            self.operations.append(_BatchOperation(job, applied))

    def _touch_items(self, job, items) -> None:
        """Mark a staged gang in the session's touched sets: the job and
        every node it landed on. A gang rolled back later stays marked (a
        needless re-clone is always sound)."""
        ssn = self.ssn
        ssn.touched_jobs.add(job.uid)
        touched_nodes = ssn.touched_nodes
        for _, node, _ in items:
            touched_nodes.add(node.name)

    def _stage_fast_seq(self, fast, keep_partial: bool) -> list:
        """Sequential per-task staging: all-or-nothing by default, prefix
        (keep-partial) semantics on request. This is the fallback path —
        the allocate action's phase-level bulk apply
        (AllocateAction._stage_bulk) handles the hot case."""
        ssn = self.ssn

        def undo(task, node, pipelined, registered: bool) -> None:
            """Revert one staged placement (add_task itself is atomic on
            error, so an unregistered task never touched the node)."""
            if registered:
                node.remove_task(task)
            job_of = ssn.jobs.get(task.job)
            if job_of is not None and task.status != TaskStatus.Pending:
                job_of.move_task_status(task, TaskStatus.Pending)
            task.node_name = ""
            if not pipelined:
                task.pod.spec.node_name = ""

        applied = []
        failure: Optional[BaseException] = None
        for task, node, pipelined in fast:
            job_of = ssn.jobs.get(task.job)
            try:
                if job_of is None:
                    raise KeyError(f"failed to find job {task.job}")
                if pipelined:
                    job_of.move_task_status(task, TaskStatus.Pipelined)
                else:
                    task.pod.spec.node_name = node.name
                    job_of.move_task_status(task, TaskStatus.Allocated)
                task.node_name = node.name
                node.add_task(task)
            except Exception as e:
                undo(task, node, pipelined, registered=False)
                failure = e
                break
            applied.append((task, node, pipelined))
        if failure is not None and not keep_partial:
            for task, node, pipelined in reversed(applied):
                undo(task, node, pipelined, registered=True)
            raise failure
        return applied

    def record_batch(self, job, items, total=None) -> None:
        """Register an externally staged gang (the allocate action's
        phase-level bulk apply) for commit/discard: fires the batched
        plugin events and appends the operation, exactly like
        :meth:`allocate_batch` does after its own staging. ``total`` may
        carry the gang's precomputed resource sum."""
        self._touch_items(job, items)
        self.ssn._fire_allocate_batch(job, [t for t, _, _ in items], total)
        self.operations.append(_BatchOperation(job, items))

    def record_batch_deferred(self, job, items, total=None) -> None:
        """Register a gang whose object-model staging is deferred: fires
        the batched plugin events now (the handlers read task.resreq and
        node_name, both set), adds the job's readiness deltas and queues
        the apply for Session.materialize."""
        op = _DeferredBatch(job, items)
        self._touch_items(job, items)
        alloc_n = sum(1 for _, _, p in items if not p)
        job.deferred_alloc += alloc_n
        job.deferred_pipe += len(items) - alloc_n
        self.ssn._fire_allocate_batch(job, [t for t, _, _ in items], total)
        self.ssn.defer_apply(op)
        self.operations.append(op)

    def _unbatch(self, op: _BatchOperation) -> None:
        for task, node, pipelined in reversed(op.items):
            node.remove_task(task)
            job_of = self.ssn.jobs.get(task.job)
            if job_of is not None:
                job_of.move_task_status(task, TaskStatus.Pending)
            task.node_name = ""
            if not pipelined:
                task.pod.spec.node_name = ""
        self.ssn._fire_deallocate_batch(op.job, [t for t, _, _ in op.items])

    def _commit_batch(self, op: _BatchOperation) -> None:
        """Dispatch a staged gang: allocated tasks bind through the cache
        in one locked pass (cache.bind_batch); pipelined ones stay
        session-state only, exactly like the per-task ops."""
        ssn = self.ssn
        if op.dead:
            return   # its deferred apply failed and the gang was dropped
        to_bind = [(task, node.name) for task, node, pipelined in op.items
                   if not pipelined]
        if not to_bind:
            return
        if ssn.cache is not None:
            accepted = ssn.cache.bind_batch(to_bind)
        else:
            accepted = [t for t, _ in to_bind]
        if not accepted:
            return
        op.committed = True
        if not op.applied:
            return   # statuses still deferred; the deltas carry them
        job_of = ssn.jobs.get(op.job.uid)
        if job_of is not None and \
                all(t.job == op.job.uid for t in accepted):
            job_of.move_tasks_status_bulk(accepted, TaskStatus.Binding)
        else:   # mixed/foreign tasks: per-task fallback
            for task in accepted:
                job_t = ssn.jobs.get(task.job)
                if job_t is not None:
                    job_t.move_task_status(task, TaskStatus.Binding)

    # -- commit / discard (statement.go:350-393) ---------------------------

    def discard(self) -> None:
        """Roll back all staged operations in reverse order."""
        for op in reversed(self.operations):
            if op.name == "evict":
                self._unevict(op.task)
            elif op.name == "pipeline":
                self._unpipeline(op.task)
            elif op.name == "allocate":
                self._unallocate(op.task)
            elif op.name == "batch":
                if op.dead:
                    continue   # already dropped by Session._apply_deferred
                if op.applied:
                    self._unbatch(op)
                else:
                    # deferred and never applied: reverse the deltas;
                    # drop() marks the op applied, so its queued
                    # materialize entry does nothing
                    op.drop(self.ssn)
        self.operations = []

    def commit(self) -> None:
        """Replay staged operations against the cache, in order.
        Consecutive evicts dispatch as one ``cache.evict_batch``; pipelined
        tasks stay session-state only until resources actually release, so
        they do not break a run of evicts."""
        ops, self.operations = self.operations, []
        evicts: List[_Operation] = []

        def flush_evicts() -> None:
            if evicts:
                self.ssn.cache.evict_batch([(e.task, e.reason)
                                            for e in evicts])
                evicts.clear()

        for op in ops:
            if op.name == "evict":
                if self.ssn.cache is not None:
                    evicts.append(op)
                continue
            if op.name == "pipeline":
                continue
            flush_evicts()
            if op.name == "allocate":
                try:
                    self.ssn.dispatch(op.task, op.task.pod_volumes)
                except KeyError:
                    pass
            elif op.name == "batch":
                self._commit_batch(op)
        flush_evicts()
