"""The gang-allocate loop in plain PyTorch (counterpart of
volcano_tpu/ops/allocate.py).

One step places one task of the current job: predicates, scoring and the
best-node argmax over every node, against the node state that every earlier
placement changed. When the job's span ends, the gang check keeps its
placements or restores the checkpoint, charges the queue and namespace, and
the next job is chosen by the two-level rule: the namespace first (live
weighted dominant share, or the static encode order), then the least-share
non-overused queue inside it, then that (namespace, queue) pool's next job.

``gang_allocate`` here is the plain version of the CUDA kernel
(csrc/gang_allocate.cu): the CPU tests run it, and it is what the kernel is
held against on the card. It is a Python loop over the task steps, so it is
slow at full size; ops/cuda_allocate.py is the path that runs there.

``gang_allocate_chunked`` computes the same function by the kernel's own
decision procedure (a top-C candidate table, refreshed by rule), so that the CPU tests can hold that procedure to the
plain loop and to the JAX package's chunked scan. Nothing on the main path
calls it.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from .score import ScoreWeights, node_score

NEG = -1e30
BIG = 1e30


class AllocState(NamedTuple):
    """Node and fair-share state after the last step."""
    idle: torch.Tensor       # [N, R] f32
    future: torch.Tensor     # [N, R] f32 = idle + releasing - pipelined
    n_tasks: torch.Tensor    # [N] i32
    q_alloc: torch.Tensor    # [Q, R] f32 live queue allocations
    ns_alloc: torch.Tensor   # [NS, R] f32 live namespace allocations
    p_cursor: torch.Tensor   # [P] i32 jobs taken per pool


def queue_share(q_alloc: torch.Tensor,
                q_deserved: torch.Tensor) -> torch.Tensor:
    """Dominant share per queue: max_r alloc/deserved with 0/0 = 0,
    x/0 = 1; unbudgeted (+inf deserved) dims contribute 0."""
    zero = q_deserved == 0.0
    frac = torch.where(
        torch.isinf(q_deserved), 0.0,
        torch.where(zero, torch.where(q_alloc == 0.0, 0.0, 1.0),
                    q_alloc / torch.where(zero, 1.0, q_deserved)))
    return frac.max(dim=-1).values


def queue_overused(q_alloc: torch.Tensor, q_deserved: torch.Tensor,
                   eps: torch.Tensor) -> torch.Tensor:
    """allocated > deserved in any dimension."""
    le = (q_alloc <= q_deserved + eps[None, :]) | torch.isinf(q_deserved)
    return ~torch.all(le, dim=-1)


def namespace_share(ns_alloc: torch.Tensor, ns_total: torch.Tensor,
                    ns_weight: torch.Tensor) -> torch.Tensor:
    """Weighted dominant share per namespace: max_r alloc/total with
    0/0 = 0, x/0 = 1, divided by the namespace weight."""
    pos = ns_total[None, :] > 0.0
    frac = torch.where(pos, ns_alloc / torch.where(pos, ns_total[None, :], 1.0),
                       torch.where(ns_alloc == 0.0, 0.0, 1.0))
    return frac.max(dim=-1).values / ns_weight


def make_pool_select(queue_deserved, pool_queue, pool_ns, pool_job_start,
                     pool_njobs, ns_weight, ns_total, eps, ns_live: bool
                     ) -> Callable[..., Tuple[torch.Tensor, torch.Tensor]]:
    """The two-level (namespace, queue) job selection: first the namespace
    (live weighted share when ``ns_live``, else the static encode rank),
    then the best non-overused queue with jobs left inside it, by live
    queue share, then that pool's next job. Ties go to the lower index at
    both levels. The returned ``select(q_alloc, ns_alloc, p_cursor)`` gives
    0-d (pool, job), -1/-1 when nothing is selectable."""
    n_ns = ns_weight.shape[0]
    ns_ids = torch.arange(n_ns, device=pool_ns.device)
    pool_in_ns = pool_ns[None, :].long() == ns_ids[:, None]      # [NS, P]
    pool_q = pool_queue.long()

    def select(q_alloc, ns_alloc, p_cursor):
        share = queue_share(q_alloc, queue_deserved)           # [Q]
        over = queue_overused(q_alloc, queue_deserved, eps)    # [Q]
        pool_ok = (p_cursor < pool_njobs) & ~over[pool_q]      # [P]
        ns_has = torch.any(pool_in_ns & pool_ok[None, :], dim=1)
        if ns_live:
            ns_key = namespace_share(ns_alloc, ns_total, ns_weight)
        else:
            ns_key = ns_ids.to(torch.float32)
        ns_sel = torch.argmin(torch.where(ns_has, ns_key, BIG))
        eligible = pool_ok & (pool_ns == ns_sel)
        p = torch.argmin(torch.where(eligible, share[pool_q], BIG))
        ok = ns_has[ns_sel]
        job = pool_job_start[p] + p_cursor[p]
        return (torch.where(ok, p, -1).to(torch.int32),
                torch.where(ok, job, -1).to(torch.int32))
    return select


def slot_row(slot_ok: torch.Tensor, slot: int) -> torch.Tensor:
    """Row ``slot`` of ``slot_ok`` [S+1, N]; a slot outside 0..S admits no
    node, as in the kernel."""
    if 0 <= slot < slot_ok.shape[0]:
        return slot_ok[slot]
    return torch.zeros_like(slot_ok[0])


def gang_allocate(task_group: torch.Tensor,      # [T] i32
                  task_job: torch.Tensor,        # [T] i32 (padding -> sentinel)
                  task_valid: torch.Tensor,      # [T] bool
                  group_req: torch.Tensor,       # [G, R] f32
                  group_mask: torch.Tensor,      # [G, N] bool static predicates
                  group_static_score: torch.Tensor,  # [G, N] f32
                  task_bucket: torch.Tensor,     # [T] i32 topology bucket (-1 none)
                  group_pack_bonus: torch.Tensor,  # [G] f32 per-mate pack score
                  job_min_available: torch.Tensor,   # [J] i32
                  job_ready_base: torch.Tensor,      # [J] i32 occupied count
                  job_task_start: torch.Tensor,      # [J] i32 span start
                  job_n_tasks: torch.Tensor,         # [J] i32 span length
                  job_queue: torch.Tensor,           # [J] i32
                  pool_queue: torch.Tensor,          # [P] i32 queue of pool
                  pool_ns: torch.Tensor,             # [P] i32 namespace of pool
                  pool_job_start: torch.Tensor,      # [P] i32 jobs grouped/pool
                  pool_njobs: torch.Tensor,          # [P] i32
                  ns_weight: torch.Tensor,           # [NS] f32
                  ns_alloc0: torch.Tensor,           # [NS, R] f32
                  ns_total: torch.Tensor,            # [R] f32 cluster total
                  queue_deserved: torch.Tensor,      # [Q, R] f32 (+inf ungated)
                  queue_alloc0: torch.Tensor,        # [Q, R] f32
                  node_idle: torch.Tensor,       # [N, R] f32
                  node_future: torch.Tensor,     # [N, R] f32
                  node_alloc: torch.Tensor,      # [N, R] f32
                  node_ntasks: torch.Tensor,     # [N] i32
                  node_max_tasks: torch.Tensor,  # [N] i32 (0 = uncapped)
                  eps: torch.Tensor,             # [R] f32
                  weights: ScoreWeights,
                  allow_pipeline: bool = True,
                  ns_live: bool = False,
                  task_slot: Optional[torch.Tensor] = None,
                  slot_ok: Optional[torch.Tensor] = None):
    """Returns (assign [T] node or -1, pipelined [T] bool, ready [J] bool,
    kept [J] bool, final AllocState), on the inputs' device.

    ``task_slot`` [T] i32 and ``slot_ok`` [S+1, N] bool are the constraint
    compiler's per-task topology-domain restriction (ops/constraints.py):
    task t may only use the nodes where ``slot_ok[task_slot[t]]`` holds;
    row S is all-true and unconstrained tasks carry S, and a slot outside
    0..S admits no node."""
    T = task_group.shape[0]
    J = job_min_available.shape[0]
    dev = node_idle.device

    select = make_pool_select(queue_deserved, pool_queue, pool_ns,
                              pool_job_start, pool_njobs, ns_weight,
                              ns_total, eps, ns_live)
    # the loop's control flow reads the small integer metadata on the host
    tg = task_group.tolist()
    tv = task_valid.tolist()
    tb = task_bucket.tolist()
    ts = task_slot.tolist() if task_slot is not None else None
    j_start = job_task_start.tolist()
    j_n = job_n_tasks.tolist()
    j_min = job_min_available.tolist()
    j_base = job_ready_base.tolist()
    p_queue = pool_queue.tolist()
    p_ns = pool_ns.tolist()

    idle = node_idle.clone()
    future = node_future.clone()
    n_tasks = node_ntasks.clone()
    ck_idle, ck_future, ck_ntasks = idle.clone(), future.clone(), n_tasks.clone()
    pack = torch.zeros(node_ntasks.shape[0], dtype=torch.float32, device=dev)
    q_alloc = queue_alloc0.clone()
    ns_alloc = ns_alloc0.clone()
    p_cursor = torch.zeros_like(pool_njobs)
    uncapped = node_max_tasks == 0

    assign = [-1] * T
    pipelined = [False] * T
    ready = [False] * J
    kept = [False] * J

    pool, job = (int(x) for x in select(q_alloc, ns_alloc, p_cursor))
    cur_bucket = -1
    t_off = placed = placed_alloc = 0
    placed_res = torch.zeros_like(eps)
    for _ in range(T):
        if job < 0:
            break          # nothing selectable: every later step is a no-op
        t_idx = min(max(j_start[job] + t_off, 0), T - 1)
        g = tg[t_idx]
        valid = tv[t_idx] and t_off < j_n[job]
        b = tb[t_idx]
        if not (b >= 0 and b == cur_bucket):
            pack.zero_()   # a new topology bucket starts with no mates
        if valid:
            req = group_req[g]
            static_ok = group_mask[g]
            if ts is not None:
                static_ok = static_ok & slot_row(slot_ok, ts[t_idx])
            base_ok = static_ok & (uncapped | (n_tasks < node_max_tasks))
            fits_idle = torch.all(req[None, :] <= idle + eps[None, :],
                                  dim=-1) & base_ok
            fits_future = torch.all(req[None, :] <= future + eps[None, :],
                                    dim=-1) & base_ok
            score = node_score(req, idle, node_alloc, weights,
                               group_static_score[g]
                               + pack * group_pack_bonus[g])
            any_idle = torch.any(fits_idle)
            cand = torch.where(any_idle, fits_idle, fits_future) \
                if allow_pipeline else fits_idle
            sel = torch.argmax(torch.where(cand, score, NEG))
            # one device-to-host read per step
            sel, placed_ok, any_idle = torch.stack(
                [sel, torch.any(cand).long(), any_idle.long()]).tolist()
            if placed_ok:
                pipe = allow_pipeline and not any_idle
                if not pipe:
                    idle[sel] -= req
                    placed_alloc += 1
                future[sel] -= req
                n_tasks[sel] += 1
                pack[sel] += 1.0
                placed += 1
                placed_res = placed_res + req
                assign[t_idx] = sel
                pipelined[t_idx] = pipe
            cur_bucket = b
        t_off += 1

        # ---- job boundary: gang commit/rollback + charges + select
        if t_off < j_n[job]:
            continue
        is_ready = j_base[job] + placed_alloc >= j_min[job]
        is_kept = j_base[job] + placed >= j_min[job]
        if is_ready or is_kept:
            ck_idle.copy_(idle)
            ck_future.copy_(future)
            ck_ntasks.copy_(n_tasks)
            q_alloc[p_queue[pool]] += placed_res
            ns_alloc[p_ns[pool]] += placed_res
        else:
            idle.copy_(ck_idle)
            future.copy_(ck_future)
            n_tasks.copy_(ck_ntasks)
        p_cursor[pool] += 1
        ready[job] = ready[job] or is_ready
        kept[job] = kept[job] or is_kept
        pool, job = (int(x) for x in select(q_alloc, ns_alloc, p_cursor))
        t_off = placed = placed_alloc = 0
        placed_res = torch.zeros_like(eps)

    # tasks of jobs that were neither committed nor kept are not placed
    tj = task_job.tolist()
    ok = [tv[t] and (ready[min(max(tj[t], 0), J - 1)]
                     or kept[min(max(tj[t], 0), J - 1)]) for t in range(T)]
    assign_t = torch.tensor([a if o else -1 for a, o in zip(assign, ok)],
                            dtype=torch.int32, device=dev)
    pipelined_t = torch.tensor([p and o for p, o in zip(pipelined, ok)],
                               dtype=torch.bool, device=dev)
    state = AllocState(idle, future, n_tasks, q_alloc, ns_alloc, p_cursor)
    return (assign_t, pipelined_t,
            torch.tensor(ready, dtype=torch.bool, device=dev),
            torch.tensor(kept, dtype=torch.bool, device=dev), state)


class _Table(NamedTuple):
    """The candidate table: K = 2 * chunk rows, each a copy of one node's
    state (rows of a node in both fit classes are kept equal)."""
    gidx: torch.Tensor       # [K] i64 node index
    live: torch.Tensor       # [K] bool the row holds a candidate
    static: torch.Tensor     # [K] f32 static score of the refresh's group
    pack: torch.Tensor       # [K] f32 pack row at the refresh, plus hits
    n_tasks: torch.Tensor    # [K] i32
    max_tasks: torch.Tensor  # [K] i32
    idle: torch.Tensor       # [K, R] f32
    future: torch.Tensor     # [K, R] f32
    alloc: torch.Tensor      # [K, R] f32


def _refresh(chunk: int, req, mask_row, static_row, bonus, pack, idle,
             future, n_tasks, node_alloc, node_max_tasks, eps, weights,
             allow_pipeline: bool) -> _Table:
    """The top ``chunk`` fitting nodes per class (idle, then future), by
    score descending and node index ascending."""
    base_ok = mask_row & ((node_max_tasks == 0) | (n_tasks < node_max_tasks))
    fits_idle = torch.all(req[None, :] <= idle + eps[None, :], dim=-1) \
        & base_ok
    fits_future = torch.all(req[None, :] <= future + eps[None, :], dim=-1) \
        & base_ok
    if not allow_pipeline:
        fits_future = torch.zeros_like(fits_future)
    score = node_score(req, idle, node_alloc, weights,
                       static_row + pack * bonus)
    rows, live = [], []
    for fits in (fits_idle, fits_future):
        keys = torch.where(fits, score, float("-inf"))
        # a stable descending sort puts equal scores in index order
        top = torch.sort(keys, descending=True, stable=True).indices[:chunk]
        pad = chunk - top.shape[0]
        rows.append(torch.cat([top, top.new_zeros(pad)]))
        live.append(torch.cat([fits[top], fits.new_zeros(pad)]))
    g = torch.cat(rows)
    return _Table(g, torch.cat(live), static_row[g].clone(), pack[g].clone(),
                  n_tasks[g].clone(), node_max_tasks[g].clone(),
                  idle[g].clone(), future[g].clone(), node_alloc[g].clone())


def gang_allocate_chunked(task_group, task_job, task_valid, group_req,
                          group_mask, group_static_score, task_bucket,
                          group_pack_bonus, job_min_available, job_ready_base,
                          job_task_start, job_n_tasks, job_queue, pool_queue,
                          pool_ns, pool_job_start, pool_njobs, ns_weight,
                          ns_alloc0, ns_total, queue_deserved, queue_alloc0,
                          node_idle, node_future, node_alloc, node_ntasks,
                          node_max_tasks, eps, weights: ScoreWeights,
                          allow_pipeline: bool = True, ns_live: bool = False,
                          chunk: int = 16,
                          task_slot: Optional[torch.Tensor] = None,
                          slot_ok: Optional[torch.Tensor] = None):
    """``gang_allocate`` by the CUDA kernel's decision procedure: the port
    of volcano_tpu/ops/sharded.py:_sharded_body_chunked on one device, a
    table of the top ``chunk`` nodes per fit class over all nodes (the
    kernel's blocks each sweep a contiguous range and merge their lists
    into this one table). Same inputs and outputs as ``gang_allocate``,
    plus a sixth output counting the table refreshes (the kernel counts
    its refreshes by the same rule): ``total``; ``forced``, those that only
    the force flag called for (after a rollback, or passed on by a padding
    step), with the group, bucket and slot unchanged and fewer than
    ``chunk`` steps served; ``slot``, those that only a change of the
    task's domain slot called for; ``in_job``, those after a job's first
    step; and ``bucket_carried``, those at a job's first step in the
    bucket of the job before, whose table takes that bucket's pack row.

    A refresh sweeps every node and keeps the top ``chunk`` per fit class;
    a step is then served from the table's rows alone. A valid step
    refreshes when the previous step rolled back a gang, when ``chunk``
    steps have been served, or when the group, the topology bucket or the
    domain slot changed; an invalid step (a job's padding) serves nothing
    and passes a refresh it needed on to the next step. The refresh masks
    with the step's slot row, so every served step's table was built
    under its own slot (sharded.py:287-293). The table is exact,
    tie-breaks included (sharded.py:277-293): only placed-on nodes change
    within a chunk, they are in the table, and it kept ``chunk``
    candidates a class of which at most ``chunk - 1`` were touched."""
    T = task_group.shape[0]
    J = job_min_available.shape[0]
    N = node_ntasks.shape[0]
    dev = node_idle.device
    select = make_pool_select(queue_deserved, pool_queue, pool_ns,
                              pool_job_start, pool_njobs, ns_weight,
                              ns_total, eps, ns_live)
    tg, tv, tb = task_group.tolist(), task_valid.tolist(), task_bucket.tolist()
    ts = task_slot.tolist() if task_slot is not None else [-1] * T
    j_start, j_n = job_task_start.tolist(), job_n_tasks.tolist()
    j_min, j_base = job_min_available.tolist(), job_ready_base.tolist()
    p_queue, p_ns = pool_queue.tolist(), pool_ns.tolist()

    idle, future, n_tasks = (node_idle.clone(), node_future.clone(),
                             node_ntasks.clone())
    ck_idle, ck_future, ck_ntasks = idle.clone(), future.clone(), n_tasks.clone()
    pack = torch.zeros(N, dtype=torch.float32, device=dev)
    q_alloc, ns_alloc = queue_alloc0.clone(), ns_alloc0.clone()
    p_cursor = torch.zeros_like(pool_njobs)
    assign, pipelined = [-1] * T, [False] * T
    ready, kept = [False] * J, [False] * J

    pool, job = (int(x) for x in select(q_alloc, ns_alloc, p_cursor))
    cur_bucket = -1
    t_off = placed = placed_alloc = 0
    placed_res = torch.zeros_like(eps)
    table = None
    since, prev_g, prev_b, prev_s, force = chunk, -1, -1, -1, True
    refreshes = dict(total=0, forced=0, slot=0, in_job=0, bucket_carried=0)
    for _ in range(T):
        if job < 0:
            break
        t_idx = min(max(j_start[job] + t_off, 0), T - 1)
        g, b, slot = tg[t_idx], tb[t_idx], ts[t_idx]
        valid = tv[t_idx] and t_off < j_n[job]
        sb = b >= 0 and b == cur_bucket
        if not sb:
            pack.zero_()
        others = since >= chunk or g != prev_g or b != prev_b
        changed = others or slot != prev_s
        need = force or changed
        prev_g, prev_b, prev_s = g, b, slot
        if not valid:
            force = need
        else:
            req = group_req[g]
            bonus = group_pack_bonus[g]
            if need:
                mask_row = group_mask[g] if task_slot is None \
                    else group_mask[g] & slot_row(slot_ok, slot)
                table = _refresh(chunk, req, mask_row,
                                 group_static_score[g], bonus, pack, idle,
                                 future, n_tasks, node_alloc, node_max_tasks,
                                 eps, weights, allow_pipeline)
                refreshes["total"] += 1
                refreshes["forced"] += not changed
                refreshes["slot"] += changed and not others and not force
                refreshes["in_job"] += t_off > 0
                refreshes["bucket_carried"] += t_off == 0 and sb
                since, force = 1, False
            else:
                since += 1
            t = table
            base = t.live & ((t.max_tasks == 0) | (t.n_tasks < t.max_tasks))
            fits_idle = torch.all(req[None, :] <= t.idle + eps[None, :],
                                  dim=-1) & base
            fits_future = torch.all(req[None, :] <= t.future + eps[None, :],
                                    dim=-1) & base
            row_pack = t.pack if sb else torch.zeros_like(t.pack)
            score = node_score(req, t.idle, t.alloc, weights,
                               t.static + row_pack * bonus)
            any_idle = bool(fits_idle.any())
            cand = fits_idle if any_idle or not allow_pipeline \
                else fits_future
            if bool(cand.any()):
                best = torch.where(cand, score, NEG).max()
                sel = int(t.gidx[cand & (score == best)].min())
                pipe = not any_idle
                hit = t.live & (t.gidx == sel)
                if not pipe:
                    t.idle[hit] -= req
                    idle[sel] -= req
                    placed_alloc += 1
                t.future[hit] -= req
                t.n_tasks[hit] += 1
                t.pack[hit] += 1.0
                future[sel] -= req
                n_tasks[sel] += 1
                pack[sel] += 1.0
                placed += 1
                placed_res = placed_res + req
                assign[t_idx] = sel
                pipelined[t_idx] = pipe
            cur_bucket = b
        t_off += 1

        if t_off < j_n[job]:
            continue
        is_ready = j_base[job] + placed_alloc >= j_min[job]
        is_kept = j_base[job] + placed >= j_min[job]
        if is_ready or is_kept:
            ck_idle.copy_(idle)
            ck_future.copy_(future)
            ck_ntasks.copy_(n_tasks)
            q_alloc[p_queue[pool]] += placed_res
            ns_alloc[p_ns[pool]] += placed_res
        else:
            idle.copy_(ck_idle)
            future.copy_(ck_future)
            n_tasks.copy_(ck_ntasks)
            force = True
        p_cursor[pool] += 1
        ready[job] = ready[job] or is_ready
        kept[job] = kept[job] or is_kept
        pool, job = (int(x) for x in select(q_alloc, ns_alloc, p_cursor))
        t_off = placed = placed_alloc = 0
        placed_res = torch.zeros_like(eps)

    tj = task_job.tolist()
    ok = [tv[t] and (ready[min(max(tj[t], 0), J - 1)]
                     or kept[min(max(tj[t], 0), J - 1)]) for t in range(T)]
    state = AllocState(idle, future, n_tasks, q_alloc, ns_alloc, p_cursor)
    return (torch.tensor([a if o else -1 for a, o in zip(assign, ok)],
                         dtype=torch.int32, device=dev),
            torch.tensor([p and o for p, o in zip(pipelined, ok)],
                         dtype=torch.bool, device=dev),
            torch.tensor(ready, dtype=torch.bool, device=dev),
            torch.tensor(kept, dtype=torch.bool, device=dev), state,
            refreshes)


def rule_refreshes(task_group, task_bucket, task_slot, job_task_start,
                   job_n_tasks, chunk: int = 16) -> int:
    """The table refreshes that ``gang_allocate_chunked``'s rule gives
    when every job runs in encode order, none rolls back and no padding
    step lies inside a span: a step refreshes when its group, bucket or
    slot (``task_slot`` None: no slots) differs from the step before, or
    after ``chunk`` served steps. Takes numpy arrays or tensors."""
    tg, tb = task_group.tolist(), task_bucket.tolist()
    ts = task_slot.tolist() if task_slot is not None else [-1] * len(tg)
    total, since, prev = 0, chunk, None
    for start, n in zip(job_task_start.tolist(), job_n_tasks.tolist()):
        for t in range(start, start + n):
            key = (tg[t], tb[t], ts[t])
            if since >= chunk or key != prev:
                total, since = total + 1, 1
            else:
                since += 1
            prev = key
    return total
