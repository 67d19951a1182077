"""The hand-written CUDA gang-allocate kernel behind the plain loop's
signature (counterpart of volcano_tpu/ops/pallas_allocate.py:
gang_allocate_pallas and its host preparation).

``gang_allocate_cuda`` takes the 28 positional inputs of
ops.allocate.gang_allocate, and its optional per-task domain slots
(``task_slot``, ``slot_ok``), and returns the same outputs. Inputs on a CUDA
device go to the kernel in csrc/gang_allocate.cu (built on first use), one
launch of one thread-block cluster per call on the current stream, without
synchronising; inputs on the CPU go to the plain loop; any other device
raises. There is no fall-back: a failed build or launch raises, and so does
a node count whose state does not fit the cluster's shared memory
(``cluster_plan``).
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional

import torch

from . import allocate
from .allocate import AllocState
from .score import ScoreWeights

_P = ctypes.c_void_p
_I = ctypes.c_int
_N_POINTERS = 40
_N_INTS = 13

# the kernel's constants (csrc/gang_allocate.cu): candidates a block keeps
# per fit class, warps a block, words of the step descriptor and of the
# table's group request
CHUNK = 16
WARPS = 16
DESC_WORDS = 5
REQ_WORDS = 22
# shared memory a block may use on an H100 (227 KB), and the cluster sizes:
# 8 is portable, 16 needs the non-portable attribute
MAX_SHARED_BYTES = 232_448
CLUSTER_SIZES = (8, 16)
# threads a block: a refresh scores one node a thread at a time, so 8
# blocks serve up to 8 * THREADS nodes in one pass, and 16 beyond
THREADS = 512


class ClusterPlan(NamedTuple):
    """How the node axis is laid over the cluster."""
    blocks: int             # blocks in the cluster
    nodes_per_block: int    # contiguous nodes each block owns
    shared_bytes: int       # dynamic shared memory of each block


def shared_bytes(nodes_per_block: int, blocks: int, r: int, q: int,
                 ns: int, p: int) -> int:
    """A block's dynamic shared memory (csrc/gang_allocate.cu:shared_words):
    its nodes' state (idle, future, alloc, pod count and cap, pack and its
    generation), the candidate table of 2 * CHUNK rows a block, the warps'
    candidate lists, the step descriptor, the table's group request, and
    the fair-share state of Q queues, NS namespaces and P pools."""
    words = ((3 * r + 4) * nodes_per_block
             + (3 * r + 7) * 2 * CHUNK * blocks
             + WARPS * 2 * CHUNK * 2 + DESC_WORDS + REQ_WORDS
             + (q + ns) * r + p)
    return 4 * words


def cluster_plan(n: int, r: int, q: int, ns: int, p: int) -> ClusterPlan:
    """The cluster for N nodes at R resources (with Q queues, NS namespaces
    and P pools): 8 blocks while each holds at most THREADS nodes, else 16;
    ValueError above ``node_limit``."""
    for blocks in CLUSTER_SIZES:
        per_block = -(-n // blocks)
        size = shared_bytes(per_block, blocks, r, q, ns, p)
        if size <= MAX_SHARED_BYTES and (per_block <= THREADS
                                         or blocks == CLUSTER_SIZES[-1]):
            return ClusterPlan(blocks, per_block, size)
    raise ValueError(
        f"gang_allocate_cuda: {n} nodes at R={r} exceed the kernel's limit "
        f"of {node_limit(r, q, ns, p)} nodes (their state must fit the "
        f"shared memory of a {CLUSTER_SIZES[-1]}-block cluster)")


def node_limit(r: int, q: int, ns: int, p: int) -> int:
    """The most nodes the kernel takes at R resources."""
    blocks = CLUSTER_SIZES[-1]
    fixed = shared_bytes(0, blocks, r, q, ns, p)
    return blocks * ((MAX_SHARED_BYTES - fixed) // (4 * (3 * r + 4)))


def _lib() -> ctypes.CDLL:
    from . import build   # the build runs on the first CUDA call only
    lib = build.load("gang_allocate")
    if lib.gang_allocate_launch.argtypes is None:
        lib.gang_allocate_launch.argtypes = \
            [_P] * _N_POINTERS + [_I] * _N_INTS + [_P]
        lib.gang_allocate_launch.restype = ctypes.c_int
        lib.gang_allocate_error_string.argtypes = [ctypes.c_int]
        lib.gang_allocate_error_string.restype = ctypes.c_char_p
    return lib


def _check(name: str, x: torch.Tensor, dtype: torch.dtype,
           shape: tuple, device: torch.device) -> None:
    if x.device != device or x.dtype != dtype or tuple(x.shape) != shape \
            or not x.is_contiguous():
        raise ValueError(
            f"{name}: expected a contiguous {dtype} tensor of shape {shape} "
            f"on {device}, got {x.dtype} {tuple(x.shape)} on {x.device} "
            f"(contiguous={x.is_contiguous()})")


def check_inputs(args: List[torch.Tensor],
                 task_slot: Optional[torch.Tensor] = None,
                 slot_ok: Optional[torch.Tensor] = None):
    """Validate the 28 positional inputs for the kernel, and the slot
    inputs when given (both or neither; ``slot_ok`` [S+1, N]): one device,
    the kernel's dtypes, consistent shapes, contiguous, 2 <= R <= 8.
    Returns (T, G, J, P, NS, N, R, S), S = -1 without slots; raises
    ValueError on anything else."""
    (task_group, task_job, task_valid, group_req, group_mask,
     group_static_score, task_bucket, group_pack_bonus, job_min_available,
     job_ready_base, job_task_start, job_n_tasks, job_queue, pool_queue,
     pool_ns, pool_job_start, pool_njobs, ns_weight, ns_alloc0, ns_total,
     queue_deserved, queue_alloc0, node_idle, node_future, node_alloc,
     node_ntasks, node_max_tasks, eps) = args
    device = node_idle.device
    if group_req.dim() != 2:
        raise ValueError("group_req: expected [G, R]")
    T = task_group.shape[0]
    G, R = group_req.shape
    J = job_min_available.shape[0]
    P = pool_queue.shape[0]
    NS = ns_weight.shape[0]
    Q = queue_deserved.shape[0]
    N = node_idle.shape[0]
    if not 2 <= R <= 8:
        raise ValueError(f"gang_allocate_cuda: R={R} outside 2..8")
    i32, f32, b8 = torch.int32, torch.float32, torch.bool
    for name, x, dtype, shape in (
            ("task_group", task_group, i32, (T,)),
            ("task_job", task_job, i32, (T,)),
            ("task_valid", task_valid, b8, (T,)),
            ("group_req", group_req, f32, (G, R)),
            ("group_mask", group_mask, b8, (G, N)),
            ("group_static_score", group_static_score, f32, (G, N)),
            ("task_bucket", task_bucket, i32, (T,)),
            ("group_pack_bonus", group_pack_bonus, f32, (G,)),
            ("job_min_available", job_min_available, i32, (J,)),
            ("job_ready_base", job_ready_base, i32, (J,)),
            ("job_task_start", job_task_start, i32, (J,)),
            ("job_n_tasks", job_n_tasks, i32, (J,)),
            ("pool_queue", pool_queue, i32, (P,)),
            ("pool_ns", pool_ns, i32, (P,)),
            ("pool_job_start", pool_job_start, i32, (P,)),
            ("pool_njobs", pool_njobs, i32, (P,)),
            ("ns_weight", ns_weight, f32, (NS,)),
            ("ns_alloc0", ns_alloc0, f32, (NS, R)),
            ("ns_total", ns_total, f32, (R,)),
            ("queue_deserved", queue_deserved, f32, (Q, R)),
            ("queue_alloc0", queue_alloc0, f32, (Q, R)),
            ("node_idle", node_idle, f32, (N, R)),
            ("node_future", node_future, f32, (N, R)),
            ("node_alloc", node_alloc, f32, (N, R)),
            ("node_ntasks", node_ntasks, i32, (N,)),
            ("node_max_tasks", node_max_tasks, i32, (N,)),
            ("eps", eps, f32, (R,))):
        _check(name, x, dtype, shape, device)
    if (task_slot is None) != (slot_ok is None):
        raise ValueError("task_slot and slot_ok: give both or neither")
    S = -1
    if slot_ok is not None:
        if slot_ok.dim() != 2 or slot_ok.shape[0] < 1:
            raise ValueError("slot_ok: expected [S+1, N]")
        S = slot_ok.shape[0] - 1
        _check("task_slot", task_slot, i32, (T,), device)
        _check("slot_ok", slot_ok, b8, (S + 1, N), device)
    return T, G, J, P, NS, N, R, S


def gang_allocate_cuda(task_group, task_job, task_valid, group_req,
                       group_mask, group_static_score, task_bucket,
                       group_pack_bonus, job_min_available, job_ready_base,
                       job_task_start, job_n_tasks, job_queue, pool_queue,
                       pool_ns, pool_job_start, pool_njobs, ns_weight,
                       ns_alloc0, ns_total, queue_deserved, queue_alloc0,
                       node_idle, node_future, node_alloc, node_ntasks,
                       node_max_tasks, eps, weights: ScoreWeights,
                       allow_pipeline: bool = True, ns_live: bool = False,
                       task_slot: Optional[torch.Tensor] = None,
                       slot_ok: Optional[torch.Tensor] = None):
    """Returns (assign [T] node or -1, pipelined [T] bool, ready [J] bool,
    kept [J] bool, final AllocState), as ops.allocate.gang_allocate does;
    ``task_slot`` [T] i32 and ``slot_ok`` [S+1, N] bool restrict task t to
    the nodes of row ``task_slot[t]`` (a slot outside 0..S admits none).

    ``gang_allocate_cuda.launches`` counts the kernel launches;
    ``gang_allocate_cuda.last_stats`` is what the last launch reports of
    itself, an int32 tensor on the device: its table refreshes, the
    cluster's blocks and each block's dynamic shared memory in bytes."""
    args: List[torch.Tensor] = [
        task_group, task_job, task_valid, group_req, group_mask,
        group_static_score, task_bucket, group_pack_bonus, job_min_available,
        job_ready_base, job_task_start, job_n_tasks, job_queue, pool_queue,
        pool_ns, pool_job_start, pool_njobs, ns_weight, ns_alloc0, ns_total,
        queue_deserved, queue_alloc0, node_idle, node_future, node_alloc,
        node_ntasks, node_max_tasks, eps]
    device = node_idle.device
    if device.type == "cpu":
        return allocate.gang_allocate(
            *args, weights, allow_pipeline=allow_pipeline, ns_live=ns_live,
            task_slot=task_slot, slot_ok=slot_ok)
    if device.type != "cuda":
        raise ValueError(f"gang_allocate_cuda: no kernel for device {device}")

    T, G, J, P, NS, N, R, S = check_inputs(args, task_slot, slot_ok)
    Q = queue_deserved.shape[0]
    plan = cluster_plan(N, R, Q, NS, P)
    i32, f32, b8 = torch.int32, torch.float32, torch.bool
    w = torch.cat([torch.stack([weights.binpack, weights.least, weights.most,
                                weights.balanced]).reshape(4),
                   weights.binpack_res.reshape(R)]).to(device, f32)

    idle = torch.empty_like(node_idle)
    future = torch.empty_like(node_future)
    ntasks = torch.empty_like(node_ntasks)
    undo = torch.empty((T, 2 + 2 * R), dtype=f32, device=device)
    q_alloc = queue_alloc0.clone()
    ns_alloc = ns_alloc0.clone()
    p_cursor = torch.empty(P, dtype=i32, device=device)
    assign = torch.empty(T, dtype=i32, device=device)
    pipelined = torch.empty(T, dtype=b8, device=device)
    ready = torch.empty(J, dtype=b8, device=device)
    kept = torch.empty(J, dtype=b8, device=device)
    stats = torch.empty(3, dtype=i32, device=device)

    pointers = [task_group, task_valid, task_bucket, task_job, task_slot,
                slot_ok, group_req, group_mask, group_static_score,
                group_pack_bonus, job_min_available, job_ready_base, job_task_start,
                job_n_tasks, pool_queue, pool_ns, pool_job_start, pool_njobs,
                ns_weight, ns_total, queue_deserved, node_idle, node_future,
                node_alloc, node_ntasks, node_max_tasks, eps, w, idle, future,
                ntasks, undo, q_alloc, ns_alloc, p_cursor, assign, pipelined,
                ready, kept, stats]
    lib = _lib()
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = lib.gang_allocate_launch(
        *(None if x is None else x.data_ptr() for x in pointers),
        T, J, P, NS, Q, N, S, R, int(bool(allow_pipeline)),
        int(bool(ns_live)),
        *plan, stream)
    if rc != 0:
        raise RuntimeError("gang_allocate kernel launch failed: "
                           + lib.gang_allocate_error_string(rc).decode())
    gang_allocate_cuda.launches += 1
    gang_allocate_cuda.last_stats = stats
    state = AllocState(idle, future, ntasks, q_alloc, ns_alloc, p_cursor)
    return assign, pipelined, ready, kept, state


gang_allocate_cuda.launches = 0
gang_allocate_cuda.last_stats = None
