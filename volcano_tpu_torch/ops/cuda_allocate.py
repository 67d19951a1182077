"""The hand-written CUDA gang-allocate kernel behind the plain loop's
signature (counterpart of volcano_tpu/ops/pallas_allocate.py:
gang_allocate_pallas and its host preparation).

``gang_allocate_cuda`` takes the 28 positional inputs of
ops.allocate.gang_allocate and returns the same outputs. Inputs on a CUDA
device go to the kernel in csrc/gang_allocate.cu (built on first use), one
launch per call on the current stream, without synchronising; inputs on the
CPU go to the plain loop; any other device raises. There is no fall-back:
a failed build or launch raises.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional

import torch

from . import allocate
from .allocate import AllocState
from .score import ScoreWeights

_P = ctypes.c_void_p
_I = ctypes.c_int
_N_POINTERS = 37
_N_INTS = 8


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


def check_inputs(args: List[torch.Tensor]):
    """Validate the 28 positional inputs for the kernel: one device, the
    kernel's dtypes, consistent shapes, contiguous, 2 <= R <= 8. Returns
    (T, G, J, P, NS, N, R); raises ValueError on anything else."""
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
    return T, G, J, P, NS, N, R


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
    kept [J] bool, final AllocState), as ops.allocate.gang_allocate does.

    ``gang_allocate_cuda.launches`` counts the kernel launches."""
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
    if task_slot is not None or slot_ok is not None:
        raise NotImplementedError(
            "task_slot/slot_ok arrive with the constraints port")

    T, G, J, P, NS, N, R = check_inputs(args)
    i32, f32, b8 = torch.int32, torch.float32, torch.bool
    w = torch.cat([torch.stack([weights.binpack, weights.least, weights.most,
                                weights.balanced]).reshape(4),
                   weights.binpack_res.reshape(R)]).to(device, f32)

    # node state resource-major; the kernel updates these in place
    idle = node_idle.t().contiguous()
    future = node_future.t().contiguous()
    alloc_rn = node_alloc.t().contiguous()
    ntasks = node_ntasks.clone()
    ck_idle = torch.empty_like(idle)
    ck_future = torch.empty_like(future)
    ck_ntasks = torch.empty_like(ntasks)
    pack = torch.empty(N, dtype=f32, device=device)
    q_alloc = queue_alloc0.clone()
    ns_alloc = ns_alloc0.clone()
    p_cursor = torch.empty(P, dtype=i32, device=device)
    assign = torch.empty(T, dtype=i32, device=device)
    pipelined = torch.empty(T, dtype=b8, device=device)
    ready = torch.empty(J, dtype=b8, device=device)
    kept = torch.empty(J, dtype=b8, device=device)

    pointers = [task_group, task_valid, task_bucket, task_job, group_req,
                group_mask, group_static_score, group_pack_bonus,
                job_min_available, job_ready_base, job_task_start,
                job_n_tasks, pool_queue, pool_ns, pool_job_start, pool_njobs,
                ns_weight, ns_total, queue_deserved, alloc_rn, node_max_tasks,
                eps, w, idle, future, ntasks, ck_idle, ck_future, ck_ntasks,
                pack, q_alloc, ns_alloc, p_cursor, assign, pipelined, ready,
                kept]
    lib = _lib()
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = lib.gang_allocate_launch(
        *(x.data_ptr() for x in pointers),
        T, J, P, NS, N, R, int(bool(allow_pipeline)), int(bool(ns_live)),
        stream)
    if rc != 0:
        raise RuntimeError("gang_allocate kernel launch failed: "
                           + lib.gang_allocate_error_string(rc).decode())
    gang_allocate_cuda.launches += 1
    state = AllocState(idle.t(), future.t(), ntasks, q_alloc, ns_alloc,
                       p_cursor)
    return assign, pipelined, ready, kept, state


gang_allocate_cuda.launches = 0
