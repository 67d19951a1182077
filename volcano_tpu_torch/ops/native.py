"""The native CPU solver behind the plain loop's signature (counterpart of
volcano_tpu/ops/native.py: gang_allocate_native).

``gang_allocate_native`` takes the 28 positional inputs of
ops.allocate.gang_allocate as torch tensors on the CPU, and its optional
per-task domain slots, and returns the same outputs as CPU tensors: its
decisions and final state equal the plain loop's bit for bit. It runs
native/solver.cc, a C++ library built with g++ at first use
(native/build.py) and called through ctypes: the plain loop's decision
procedure with a content-keyed candidate table, per-slot sub-tables and an
undo log, so that a 50,000-task batch takes seconds on a host CPU instead
of the plain loop's minutes.

There is no availability probe and no fall-back: a missing compiler or a
failed build raises RuntimeError with the compiler's output.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..native import build
from .allocate import AllocState
from .score import ScoreWeights

# candidate-table rows per fit class: max(8, min(C2, N)) for N nodes; a
# module constant that tests may set
C2 = 256

ABI_VERSION = 1


class _Args(ctypes.Structure):
    """native/solver.cc's Args, field for field."""
    _fields_ = [
        *((name, ctypes.c_int32) for name in (
            "T", "G", "J", "Q", "P", "NS", "N", "R", "C2", "S")),
        *((name, ctypes.c_void_p) for name in (
            "task_group", "task_job", "task_valid", "task_slot",
            "task_bucket", "group_req", "group_mask", "group_static",
            "slot_ok", "pack_bonus", "job_min", "job_base", "job_start",
            "job_ntasks", "pool_queue", "pool_ns", "pool_job_start",
            "pool_njobs", "ns_weight", "ns_alloc0", "ns_total",
            "q_deserved", "q_alloc0", "node_idle", "node_future",
            "node_alloc", "node_ntasks", "node_max", "eps",
            "binpack_res")),
        *((name, ctypes.c_float) for name in (
            "w_binpack", "w_least", "w_most", "w_balanced")),
        ("allow_pipeline", ctypes.c_int32), ("ns_live", ctypes.c_int32),
        *((name, ctypes.c_void_p) for name in (
            "assign", "out_pipelined", "out_ready", "out_kept", "out_idle",
            "out_future", "out_ntasks", "out_q_alloc", "out_ns_alloc",
            "out_p_cursor", "out_stats")),
    ]


def _lib() -> ctypes.CDLL:
    lib = build.solver()
    lib.vc_abi_version.restype = ctypes.c_int
    lib.vc_abi_version.argtypes = []
    version = lib.vc_abi_version()
    if version != ABI_VERSION:
        raise RuntimeError(f"native solver ABI {version}, expected "
                           f"{ABI_VERSION}")
    lib.vc_gang_allocate.restype = ctypes.c_int
    lib.vc_gang_allocate.argtypes = [ctypes.POINTER(_Args)]
    return lib


def _host(x: torch.Tensor, dtype: torch.dtype, name: str) -> torch.Tensor:
    if x.device.type != "cpu":
        raise ValueError(f"gang_allocate_native: {name} is on {x.device}; "
                         "the native solver takes CPU tensors")
    if x.dtype == torch.bool and dtype == torch.uint8:
        return x.contiguous().view(torch.uint8)   # one byte either way
    return x.to(dtype).contiguous()


def gang_allocate_native(task_group, task_job, task_valid, group_req,
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
    kept [J] bool, final AllocState) on the CPU, as
    ops.allocate.gang_allocate does; ``task_slot`` [T] i32 and ``slot_ok``
    [S+1, N] bool restrict task t to the nodes of row ``task_slot[t]`` (a
    slot outside 0..S admits none). ``job_queue`` is taken for the
    signature and unused (the pool tables carry the queue).

    ``gang_allocate_native.launches`` counts the solver's runs;
    ``gang_allocate_native.last_stats`` is what the last run reports of
    itself, an int32 tensor: its table refreshes and gang rollbacks."""
    if (task_slot is None) != (slot_ok is None):
        raise ValueError("task_slot and slot_ok: give both or neither")
    i32, f32, u8 = torch.int32, torch.float32, torch.uint8
    ins = {}
    for name, x, dtype in (
            ("task_group", task_group, i32), ("task_job", task_job, i32),
            ("task_valid", task_valid, u8), ("task_bucket", task_bucket, i32),
            ("group_req", group_req, f32), ("group_mask", group_mask, u8),
            ("group_static", group_static_score, f32),
            ("pack_bonus", group_pack_bonus, f32),
            ("job_min", job_min_available, i32),
            ("job_base", job_ready_base, i32),
            ("job_start", job_task_start, i32),
            ("job_ntasks", job_n_tasks, i32),
            ("pool_queue", pool_queue, i32), ("pool_ns", pool_ns, i32),
            ("pool_job_start", pool_job_start, i32),
            ("pool_njobs", pool_njobs, i32), ("ns_weight", ns_weight, f32),
            ("ns_alloc0", ns_alloc0, f32), ("ns_total", ns_total, f32),
            ("q_deserved", queue_deserved, f32),
            ("q_alloc0", queue_alloc0, f32), ("node_idle", node_idle, f32),
            ("node_future", node_future, f32),
            ("node_alloc", node_alloc, f32),
            ("node_ntasks", node_ntasks, i32),
            ("node_max", node_max_tasks, i32), ("eps", eps, f32),
            ("binpack_res", weights.binpack_res, f32)):
        ins[name] = _host(x, dtype, name)
    T = ins["task_group"].shape[0]
    G, R = ins["group_req"].shape
    J = ins["job_min"].shape[0]
    Q = ins["q_deserved"].shape[0]
    P = ins["pool_queue"].shape[0]
    NS = ins["ns_weight"].shape[0]
    N = ins["node_idle"].shape[0]
    S = -1
    if slot_ok is not None:
        ins["task_slot"] = _host(task_slot, i32, "task_slot")
        ins["slot_ok"] = _host(slot_ok, u8, "slot_ok")
        S = ins["slot_ok"].shape[0] - 1
    for name, shape in (
            ("task_job", (T,)), ("task_valid", (T,)), ("task_bucket", (T,)),
            ("task_slot", (T,)), ("group_mask", (G, N)),
            ("group_static", (G, N)), ("slot_ok", (S + 1, N)),
            ("pack_bonus", (G,)), ("job_base", (J,)), ("job_start", (J,)),
            ("job_ntasks", (J,)), ("pool_ns", (P,)),
            ("pool_job_start", (P,)), ("pool_njobs", (P,)),
            ("ns_alloc0", (NS, R)), ("ns_total", (R,)),
            ("q_deserved", (Q, R)), ("q_alloc0", (Q, R)),
            ("node_future", (N, R)), ("node_alloc", (N, R)),
            ("node_ntasks", (N,)), ("node_max", (N,)), ("eps", (R,)),
            ("binpack_res", (R,))):
        if name in ins and tuple(ins[name].shape) != shape:
            raise ValueError(f"gang_allocate_native: {name} has shape "
                             f"{tuple(ins[name].shape)}, expected {shape}")
    if R < 2 or N < 1:
        raise ValueError(f"gang_allocate_native: needs R >= 2 resources "
                         f"and a node (R={R}, N={N})")

    outs = {"assign": torch.empty(T, dtype=i32),
            "out_pipelined": torch.empty(T, dtype=u8),
            "out_ready": torch.empty(J, dtype=u8),
            "out_kept": torch.empty(J, dtype=u8),
            "out_idle": torch.empty((N, R), dtype=f32),
            "out_future": torch.empty((N, R), dtype=f32),
            "out_ntasks": torch.empty(N, dtype=i32),
            "out_q_alloc": torch.empty((Q, R), dtype=f32),
            "out_ns_alloc": torch.empty((NS, R), dtype=f32),
            "out_p_cursor": torch.empty(P, dtype=i32),
            "out_stats": torch.empty(2, dtype=i32)}
    args = _Args(T=T, G=G, J=J, Q=Q, P=P, NS=NS, N=N, R=R,
                 C2=max(8, min(C2, N)), S=S,
                 w_binpack=float(weights.binpack),
                 w_least=float(weights.least), w_most=float(weights.most),
                 w_balanced=float(weights.balanced),
                 allow_pipeline=int(bool(allow_pipeline)),
                 ns_live=int(bool(ns_live)),
                 **{k: v.data_ptr() for k, v in (*ins.items(),
                                                 *outs.items())})
    rc = _lib().vc_gang_allocate(ctypes.byref(args))
    if rc != 0:
        raise RuntimeError(f"native solver refused its arguments (rc={rc})")
    gang_allocate_native.launches += 1
    gang_allocate_native.last_stats = outs["out_stats"]
    state = AllocState(outs["out_idle"], outs["out_future"],
                       outs["out_ntasks"], outs["out_q_alloc"],
                       outs["out_ns_alloc"], outs["out_p_cursor"])
    return (outs["assign"], outs["out_pipelined"].bool(),
            outs["out_ready"].bool(), outs["out_kept"].bool(), state)


gang_allocate_native.launches = 0
gang_allocate_native.last_stats = None
