"""State carried across from the JAX package.

``from_reference`` takes volcano_tpu's dense solver inputs as numpy (every
field of its ``SynthArrays``, and its ``ScoreWeights`` passed through
``np.asarray``) and turns them into this port's tensors with the same
dtypes and the same padding, so that both packages compute on the same
bits. The port's own ``utils.synth.SynthArrays`` goes through the same
function.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from .ops.score import ScoreWeights
from .utils.platform import default_device

# the positional inputs of ops.allocate.gang_allocate, in order, with dtypes
FIELDS: Dict[str, torch.dtype] = {
    "task_group": torch.int32, "task_job": torch.int32,
    "task_valid": torch.bool, "group_req": torch.float32,
    "group_mask": torch.bool, "group_static_score": torch.float32,
    "task_bucket": torch.int32, "group_pack_bonus": torch.float32,
    "job_min_available": torch.int32, "job_ready_base": torch.int32,
    "job_task_start": torch.int32, "job_n_tasks": torch.int32,
    "job_queue": torch.int32, "pool_queue": torch.int32,
    "pool_ns": torch.int32, "pool_job_start": torch.int32,
    "pool_njobs": torch.int32, "ns_weight": torch.float32,
    "ns_alloc0": torch.float32, "ns_total": torch.float32,
    "queue_deserved": torch.float32, "queue_alloc0": torch.float32,
    "node_idle": torch.float32, "node_future": torch.float32,
    "node_alloc": torch.float32, "node_ntasks": torch.int32,
    "node_max_tasks": torch.int32, "eps": torch.float32,
}

# the optional per-task topology-domain inputs (keyword arguments of
# gang_allocate): task_slot [T] indexes a slot_ok [S+1, N] row
SLOT_FIELDS: Dict[str, torch.dtype] = {
    "task_slot": torch.int32, "slot_ok": torch.bool,
}

Device = Union[str, torch.device, None]


def _field(src: Any, name: str):
    return src[name] if isinstance(src, Mapping) else getattr(src, name)


def _optional(src: Any, name: str):
    if isinstance(src, Mapping):
        return src.get(name)
    return getattr(src, name, None)


def as_tensors(arrays: Any, device: Device = None) -> Dict[str, torch.Tensor]:
    """{field: tensor} on ``device`` (default: the GPU) from a mapping or an
    object with the ``FIELDS`` attributes (numpy arrays or tensors), and
    the ``SLOT_FIELDS`` when it carries them (not None)."""
    dev = default_device(device)
    out = {}
    fields = dict(FIELDS)
    if _optional(arrays, "task_slot") is not None:
        fields.update(SLOT_FIELDS)
    for name, dtype in fields.items():
        x = _field(arrays, name)
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(x))
        out[name] = x.to(device=dev, dtype=dtype).contiguous()
    return out


def args(tensors: Mapping[str, torch.Tensor]) -> List[torch.Tensor]:
    """The 28 positional inputs of ops.allocate.gang_allocate, in order."""
    return [tensors[name] for name in FIELDS]


def slot_kwargs(tensors: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The slot keyword inputs of gang_allocate, or {} without slots."""
    return {name: tensors[name] for name in SLOT_FIELDS if name in tensors}


def from_reference(arrays: Any, weights: Optional[Any],
                   device: Device = None
                   ) -> Tuple[Dict[str, torch.Tensor], Optional[ScoreWeights]]:
    """The reference solver inputs (``arrays``: field -> numpy array, with
    ``task_slot`` and ``slot_ok`` when it has them; ``weights``:
    ScoreWeights field -> numpy array or float, or None) as this port's
    tensors on ``device``."""
    tensors = as_tensors(arrays, device)
    if weights is None:
        return tensors, None
    dev = default_device(device)
    return tensors, ScoreWeights(*(
        torch.tensor(np.asarray(_field(weights, f), np.float32), device=dev)
        for f in ScoreWeights._fields))
