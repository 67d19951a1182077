"""JSON codec for API objects: dataclass <-> plain-dict conversion (the
port's own copy of volcano_tpu/apiserver/codec.py, in its plain Python
form).

A generic reflection codec covers every kind the port's store holds, so
store persistence (persistence.py), the write-ahead log (wal.py) and the
HTTP and watch wire (http.py, serving/hub.py) write one format, the same
as the reference's byte for byte. bytes fields are base64-encoded; nested
dataclasses/lists/dicts/Optionals are handled from the type hints.

``dumps_compact`` is the encode fused with the compact JSON dump. While
``NATIVE_ENCODE`` is on (the default) it runs the native engine's
``encode_object_json`` (native/fastmodel.c), one C pass over the object
graph; a value of a shape that pass does not know is handed back to the
Python body and counted in ``encode_handbacks``.
"""

from __future__ import annotations

import base64
import dataclasses
import json
import threading
import typing
from typing import Any, Dict, Optional

from ..models import objects as obj
from ..models.job_info import _fastmodel

# the native engine's switch for dumps_compact (a module attribute, so
# tests can force either engine)
NATIVE_ENCODE = True
# values the native encoder handed back to the Python body
encode_handbacks = 0
_handback_lock = threading.Lock()

# kind -> dataclass (the store's KINDS each map to one root type)
KIND_TYPES: Dict[str, type] = {
    "pods": obj.Pod,
    "nodes": obj.Node,
    "podgroups": obj.PodGroup,
    "queues": obj.Queue,
    "jobs": obj.Job,
    "commands": obj.Command,
    "priorityclasses": obj.PriorityClass,
    "resourcequotas": obj.ResourceQuota,
    "numatopologies": obj.Numatopology,
    "services": obj.Service,
    "configmaps": obj.ConfigMap,
    "secrets": obj.Secret,
    "networkpolicies": obj.NetworkPolicy,
    "persistentvolumeclaims": obj.PersistentVolumeClaim,
    "persistentvolumes": obj.PersistentVolume,
}


def encode(o: Any) -> Any:
    """Dataclass instance -> JSON-compatible structure."""
    if dataclasses.is_dataclass(o) and not isinstance(o, type):
        return {f.name: encode(getattr(o, f.name))
                for f in dataclasses.fields(o)}
    if isinstance(o, dict):
        return {str(k): encode(v) for k, v in o.items()}
    if isinstance(o, (list, tuple)):
        return [encode(v) for v in o]
    if isinstance(o, bytes):
        return {"__bytes__": base64.b64encode(o).decode("ascii")}
    return o


def _resolve(tp):
    """Unwrap Optional[X] to X; return (origin, args) for generics."""
    origin = typing.get_origin(tp)
    args = typing.get_args(tp)
    if origin is typing.Union:
        non_none = [a for a in args if a is not type(None)]
        if len(non_none) == 1:
            return _resolve(non_none[0])
    return tp, origin, args


_HINT_CACHE: Dict[type, Dict[str, Any]] = {}


def _hints(cls: type) -> Dict[str, Any]:
    if cls not in _HINT_CACHE:
        _HINT_CACHE[cls] = typing.get_type_hints(cls)
    return _HINT_CACHE[cls]


def decode(data: Any, tp: Any) -> Any:
    """JSON structure -> instance of tp (driven by dataclass type hints)."""
    if data is None:
        return None
    if isinstance(data, dict) and "__bytes__" in data and len(data) == 1:
        return base64.b64decode(data["__bytes__"])
    tp, origin, args = _resolve(tp)
    if dataclasses.is_dataclass(tp):
        hints = _hints(tp)
        kwargs = {}
        for f in dataclasses.fields(tp):
            if f.name in data:
                kwargs[f.name] = decode(data[f.name], hints[f.name])
        return tp(**kwargs)
    if origin in (list, tuple):
        elem = args[0] if args else Any
        return [decode(v, elem) for v in data]
    if origin is dict:
        key_tp = args[0] if args else str
        val_tp = args[1] if len(args) > 1 else Any
        out = {}
        for k, v in data.items():
            if key_tp is int:
                k = int(k)
            out[k] = decode(v, val_tp)
        return out
    return data


def encode_object(kind: str, o: Any) -> Dict[str, Any]:
    return encode(o)


def decode_object(kind: str, data: Dict[str, Any]) -> Any:
    cls = KIND_TYPES.get(kind)
    if cls is None:
        raise KeyError(f"unknown kind {kind!r}")
    return decode(data, cls)


def dumps_compact(value: Any) -> bytes:
    """``json.dumps(encode(value), separators=(",", ":"))`` as bytes: the
    write-ahead log's records and the wire's object payloads."""
    global encode_handbacks
    if NATIVE_ENCODE:
        out = _fastmodel().encode_object_json(value)
        if out is not None:
            return out
        with _handback_lock:
            encode_handbacks += 1
    return json.dumps(encode(value), separators=(",", ":")).encode()
