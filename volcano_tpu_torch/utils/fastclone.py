"""Fast structural deep-clone for API-object trees.

The store hands out copies on every get/list (API-server isolation
semantics, apiserver/store.py) and the snapshot clones jobs/nodes per cycle
— the reference pays the same cost in DeepCopy() calls generated by
deepcopy-gen (pkg/scheduler/cache/cache.go:793-882). ``copy.deepcopy``'s
memo machinery is ~4x slower than a direct recursive rebuild for the plain
tree-shaped dataclasses in models/objects.py, and object copying is the
single largest host cost in a full scheduling cycle, so this module
special-cases the shapes that actually occur:

* primitives (returned as-is — all immutable)
* dict / list / tuple / set
* instances with ``__dict__`` (the dataclasses)
* instances with ``__slots__`` (Resource, TaskInfo)

Objects are trees, never DAGs with back-references, so no memo is needed.
Anything unrecognized falls back to ``copy.deepcopy``.
"""

from __future__ import annotations

import copy
import enum

# class -> specialized cloner, registered by the model modules for the
# hottest shapes (Pod and its subtree: a 50k-bind flush clones each pod
# multiple times, and the generic per-attribute recursion dominated it).
# Specialized cloners may SHARE substructures their class documents as
# immutable-after-store (e.g. PodSpec.containers).
_CLONERS: dict = {}


def register_cloner(cls, fn) -> None:
    _CLONERS[cls] = fn


def fast_clone(o):
    t = o.__class__
    if t in (str, int, float, bool, type(None), bytes):
        return o
    special = _CLONERS.get(t)
    if special is not None:
        return special(o)
    if isinstance(o, enum.Enum):
        return o   # enum members are singletons; never rebuild them
    if t is dict:
        return {k: fast_clone(v) for k, v in o.items()}
    if t is list:
        return [fast_clone(v) for v in o]
    if t is tuple:
        return tuple(fast_clone(v) for v in o)
    if t is set:
        return {fast_clone(v) for v in o}
    d = getattr(o, "__dict__", None)
    if d is not None:
        new = object.__new__(t)
        nd = new.__dict__
        for k, v in d.items():
            nd[k] = fast_clone(v)
        return new
    slots = getattr(t, "__slots__", None)
    if slots is not None:
        new = object.__new__(t)
        for s in slots:
            setattr(new, s, fast_clone(getattr(o, s)))
        return new
    return copy.deepcopy(o)
