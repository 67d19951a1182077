"""Resource vectors: the arithmetic every fit/fairness decision rests on.

Behavioral contract mirrors the reference's Resource type
(reference: pkg/scheduler/api/resource_info.go:50-533):

* dimensions: cpu (millicores), memory (bytes), plus named scalar resources
  (accounted in milli-units), and a ``pods`` capacity that is only consulted
  by predicates (``max_task_num``), never by arithmetic.
* an epsilon of 0.1 (``EPS``) on all tolerant comparisons.
* comparisons take a *dimension default* for scalar resources absent from one
  side: ``Zero`` (treat missing as 0) or ``Infinity`` (treat missing as
  unbounded).  Internally missing-with-Infinity becomes ``math.inf`` which
  reproduces the reference's ``-1`` sentinel logic exactly (an infinite left
  side is never "less", an infinite right side always admits).

The class is the host-side object model; the dense array view the
placement kernel reads is built by :mod:`.arrays` over a
:class:`~.arrays.ResourceIndex`. (This module is the port's own copy of
volcano_tpu/models/resource.py.)
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Optional

from .quantity import milli_value, parse_quantity

# Epsilon for tolerant comparisons (reference: resource_info.go:36 minResource).
EPS: float = 0.1

# Dimension defaults (reference: resource_info.go:42-47).
ZERO = "Zero"
INFINITY = "Infinity"

CPU = "cpu"
MEMORY = "memory"
PODS = "pods"
GPU_RESOURCE_NAME = "nvidia.com/gpu"
# GPU-share scalar used by the gpu-share predicate (reference: plugins/predicates/gpu.go).
GPU_MEMORY_RESOURCE = "volcano.sh/gpu-memory"
GPU_NUMBER_RESOURCE = "volcano.sh/gpu-number"


def _is_scalar_name(name: str) -> bool:
    """Names other than cpu/memory/pods are scalar (extended) resources."""
    return name not in (CPU, MEMORY, PODS)


class Resource:
    """A mutable resource vector (cpu millicores, memory bytes, scalars)."""

    __slots__ = ("milli_cpu", "memory", "scalars", "max_task_num")

    def __init__(self, milli_cpu: float = 0.0, memory: float = 0.0,
                 scalars: Optional[Dict[str, float]] = None, max_task_num: int = 0):
        self.milli_cpu = float(milli_cpu)
        self.memory = float(memory)
        self.scalars: Dict[str, float] = dict(scalars) if scalars else {}
        self.max_task_num = int(max_task_num)

    # -- construction ------------------------------------------------------

    @classmethod
    def from_resource_list(cls, rl: Optional[Dict[str, object]]) -> "Resource":
        """Build from a {"cpu": "2", "memory": "4Gi", ...} mapping.

        cpu -> millicores, memory -> bytes, pods -> max_task_num, any other
        name -> scalar milli-units (reference: resource_info.go:69-88).
        """
        r = cls()
        if not rl:
            return r
        for name, quant in rl.items():
            if name == CPU:
                r.milli_cpu += milli_value(quant)
            elif name == MEMORY:
                r.memory += parse_quantity(quant)
            elif name == PODS:
                r.max_task_num += int(parse_quantity(quant))
            else:
                r.add_scalar(name, milli_value(quant))
        return r

    def clone(self) -> "Resource":
        # __new__ + direct assigns: the constructor's float()/int() casts
        # cost real time at ~60k clones per 50k-task snapshot
        c = Resource.__new__(Resource)
        c.milli_cpu = self.milli_cpu
        c.memory = self.memory
        c.scalars = dict(self.scalars)
        c.max_task_num = self.max_task_num
        return c

    def to_resource_list(self) -> Dict[str, object]:
        """Inverse of from_resource_list (cpu/scalars as "<milli>m" strings,
        memory as bytes). Used when writing PodGroup.spec.min_resources."""
        rl: Dict[str, object] = {}
        if self.milli_cpu:
            rl[CPU] = f"{self.milli_cpu:g}m"
        if self.memory:
            rl[MEMORY] = self.memory
        if self.max_task_num:
            rl[PODS] = self.max_task_num
        for name, value in self.scalars.items():
            rl[name] = f"{value:g}m"
        return rl

    # -- access ------------------------------------------------------------

    def get(self, name: str) -> float:
        if name == CPU:
            return self.milli_cpu
        if name == MEMORY:
            return self.memory
        return self.scalars.get(name, 0.0)

    def set(self, name: str, value: float) -> None:
        if name == CPU:
            self.milli_cpu = value
        elif name == MEMORY:
            self.memory = value
        else:
            self.scalars[name] = value

    def resource_names(self) -> Iterable[str]:
        return [CPU, MEMORY, *self.scalars.keys()]

    def is_empty(self) -> bool:
        """True iff every dimension is below EPS (resource_info.go:144-156)."""
        if self.milli_cpu >= EPS or self.memory >= EPS:
            return False
        return all(q < EPS for q in self.scalars.values())

    def is_zero(self, name: str) -> bool:
        """Whether one dimension is below EPS; unknown scalar names are zero."""
        if name == CPU:
            return self.milli_cpu < EPS
        if name == MEMORY:
            return self.memory < EPS
        return self.scalars.get(name, 0.0) < EPS

    # -- arithmetic (mutating, returning self, like the reference) ---------

    def add(self, rr: "Resource") -> "Resource":
        self.milli_cpu += rr.milli_cpu
        self.memory += rr.memory
        for name, quant in rr.scalars.items():
            self.scalars[name] = self.scalars.get(name, 0.0) + quant
        return self

    def sub(self, rr: "Resource") -> "Resource":
        """Subtract; requires rr <= self under Zero defaults (resource_info.go:195)."""
        assert rr.less_equal(self, ZERO), \
            f"resource is not sufficient to do operation: <{self}> sub <{rr}>"
        return self.sub_unchecked(rr)

    def sub_unchecked(self, rr: "Resource") -> "Resource":
        """sub() without the sufficiency assertion — for hot paths whose
        caller has just performed the same less_equal check (e.g.
        NodeInfo._allocate_idle); the assertion would re-run it per call."""
        self.milli_cpu -= rr.milli_cpu
        self.memory -= rr.memory
        if not self.scalars:
            return self
        for name, quant in rr.scalars.items():
            self.scalars[name] = self.scalars.get(name, 0.0) - quant
        return self

    def multi(self, ratio: float) -> "Resource":
        self.milli_cpu *= ratio
        self.memory *= ratio
        for name in self.scalars:
            self.scalars[name] *= ratio
        return self

    def set_max_resource(self, rr: "Resource") -> None:
        """Per-dimension max, in place (resource_info.go:218-243)."""
        self.milli_cpu = max(self.milli_cpu, rr.milli_cpu)
        self.memory = max(self.memory, rr.memory)
        for name, quant in rr.scalars.items():
            if name not in self.scalars or quant > self.scalars[name]:
                self.scalars[name] = quant

    def fit_delta(self, rr: "Resource") -> "Resource":
        """available - (requested + EPS) per requested dimension; negative
        entries mean insufficiency (resource_info.go:246-274)."""
        if rr.milli_cpu > 0:
            self.milli_cpu -= rr.milli_cpu + EPS
        if rr.memory > 0:
            self.memory -= rr.memory + EPS
        for name, quant in rr.scalars.items():
            if quant > 0:
                self.scalars[name] = self.scalars.get(name, 0.0) - (quant + EPS)
        return self

    def min_dimension_resource(self, rr: "Resource") -> "Resource":
        """Clamp self per-dimension to rr.  When rr carries no scalar map at
        all, self's scalars are zeroed; otherwise only names present in rr
        are clamped (resource_info.go:477-504)."""
        self.milli_cpu = min(self.milli_cpu, rr.milli_cpu)
        self.memory = min(self.memory, rr.memory)
        if not rr.scalars:
            for name in self.scalars:
                self.scalars[name] = 0.0
        else:
            for name, quant in rr.scalars.items():
                if name in self.scalars and quant < self.scalars[name]:
                    self.scalars[name] = quant
        return self

    def diff(self, rr: "Resource"):
        """Return (increased, decreased) per-dimension differences; scalar
        names are drawn from self's side only (resource_info.go:426-460)."""
        inc, dec = Resource(), Resource()
        for name in (CPU, MEMORY, *self.scalars.keys()):
            l, r = self.get(name), rr.get(name)
            if l > r:
                inc.set(name, l - r)
            else:
                dec.set(name, r - l)
        return inc, dec

    def add_scalar(self, name: str, quantity: float) -> None:
        self.scalars[name] = self.scalars.get(name, 0.0) + quantity

    def set_scalar(self, name: str, quantity: float) -> None:
        self.scalars[name] = quantity

    # -- comparisons -------------------------------------------------------

    def _scalar_pairs(self, rr: "Resource", default: str):
        """Union of scalar names with missing entries defaulted; Infinity
        becomes math.inf, reproducing the -1 sentinel branches
        (resource_info.go:506-533 setDefaultValue)."""
        fill = 0.0 if default == ZERO else math.inf
        names = set(self.scalars) | set(rr.scalars)
        for name in names:
            yield self.scalars.get(name, fill), rr.scalars.get(name, fill)

    def less(self, rr: "Resource", default: str = ZERO) -> bool:
        """Strictly less in *every* dimension (resource_info.go:276-308)."""
        if not (self.milli_cpu < rr.milli_cpu and self.memory < rr.memory):
            return False
        for l, r in self._scalar_pairs(rr, default):
            if r == math.inf:
                continue
            if l == math.inf or not l < r:
                return False
        return True

    def less_equal(self, rr: "Resource", default: str = ZERO) -> bool:
        """<= within EPS in every dimension (resource_info.go:310-341)."""
        def le(l, r):
            return l < r or abs(l - r) < EPS
        if not (le(self.milli_cpu, rr.milli_cpu) and le(self.memory, rr.memory)):
            return False
        if not self.scalars and not rr.scalars:
            return True   # fast path: the dominant case on the bind hot loop
        for l, r in self._scalar_pairs(rr, default):
            if r == math.inf:
                continue
            if l == math.inf or not le(l, r):
                return False
        return True

    def less_partly(self, rr: "Resource", default: str = ZERO) -> bool:
        """Strictly less in *some* dimension (resource_info.go:343-368)."""
        if self.milli_cpu < rr.milli_cpu or self.memory < rr.memory:
            return True
        for l, r in self._scalar_pairs(rr, default):
            if l == math.inf:
                continue
            if r == math.inf or l < r:
                return True
        return False

    def less_equal_partly(self, rr: "Resource", default: str = ZERO) -> bool:
        """<= within EPS in some dimension (resource_info.go:370-396)."""
        def le(l, r):
            return l < r or abs(l - r) < EPS
        if le(self.milli_cpu, rr.milli_cpu) or le(self.memory, rr.memory):
            return True
        for l, r in self._scalar_pairs(rr, default):
            if l == math.inf:
                continue
            if r == math.inf or le(l, r):
                return True
        return False

    def equal(self, rr: "Resource", default: str = ZERO) -> bool:
        """Equal within EPS in every dimension (resource_info.go:398-424)."""
        if not ((self.milli_cpu == rr.milli_cpu
                 or abs(self.milli_cpu - rr.milli_cpu) < EPS)
                and (self.memory == rr.memory
                     or abs(self.memory - rr.memory) < EPS)):
            return False
        if not self.scalars and not rr.scalars:
            return True   # fast path: the dominant case on the echo hot loop
        return all(l == r or abs(l - r) < EPS
                   for l, r in self._scalar_pairs(rr, default))

    # -- dunder sugar ------------------------------------------------------

    def __repr__(self) -> str:
        s = f"cpu {self.milli_cpu:.2f}, memory {self.memory:.2f}"
        for name, quant in sorted(self.scalars.items()):
            s += f", {name} {quant:.2f}"
        return s

    def __eq__(self, other) -> bool:
        return isinstance(other, Resource) and self.equal(other, ZERO)

    def __hash__(self):  # mutable; identity hash like Go pointers
        return id(self)

    def __add__(self, other: "Resource") -> "Resource":
        return self.clone().add(other)

    def __sub__(self, other: "Resource") -> "Resource":
        return self.clone().sub(other)


def empty_resource() -> Resource:
    return Resource()


def min_resource(a: Resource, b: Resource) -> Resource:
    return a.clone().min_dimension_resource(b)
