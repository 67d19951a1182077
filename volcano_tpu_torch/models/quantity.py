"""Kubernetes-style quantity parsing.

The framework is standalone (no Kubernetes client), but resource amounts keep
the familiar quantity syntax ("500m", "4Gi", "2") so that job/node specs read
like the reference's YAML. Semantics follow apimachinery's resource.Quantity
as used by the reference's NewResource (reference: pkg/scheduler/api/
resource_info.go:69-88): cpu is accounted in millicores, memory in bytes,
scalar resources in milli-units.
"""

from __future__ import annotations

import re

_BINARY = {"Ki": 2**10, "Mi": 2**20, "Gi": 2**30, "Ti": 2**40, "Pi": 2**50, "Ei": 2**60}
_DECIMAL = {"n": 1e-9, "u": 1e-6, "m": 1e-3, "": 1.0, "k": 1e3, "K": 1e3,
            "M": 1e6, "G": 1e9, "T": 1e12, "P": 1e15, "E": 1e18}

_QUANT_RE = re.compile(r"^\s*([+-]?[0-9]*\.?[0-9]+(?:[eE][+-]?[0-9]+)?)\s*([A-Za-z]*)\s*$")


def parse_quantity(value) -> float:
    """Parse a quantity string (or number) into a plain float of base units."""
    if isinstance(value, (int, float)):
        return float(value)
    m = _QUANT_RE.match(str(value))
    if not m:
        raise ValueError(f"invalid quantity: {value!r}")
    num, suffix = float(m.group(1)), m.group(2)
    if suffix in _BINARY:
        return num * _BINARY[suffix]
    if suffix in _DECIMAL:
        return num * _DECIMAL[suffix]
    raise ValueError(f"invalid quantity suffix: {value!r}")


def milli_value(value) -> float:
    """Quantity -> milli-units (k8s Quantity.MilliValue)."""
    return parse_quantity(value) * 1000.0
