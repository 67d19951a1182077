"""CLI helpers (the port's own copy of ``parse_resource_list`` from
volcano_tpu/cli/util.py; reference: pkg/cli/util)."""

from __future__ import annotations

from typing import Dict


def parse_resource_list(spec: str) -> Dict[str, str]:
    """"cpu=1000m,memory=100Mi" -> {"cpu": "1000m", "memory": "100Mi"}
    (populateResourceListV1 equivalent)."""
    out: Dict[str, str] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"invalid resource spec {part!r}, want name=value")
        name, value = part.split("=", 1)
        out[name.strip()] = value.strip()
    return out
