"""CLI helpers (the port's own copy of volcano_tpu/cli/util.py;
reference: pkg/cli/util + pkg/cli/job/util.go)."""

from __future__ import annotations

import os
from typing import Dict, List, Optional

DEFAULT_SERVER = os.environ.get("VOLCANO_SERVER", "http://127.0.0.1:8181")


def get_client(server: Optional[str] = None):
    """A client speaking the store CRUD interface: remote HTTP by default;
    tests inject an in-process ObjectStore instead (same surface)."""
    from ..apiserver.http import StoreClient
    return StoreClient(server or DEFAULT_SERVER)


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


def print_table(headers: List[str], rows: List[List[str]]) -> str:
    widths = [len(h) for h in headers]
    for row in rows:
        for i, cell in enumerate(row):
            widths[i] = max(widths[i], len(str(cell)))
    fmt = "  ".join(f"{{:<{w}}}" for w in widths)
    lines = [fmt.format(*headers)]
    lines.extend(fmt.format(*[str(c) for c in row]) for row in rows)
    return "\n".join(lines)
