"""Standalone single-verb CLIs (the port's own copy of
volcano_tpu/cli/singles.py; reference: cmd/cli/{vsub,vcancel,vjobs,
vqueues,vresume,vsuspend}/main.go) — each forwards to the matching vcctl
verb so `python -m volcano_tpu_torch.cli.singles vsub --name j1 ...`
behaves like `vcctl job run`."""

from __future__ import annotations

import sys
from typing import List, Optional

from .vcctl import main as vcctl_main

VERB_MAP = {
    "vsub": ["job", "run"],
    "vcancel": ["job", "delete"],
    "vjobs": ["job", "list"],
    "vqueues": ["queue", "list"],
    "vresume": ["job", "resume"],
    "vsuspend": ["job", "suspend"],
}


def run_single(tool: str, argv: Optional[List[str]] = None, client=None) -> int:
    if tool not in VERB_MAP:
        print(f"unknown tool {tool}", file=sys.stderr)
        return 1
    return vcctl_main(VERB_MAP[tool] + list(argv or []), client=client)


def _make_main(tool: str):
    def main(argv: Optional[List[str]] = None) -> int:
        return run_single(tool, argv if argv is not None else sys.argv[1:])
    return main


vsub = _make_main("vsub")
vcancel = _make_main("vcancel")
vjobs = _make_main("vjobs")
vqueues = _make_main("vqueues")
vresume = _make_main("vresume")
vsuspend = _make_main("vsuspend")


if __name__ == "__main__":
    tool, rest = sys.argv[1], sys.argv[2:]
    sys.exit(run_single(tool, rest))
