"""Scheduler configuration schema (counterpart of
volcano_tpu/framework/conf.py; reference: pkg/scheduler/conf/
scheduler_conf.go:20-103 + plugins/defaults.go + pkg/scheduler/util.go).

YAML shape:

    actions: "enqueue, allocate, backfill"
    tiers:
    - plugins:
      - name: priority
      - name: gang
    - plugins:
      - name: drf
        enableJobOrder: false
        arguments:
          drf.enableHierarchy: true
    configurations:
    - name: solver
      arguments: {apply: eager}

Every per-extension-point enable flag defaults to true (defaults.go), so a
bare plugin name enables everything the plugin registers.

The conf is parsed by this module's own reader of the YAML subset that
scheduler confs use: block mappings and sequences, plain and quoted
scalars, flow ``{...}`` maps and ``[...]`` lists, and ``#`` comments.
Plain scalars resolve as YAML 1.1 does (``true``/``off``/``yes`` are
booleans, ``10`` an int, ``1.5`` a float, ``~`` and ``null`` None). Anchors,
tags and block scalars (``|``, ``>``) are refused with ValueError.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Tuple

from .arguments import Arguments

DEFAULT_SCHEDULER_CONF = """\
actions: "enqueue, allocate, backfill"
tiers:
- plugins:
  - name: priority
  - name: gang
- plugins:
  - name: drf
  - name: predicates
  - name: proportion
  - name: nodeorder
"""

# the ~18 per-extension-point enables (conf/scheduler_conf.go:44-94)
ENABLE_FLAGS = (
    "enabledJobOrder", "enabledNamespaceOrder", "enabledHierarchy",
    "enabledJobReady", "enabledJobPipelined", "enabledTaskOrder",
    "enabledPreemptable", "enabledReclaimable", "enabledQueueOrder",
    "enabledPredicate", "enabledBestNode", "enabledNodeOrder",
    "enabledTargetJob", "enabledReservedNodes", "enabledJobEnqueued",
    "enabledVictim", "enabledJobStarving", "enabledOverused",
)


@dataclass
class PluginOption:
    name: str
    enabled: Dict[str, bool] = field(default_factory=dict)
    arguments: Arguments = field(default_factory=Arguments)

    def is_enabled(self, flag: str) -> bool:
        """Unset flags default to enabled (plugins/defaults.go)."""
        return self.enabled.get(flag, True)


@dataclass
class Tier:
    plugins: List[PluginOption] = field(default_factory=list)


@dataclass
class SchedulerConfiguration:
    actions: List[str] = field(default_factory=list)
    tiers: List[Tier] = field(default_factory=list)
    configurations: Dict[str, Arguments] = field(default_factory=dict)


def parse_scheduler_conf(text: str) -> SchedulerConfiguration:
    """Parse a scheduler conf (util.go:57-84 unmarshalSchedulerConf)."""
    raw = load_yaml(text) or {}
    if not isinstance(raw, dict):
        raise ValueError("scheduler conf must be a mapping")
    conf = SchedulerConfiguration()
    actions = raw.get("actions", "") or ""
    conf.actions = [a.strip() for a in str(actions).split(",") if a.strip()]
    for tier_raw in raw.get("tiers", []) or []:
        tier = Tier()
        for p in tier_raw.get("plugins", []) or []:
            opt = PluginOption(name=p["name"])
            for key, value in p.items():
                if key in ("name", "arguments"):
                    continue
                # accept both enabledX and enableX spellings
                canon = key if key.startswith("enabled") else \
                    "enabled" + key[len("enable"):] if key.startswith("enable") else key
                if canon in ENABLE_FLAGS:
                    opt.enabled[canon] = bool(value)
            opt.arguments = Arguments(p.get("arguments") or {})
            tier.plugins.append(opt)
        conf.tiers.append(tier)
    for c in raw.get("configurations", []) or []:
        conf.configurations[c.get("name", "")] = Arguments(c.get("arguments") or {})
    return conf


def default_scheduler_conf() -> SchedulerConfiguration:
    return parse_scheduler_conf(DEFAULT_SCHEDULER_CONF)


# -- the YAML subset ---------------------------------------------------------

_INT = re.compile(r"[-+]?(0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"[-+]?([0-9][0-9_]*\.[0-9_]*|\.[0-9_]+)([eE][-+][0-9]+)?$")
_BOOLS = {"true": True, "yes": True, "on": True,
          "false": False, "no": False, "off": False}


def _plain(s: str) -> Any:
    """Resolve a plain scalar the way YAML 1.1 does."""
    if s in ("", "~", "null", "Null", "NULL"):
        return None
    if s in ("true", "True", "TRUE", "yes", "Yes", "YES", "on", "On", "ON",
             "false", "False", "FALSE", "no", "No", "NO", "off", "Off",
             "OFF"):
        return _BOOLS[s.lower()]
    if _INT.match(s):
        return int(s.replace("_", ""))
    if _FLOAT.match(s):
        return float(s.replace("_", ""))
    if s in (".inf", ".Inf", ".INF", "+.inf", "+.Inf", "+.INF"):
        return float("inf")
    if s in ("-.inf", "-.Inf", "-.INF"):
        return float("-inf")
    if s in (".nan", ".NaN", ".NAN"):
        return float("nan")
    if s[0] in "&*!|>%@`":
        raise ValueError(f"unsupported YAML construct: {s!r}")
    return s


def _quoted(s: str, i: int) -> Tuple[str, int]:
    """The quoted scalar starting at s[i]; returns (value, index after)."""
    q = s[i]
    out = []
    j = i + 1
    while j < len(s):
        c = s[j]
        if q == "'" and c == "'":
            if s[j + 1:j + 2] == "'":
                out.append("'")
                j += 2
                continue
            return "".join(out), j + 1
        if q == '"' and c == "\\":
            nxt = s[j + 1:j + 2]
            out.append({"n": "\n", "t": "\t", '"': '"', "\\": "\\",
                        "/": "/", "0": "\0"}.get(nxt, "\\" + nxt))
            j += 2
            continue
        if q == '"' and c == '"':
            return "".join(out), j + 1
        out.append(c)
        j += 1
    raise ValueError(f"unterminated quoted scalar: {s[i:]!r}")


def _strip_comment(line: str) -> str:
    """The line without a trailing ``# comment`` (outside quotes)."""
    q = None
    for i, c in enumerate(line):
        if q:
            if c == q:
                q = None
        elif c in "'\"":
            q = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _split_key(s: str):
    """``key: rest`` -> (key, rest); None when s is not a mapping entry."""
    if s[:1] in "'\"":
        key, j = _quoted(s, 0)
        rest = s[j:]
        if rest == ":" or rest.startswith(": "):
            return key, rest[1:].strip()
        return None
    if s[:1] in "[{":
        return None
    m = re.match(r"([^:#]*?)\s*:(?:\s+|$)", s)
    if m is None:
        return None
    return m.group(1), s[m.end():].strip()


class _Flow:
    """Reader of one flow collection or scalar (``{a: 1, b: [x, y]}``)."""

    def __init__(self, s: str):
        self.s = s
        self.i = 0

    def ws(self) -> None:
        while self.i < len(self.s) and self.s[self.i] in " \t":
            self.i += 1

    def value(self, stops: str) -> Any:
        self.ws()
        c = self.s[self.i:self.i + 1]
        if c == "{":
            return self.mapping()
        if c == "[":
            return self.sequence()
        if c in ("'", '"'):
            v, self.i = _quoted(self.s, self.i)
            return v
        j = self.i
        while j < len(self.s) and self.s[j] not in stops:
            j += 1
        text = self.s[self.i:j].strip()
        self.i = j
        return _plain(text)

    def key(self) -> str:
        self.ws()
        if self.s[self.i:self.i + 1] in ("'", '"'):
            k, self.i = _quoted(self.s, self.i)
        else:
            j = self.i
            while j < len(self.s) and not (
                    self.s[j] == ":" and self.s[j + 1:j + 2] in (" ", ",", "}", "")):
                if self.s[j] in ",}":
                    break
                j += 1
            k = self.s[self.i:j].strip()
            self.i = j
        self.ws()
        if self.s[self.i:self.i + 1] != ":":
            raise ValueError(f"flow mapping entry without ':' in {self.s!r}")
        self.i += 1
        return k

    def mapping(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        self.i += 1
        while True:
            self.ws()
            if self.s[self.i:self.i + 1] == "}":
                self.i += 1
                return out
            k = self.key()
            out[k] = self.value(",}")
            self.ws()
            c = self.s[self.i:self.i + 1]
            self.i += 1
            if c == "}":
                return out
            if c != ",":
                raise ValueError(f"bad flow mapping: {self.s!r}")

    def sequence(self) -> List[Any]:
        out: List[Any] = []
        self.i += 1
        while True:
            self.ws()
            if self.s[self.i:self.i + 1] == "]":
                self.i += 1
                return out
            out.append(self.value(",]"))
            self.ws()
            c = self.s[self.i:self.i + 1]
            self.i += 1
            if c == "]":
                return out
            if c != ",":
                raise ValueError(f"bad flow sequence: {self.s!r}")


def _inline(s: str) -> Any:
    """A value written on one line: a flow collection or a scalar."""
    if s[:1] in "[{'\"":
        f = _Flow(s)
        v = f.value("")
        f.ws()
        if f.i != len(s):
            raise ValueError(f"trailing text after value: {s!r}")
        return v
    return _plain(s)


def load_yaml(text: str) -> Any:
    """Parse the YAML subset described in the module docstring."""
    lines: List[Tuple[int, str]] = []
    for raw in text.splitlines():
        if raw.strip() in ("---", "..."):
            continue
        line = _strip_comment(raw)
        if not line.strip():
            continue
        if "\t" in line[:len(line) - len(line.lstrip())]:
            raise ValueError("tabs are not allowed in YAML indentation")
        lines.append((len(line) - len(line.lstrip(" ")), line.strip()))
    if not lines:
        return None
    value, end = _block(lines, 0, lines[0][0])
    if end != len(lines):
        raise ValueError(f"unexpected indentation at {lines[end][1]!r}")
    return value


def _block(lines, i: int, indent: int) -> Tuple[Any, int]:
    """The block collection whose entries start at column ``indent``."""
    if lines[i][1] == "-" or lines[i][1].startswith("- "):
        return _sequence(lines, i, indent)
    if _split_key(lines[i][1]) is None:
        if i + 1 < len(lines) and lines[i + 1][0] > indent:
            raise ValueError(f"multi-line scalars are not supported: "
                             f"{lines[i][1]!r}")
        return _inline(lines[i][1]), i + 1
    return _mapping(lines, i, indent)


def _nested(lines, i: int, indent: int, seq_same_indent: bool
            ) -> Tuple[Any, int]:
    """The value of a ``key:`` (or ``-``) with nothing after it: a block on
    the following deeper lines, a sequence at the same column (for a
    mapping key), or None."""
    if i < len(lines):
        col, content = lines[i]
        if col > indent:
            return _block(lines, i, col)
        if seq_same_indent and col == indent and (
                content == "-" or content.startswith("- ")):
            return _sequence(lines, i, indent)
    return None, i


def _mapping(lines, i: int, indent: int) -> Tuple[Dict[str, Any], int]:
    out: Dict[str, Any] = {}
    while i < len(lines) and lines[i][0] == indent:
        content = lines[i][1]
        kv = _split_key(content)
        if kv is None:
            if content == "-" or content.startswith("- "):
                break
            raise ValueError(f"expected 'key: value', got {content!r}")
        key, rest = kv
        if rest:
            out[key] = _inline(rest)
            i += 1
        else:
            out[key], i = _nested(lines, i + 1, indent, True)
    return out, i


def _sequence(lines, i: int, indent: int) -> Tuple[List[Any], int]:
    out: List[Any] = []
    while i < len(lines) and lines[i][0] == indent and (
            lines[i][1] == "-" or lines[i][1].startswith("- ")):
        rest = lines[i][1][1:].strip()
        if not rest:
            item, i = _nested(lines, i + 1, indent, False)
            out.append(item)
            continue
        # "- key: value ...": a mapping whose first entry sits on the dash
        # line, its other entries at the column after "- "
        col = indent + (len(lines[i][1]) - len(lines[i][1][1:].lstrip()))
        if _split_key(rest) is not None or rest == "-" or \
                rest.startswith("- "):
            sub = list(lines)
            sub[i] = (col, rest)
            item, i = _block(sub, i, col)
            out.append(item)
        else:
            out.append(_inline(rest))
            i += 1
    return out, i
