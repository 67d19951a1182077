"""Typed getters over plugin argument maps (the port's own copy of
volcano_tpu/framework/arguments.py; reference:
pkg/scheduler/framework/arguments.go)."""

from __future__ import annotations


class Arguments(dict):
    """Plugin arguments: a str->value map with typed extraction."""

    def get_int(self, key: str, default: int = 0) -> int:
        v = self.get(key)
        if v is None or v == "":
            return default
        try:
            return int(float(str(v)))
        except ValueError:
            return default

    def get_float(self, key: str, default: float = 0.0) -> float:
        v = self.get(key)
        if v is None or v == "":
            return default
        try:
            return float(str(v))
        except ValueError:
            return default

    def get_bool(self, key: str, default: bool = False) -> bool:
        v = self.get(key)
        if v is None or v == "":
            return default
        return str(v).strip().lower() in ("true", "1", "yes")

    def get_str(self, key: str, default: str = "") -> str:
        v = self.get(key)
        return default if v is None else str(v)
