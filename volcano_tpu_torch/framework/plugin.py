"""Plugin and Action base interfaces (reference: pkg/scheduler/framework/
interface.go:20-41)."""

from __future__ import annotations


class Plugin:
    """Base plugin: OnSessionOpen registers fns / solver contributions,
    OnSessionClose writes results back."""

    def name(self) -> str:
        raise NotImplementedError

    def on_session_open(self, ssn) -> None:
        pass

    def on_session_close(self, ssn) -> None:
        pass


class Action:
    """Base action: Execute runs one phase of the cycle."""

    def name(self) -> str:
        raise NotImplementedError

    def initialize(self) -> None:
        pass

    def execute(self, ssn) -> None:
        raise NotImplementedError

    def un_initialize(self) -> None:
        pass
