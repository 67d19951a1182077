"""Command-line tools of the port (the reference's ``cli/``): vcctl and
the single-verb tools. The reference's ``debug`` group is not ported yet."""

from .vcctl import build_parser, dispatch, main

__all__ = ["build_parser", "dispatch", "main"]
