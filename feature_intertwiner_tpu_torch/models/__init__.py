"""Modules of the port; see the package docstring."""

from .detector import InterNet  # noqa: F401
