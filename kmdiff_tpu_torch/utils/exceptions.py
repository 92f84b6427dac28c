"""Typed exception hierarchy.

Mirrors the reference's kmdiff_exception tree
(reference: include/kmdiff/exceptions.hpp:26-67) with idiomatic Python
exceptions instead of macro-generated classes.
"""


class KmdiffError(Exception):
    """Base class of every kmdiff-tpu error."""

class ConfigError(KmdiffError):
    """Bad or missing run-dir / option configuration."""


class InputError(KmdiffError):
    """Invalid user input."""


class FormatError(KmdiffError):
    """Malformed binary file (kmtricks / KFF / LZ4)."""

