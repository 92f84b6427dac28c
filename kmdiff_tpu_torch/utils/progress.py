"""TTY-gated progress bars (reference: include/kmdiff/progress.hpp:6-29).

Progress is only rendered when stderr is a TTY and verbosity is not debug,
matching the reference's gating (merge.hpp:252-257).
"""

import logging
import sys

from kmdiff_tpu_torch.utils.logging import get_logger


def progress_enabled() -> bool:
    return sys.stderr.isatty() and get_logger().level > logging.DEBUG


class ProgressBar:
    """Minimal dependency-free bar: `label [#####....] i/n`."""

    def __init__(self, label: str, total: int, width: int = 50, enabled=None):
        self.label = label
        self.total = max(1, total)
        self.width = width
        self.i = 0
        self.enabled = progress_enabled() if enabled is None else enabled
        self._done = False

    def set_progress(self, i: int):
        self.i = min(i, self.total)
        self._render()

    def tick(self):
        self.set_progress(self.i + 1)

    def is_completed(self) -> bool:
        return self.i >= self.total

    def _render(self):
        if not self.enabled:
            return
        filled = self.width * self.i // self.total
        bar = "#" * filled + "." * (self.width - filled)
        end = "\n" if self.is_completed() and not self._done else "\r"
        if self.is_completed():
            self._done = True
        sys.stderr.write(f"{self.label} [{bar}] {self.i}/{self.total}{end}")
        sys.stderr.flush()


def get_progress_bar(label: str, total: int, width: int = 50) -> ProgressBar:
    return ProgressBar(label, total, width)
