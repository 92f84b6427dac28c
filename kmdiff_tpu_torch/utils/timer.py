"""Wall-clock phase timer (reference: src/time.cpp:7-52)."""

import time


class Timer:
    """Measures wall-clock time from construction; formats like the reference
    ("Xd Yh Zm Ws" style human-readable duration)."""

    def __init__(self):
        self._start = time.monotonic()
        self._stop = None

    def stop(self) -> float:
        self._stop = time.monotonic()
        return self._stop - self._start

    def elapsed(self) -> float:
        end = self._stop if self._stop is not None else time.monotonic()
        return end - self._start

    def formatted(self) -> str:
        s = self.elapsed()
        days, rem = divmod(int(s), 86400)
        hours, rem = divmod(rem, 3600)
        minutes, secs = divmod(rem, 60)
        frac = s - int(s)
        parts = []
        if days:
            parts.append(f"{days}d")
        if hours or days:
            parts.append(f"{hours:02d}h")
        if minutes or hours or days:
            parts.append(f"{minutes:02d}m")
        parts.append(f"{secs + frac:05.2f}s")
        return "".join(parts)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        return False
