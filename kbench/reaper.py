"""No process outlives a run.

The harness starts no process. The port does, while it builds: one nvcc a
kernel source (kmdiff_tpu_torch/kernels.py) and make for its host library
(kmdiff_tpu_torch/native), whose compilers can outlive make when its
timeout kills it. So the harness makes itself a child subreaper at start:
an orphaned descendant is handed to it rather than to init, and it can
find, end and reap every one on its way out.

``Guard`` does that on every way out of its block: a normal end, an
exception, and SIGTERM or SIGINT, which it turns into ``Terminated`` in the
main thread. Its ``found`` lists what it had to end: a run that found any
is not correct.
"""

from __future__ import annotations

import ctypes
import glob
import os
import signal
import time

PR_SET_CHILD_SUBREAPER = 36


class Terminated(BaseException):
    """SIGTERM or SIGINT arrived (a BaseException, so that no handler of
    a failed job takes it)."""


def become_subreaper() -> None:
    libc = ctypes.CDLL(None, use_errno=True)
    libc.prctl.argtypes = [ctypes.c_int, ctypes.c_ulong, ctypes.c_ulong,
                           ctypes.c_ulong, ctypes.c_ulong]
    if libc.prctl(PR_SET_CHILD_SUBREAPER, 1, 0, 0, 0) != 0:
        err = ctypes.get_errno()
        raise OSError(err, f"prctl(PR_SET_CHILD_SUBREAPER): {os.strerror(err)}")


def descendants(pid: int | None = None) -> list[int]:
    """Every descendant of pid (this process by default), from each of its
    threads' ``children`` lists, recursively."""
    out, todo = [], [pid or os.getpid()]
    while todo:
        p = todo.pop()
        for path in glob.glob(f"/proc/{p}/task/*/children"):
            try:
                with open(path) as f:
                    kids = [int(x) for x in f.read().split()]
            except (OSError, ValueError):
                continue
            for c in kids:
                if c not in out:
                    out.append(c)
                    todo.append(c)
    return out


def _cmdline(pid: int) -> str:
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            return f.read().replace(b"\0", b" ").decode(errors="replace").strip()
    except OSError:
        return "?"


def _reap_children() -> None:
    while True:
        try:
            pid, _ = os.waitpid(-1, os.WNOHANG)
        except ChildProcessError:
            return
        if pid == 0:
            return


def _alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def end_descendants(grace: float = 2.0) -> list[str]:
    """SIGTERM every descendant, SIGKILL what is left after `grace`
    seconds, and reap them (orphans come to this subreaper); repeat until
    none is left. Returns "pid cmdline" of each one found."""
    found: list[str] = []
    for _ in range(5):
        procs = [p for p in descendants() if _alive(p)]
        if not procs:
            break
        found += [f"{p} {_cmdline(p)}" for p in procs]
        for sig in (signal.SIGTERM, signal.SIGKILL):
            procs = [p for p in procs if _alive(p)]
            for p in procs:
                try:
                    os.kill(p, sig)
                except ProcessLookupError:
                    pass
            deadline = time.monotonic() + grace
            while time.monotonic() < deadline and any(_alive(p) for p in procs):
                _reap_children()
                time.sleep(0.05)
        _reap_children()
    _reap_children()
    return found


class Guard:
    """Within the block, SIGTERM and SIGINT raise Terminated (the harness's
    thread pools are ``with`` blocks, so they shut down as it unwinds); on
    leaving it, every descendant is ended (``found``)."""

    def __init__(self):
        self.found: list[str] = []
        self._old: dict = {}

    def _raise(self, signum, _frame):
        raise Terminated(signal.Signals(signum).name)

    def __enter__(self):
        for sig in (signal.SIGTERM, signal.SIGINT):
            self._old[sig] = signal.signal(sig, self._raise)
        return self

    def __exit__(self, *exc):
        for sig in self._old:
            signal.signal(sig, signal.SIG_IGN)
        self.found = end_descendants()
        for sig, old in self._old.items():
            signal.signal(sig, old)
        return False
