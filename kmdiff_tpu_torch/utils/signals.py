"""Crash handler: dump a backtrace log on fatal signals.

Reference: include/kmdiff/signals.hpp:65-155 installs handlers for
SIGABRT/FPE/ILL/INT/SEGV/TERM and writes a demangled backtrace to
`kmdiff_backtrace.log`. Python equivalent: the `faulthandler` module for
hard faults plus a signal hook that writes the Python traceback.
"""

import atexit
import faulthandler
import os
import signal
import sys
import traceback

BACKTRACE_LOG = "kmdiff_backtrace.log"

_installed = False


def _handler(signum, frame):
    name = signal.Signals(signum).name
    try:
        with open(BACKTRACE_LOG, "w") as f:
            f.write(f"kmdiff-tpu received {name}\n")
            traceback.print_stack(frame, file=f)
    except OSError:
        pass
    sys.stderr.write(
        f"\nkmdiff-tpu aborted on {name}; backtrace dumped to {BACKTRACE_LOG}\n"
    )
    sys.exit(128 + signum)


def init_signal_handlers() -> None:
    """Install fatal-signal handlers (idempotent)."""
    global _installed
    if _installed:
        return
    _installed = True
    try:
        # faulthandler needs the file open up front; remove it on a clean
        # exit so normal runs do not litter the CWD (the reference only
        # creates its log when a crash actually happens)
        path = BACKTRACE_LOG + ".fault"
        fh_log = open(path, "w")
        faulthandler.enable(file=fh_log)

        def _cleanup():
            try:
                faulthandler.disable()
                fh_log.close()
                if os.path.getsize(path) == 0:
                    os.remove(path)
            except OSError:
                pass

        atexit.register(_cleanup)
    except OSError:
        pass
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(sig, _handler)
        except (ValueError, OSError):
            pass  # not in main thread / not supported
