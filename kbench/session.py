"""Run a command in a session of its own and report whether any process of
that session outlived it: how a run of the benchmark is shown to leave
nothing behind.

    python3 -B kbench/session.py OUT -- python3 -B -m kbench --workload ...

writes the command's standard output and error to OUT.out and OUT.err,
prints the last lines of its standard error, then one JSON line: the
command, its exit code and seconds, the processes of its session still
there after it exited (``left``; each is then ended), and the result line
it printed. Exits with the command's code.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time


def session_members(sid: int) -> list[str]:
    out = []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
            with open(f"/proc/{d}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
        except OSError:
            continue
        if int(fields[3]) == sid and fields[0] != "Z":
            out.append(f"{d} {cmd.strip()}")
    return out


def main() -> int:
    out, sep, *cmd = sys.argv[1:]
    if sep != "--" or not cmd:
        raise SystemExit(__doc__)
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    t0 = time.perf_counter()
    with open(out + ".out", "w") as fo, open(out + ".err", "w") as fe:
        proc = subprocess.Popen(cmd, stdout=fo, stderr=fe, start_new_session=True)
        rc = proc.wait()
    seconds = time.perf_counter() - t0
    time.sleep(1.0)
    left = session_members(proc.pid)
    for member in left:
        try:
            os.kill(int(member.split()[0]), signal.SIGKILL)
        except ProcessLookupError:
            pass
    with open(out + ".err") as f:
        sys.stdout.write("".join(f.readlines()[-14:]))
    with open(out + ".out") as f:
        lines = f.read().splitlines()
    print(json.dumps({"cmd": " ".join(cmd), "rc": rc, "seconds": round(seconds, 3),
                      "left": left, "result": lines[-1] if lines else None}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
