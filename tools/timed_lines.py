#!/usr/bin/env python3
"""Run a command, pass its standard output through unchanged, and write
each line to a file behind the wall seconds since the command started.

    python3 tools/timed_lines.py OUT -- python3 chip_smoke.py

Exits with the command's exit code.  It times a run that prints no seconds
of its own per phase (an older ``chip_smoke.py``): a line's stamp is when
the phase that printed it ended, so two runs' stamps show where one spent
longer than the other.
"""

from __future__ import annotations

import subprocess
import sys
import time


def main(argv: list[str]) -> int:
    if len(argv) < 3 or argv[1] != "--":
        print(__doc__, file=sys.stderr)
        return 2
    out, cmd = argv[0], argv[2:]
    t0 = time.time()
    with open(out, "w") as fh:
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True, bufsize=1)
        for line in proc.stdout:
            sys.stdout.write(line)
            sys.stdout.flush()
            fh.write(f"{time.time() - t0:9.1f} {line}")
            fh.flush()
        return proc.wait()


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
