"""Job chainer: wait for a PID to exit, then run a command (reference
``teacher/code/scripts/follow_pid.py:6-19`` — used to queue training stages on
a shared machine). Port of
``litemkd_tpu/tools/follow_pid.py``.

    python -m litemkd_torch.tools.follow_pid 12345 -- python -m litemkd_torch.cli.train ...
"""
from __future__ import annotations

import os
import subprocess
import sys
import time


def pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False
    except PermissionError:
        return True


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 3 or argv[1] != "--":
        print(__doc__)
        sys.exit(2)
    pid = int(argv[0])
    cmd = argv[2:]
    while pid_alive(pid):
        time.sleep(10)
    sys.exit(subprocess.call(cmd))


if __name__ == "__main__":
    main()
