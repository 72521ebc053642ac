"""Run one benchmark cell once, on the card:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  Prints the result as one JSON object, the
last line of standard output; the numbers compared with the reference,
each beside its limit, are the last lines of standard error.
"""
import time

T_START = time.time()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402


def _process_start() -> float:
    """When this process started (Linux), else when this file began."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(line.split()[1]) for line in f
                        if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return T_START


if __name__ == "__main__":
    root = Path.cwd()
    sys.path[:0] = [str(root), str(root / "src")]
    os.environ.setdefault("USE_FLAX", "0")
    from perfbench import harness
    harness.cache_env(root)
    sys.exit(harness.main(sys.argv[1:], _process_start()))
