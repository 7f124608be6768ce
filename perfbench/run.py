"""Run one cell of the benchmark and print its result as the last line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``src/repro_torch`` beside
``perfbench/``. The cells, their configurations, traffic and metrics are
named in ``BENCHMARK.json``. It needs the CUDA cards the cell asks for and
exits non-zero, printing no result, without them.
"""
import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from perfbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
