"""``python3 -m portbench --workload <name> --seed <n> --seconds <s>
--trace <0|1>``: one run of one cell of BENCHMARK.json (README.md)."""

import sys
import time

from portbench.harness import main, process_elapsed_s

if __name__ == "__main__":
    origin = (time.perf_counter(), process_elapsed_s())
    sys.exit(main(setup_origin=origin))
