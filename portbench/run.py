"""Run one benchmark cell once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is one JSON object (`correct`,
`attempted`, `failed`, `metrics`, `device`, with ``--trace 1`` also
`breakdown`, and last `checks`).  Without a CUDA device, with fewer
devices than the cell asks for, or with JAX loaded once the window has
closed, the run prints no result and exits non-zero.
"""

import time

_T_IMPORT = time.time()

import argparse  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from portbench import harness

    return harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                            t_start=harness.process_start_time(_T_IMPORT))


if __name__ == "__main__":
    sys.exit(main())
