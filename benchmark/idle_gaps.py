#!/usr/bin/env python3
"""One traced run of a cell, then the card's idle time put down to the
program's stage spans (harness/spans.py): each of the window's ten longest
idle gaps with the innermost spans that cover it and for how long, and all
of the window's idle time by innermost span. Prints the run's result line,
then one JSON line of the breakdown.

    python3 benchmark/idle_gaps.py --workload e5_base.bulk_ingest --seed 7 \\
        --seconds 35
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import run as bench  # noqa: E402
from harness import spans  # noqa: E402


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    args = parser.parse_args()
    rc = bench.run(bench.parse(["--workload", args.workload, "--seed",
                                str(args.seed), "--seconds",
                                str(args.seconds), "--trace", "1"]))
    if rc:
        return rc
    trace, logged = bench.LAST.trace, spans.program_spans()
    if not trace.device_ops or logged is None:
        print("no device operation or no span log", file=sys.stderr)
        return 1
    first, last = spans.bounds(trace)
    logged = [s for s in logged if s.end_ns > first and s.start_ns < last]
    from marqo_tpu_torch.api import telemetry
    print(json.dumps({"idle_gaps": spans.idle_gaps(trace, logged),
                      "idle_by_stage": spans.idle_by_stage(trace, logged),
                      "window_s": trace.window_s, "busy_s": trace.busy_s,
                      "spans_in_window": len(logged),
                      "spans_dropped": telemetry.dropped_spans()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
