#!/usr/bin/env python3
"""The knee sweep of an open-loop cell: one run at each offered rate, in
one process, each with its own seed. For every rate it prints the offered
and the completed rate, the failures, the generator's lateness (sent less
due: median, 95th percentile, and the median of the window's last third
less its first third, which grows when the queue does) and the latency
percentiles. The highest rate at which completions keep up, nothing fails
and the lateness does not grow is the knee; the cell runs at about four
fifths of it.

    python3 benchmark/sweep.py --workload e5_base.search --rates 8,10,12 \\
        --seconds 25 --seed 7 --config benchmark/configs/e5_base_v2.json
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import run as bench  # noqa: E402


def summary(window, rate: float) -> dict:
    records = window.in_window()
    ok = [r for r in records if r[4] == 200]
    late = np.array([r[2] - r[1] for r in records]) * 1e3
    due = np.array([r[1] for r in records])
    third = window.seconds / 3
    drift = float(np.median(late[due >= 2 * third]) -
                  np.median(late[due < third])) if len(late) else None
    latency = [(r[3] - r[1]) * 1e3 if r[4] == 200 else 1000.0
               for r in records]
    done_in = sum(1 for r in ok if r[3] <= window.seconds)
    return {"offered_per_s": rate, "due": len(records),
            "completed_per_s": done_in / window.seconds,
            "failed": len(records) - len(ok),
            "late_p50_ms": float(np.median(late)),
            "late_p95_ms": float(np.percentile(late, 95)),
            "late_drift_ms": drift,
            "p50_ms": float(np.percentile(latency, 50)),
            "p95_ms": float(np.percentile(latency, 95))}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--rates", required=True)
    parser.add_argument("--seconds", type=float, default=10)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--config", help="the configuration's file, for a "
                        "cell that BENCHMARK.json does not hold yet")
    args = parser.parse_args()
    manifest = bench.load_manifest()
    if args.config:
        manifest = bench.with_cell(manifest, args.workload, args.config)
    rows = []
    for i, rate in enumerate(float(r) for r in args.rates.split(",")):
        run_args = bench.parse(["--workload", args.workload,
                                "--seed", str(args.seed + i),
                                "--seconds", str(args.seconds)])
        rc = bench.run(run_args, overrides={"traffic": {"rate": rate}},
                       manifest=manifest)
        if rc:
            return rc
        rows.append(summary(bench.LAST, rate))
        print("sweep " + json.dumps(rows[-1]), file=sys.stderr, flush=True)
    print(json.dumps(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
