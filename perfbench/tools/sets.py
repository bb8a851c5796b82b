"""Runs one cell several times, one process a run as the driver does, and
keeps each run's result line: for the spreads that the bounds are set from,
and for the program's readings of the correctness check over many seeds.

    python3 perfbench/tools/sets.py --workload <cell> --seeds 1,2,3 --seconds 10 \\
        --trace 0 --out chiprun_out/<file>.jsonl

Prints a summary per metric (median, quartile spread) at the end."""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", default="10")
    parser.add_argument("--trace", default="0")
    parser.add_argument("--out", required=True)
    parser.add_argument("--tail", type=int, default=1500, help="stderr characters kept a run")
    args = parser.parse_args(argv)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)

    from perfbench.harness.stats import spread

    values = {}
    for seed in args.seeds.split(","):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, str(ROOT / "perfbench" / "run.py"), "--workload", args.workload,
             "--seed", seed, "--seconds", args.seconds, "--trace", args.trace],
            capture_output=True, text=True, cwd=ROOT)
        lines = proc.stdout.strip().splitlines()
        try:
            result = json.loads(lines[-1])
        except (IndexError, json.JSONDecodeError):
            result = None
        record = {"workload": args.workload, "seed": int(seed), "trace": int(args.trace),
                  "rc": proc.returncode, "wall_s": time.perf_counter() - t0, "result": result,
                  "stderr_tail": proc.stderr[-args.tail:]}
        with open(args.out, "a") as f:
            f.write(json.dumps(record) + "\n")
        summary = {k: v["value"] for k, v in (result or {}).get("metrics", {}).items()}
        checks = {k: v["value"] for k, v in (result or {}).get("checks", {}).items()}
        print(f"seed {seed} rc {proc.returncode} correct {(result or {}).get('correct')} "
              f"{summary} {checks} wall {record['wall_s']:.1f}s", flush=True)
        if result is None:
            print(proc.stderr[-3000:], flush=True)
        for k, v in summary.items():
            values.setdefault(k, []).append(v)
    for k, vs in values.items():
        if len(vs) >= 2:
            print(f"{k}: median {statistics.median(vs)!r} spread {spread(vs)!r} n {len(vs)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
