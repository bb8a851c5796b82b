"""Reads the correctness check's numbers with a fault planted underneath
the timed path, on the card at the cell's own size, for each seed given
(one process for all): the readings that a limit's upper end is set from.

    python3 perfbench/tools/fault_readings.py --workload <cell> --fault half_batch \\
        --seeds 1,2,3 [--seconds 2] [--out file.jsonl]

The faults are those of perfbench/tests/faults.py. The benchmark's own runs
never plant one."""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--fault", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--out")
    args = parser.parse_args(argv)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)

    from perfbench.harness import spec
    from perfbench.harness.device import Card
    from perfbench.harness.session import execute
    from perfbench.tests import faults

    source = {**faults.SERVE_FAULTS, **faults.TRAIN_FAULTS, **faults.REPLAY_FAULTS}[args.fault][0]
    exec(source, {})  # noqa: S102 - the fault's own source, from faults.py
    bench = spec.load(ROOT / "BENCHMARK.json")
    device = Card(spec.cell(bench, args.workload)["chips"])
    for seed in (int(s) for s in args.seeds.split(",")):
        result = execute(bench, args.workload, seed, args.seconds, False, device,
                         time.perf_counter())
        line = {"workload": args.workload, "fault": args.fault, "seed": seed,
                "correct": result["correct"],
                "checks": {k: v["value"] for k, v in result["checks"].items()}}
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
        device.free()
    return 0


if __name__ == "__main__":
    sys.exit(main())
