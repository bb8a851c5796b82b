"""Reads the correctness check's control on the card: the reference at the
precision below the configuration's put in the program's place, at the
cell's own sizes, for each seed given. One process for all seeds.

    python3 perfbench/tools/control.py --workload <cell> --seeds 1,2,3 [--out file.jsonl]

Prints one JSON line per seed: {"workload", "seed", "dtype", "<check>": number}.
The benchmark's own runs never run it."""

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
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--out")
    args = parser.parse_args(argv)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)

    from perfbench.harness import spec
    from perfbench.harness.device import Card
    from perfbench.harness.session import Run
    from perfbench.reference.common import CONTROL_DTYPE

    bench = spec.load(ROOT / "BENCHMARK.json")
    device = Card(spec.cell(bench, args.workload)["chips"])
    lines = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        run = Run(bench, args.workload, seed, 0.0, False, device, t0)
        value = run.kind.control(run, CONTROL_DTYPE)
        line = {"workload": args.workload, "seed": seed, "dtype": str(CONTROL_DTYPE),
                "control": value, "seconds": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        lines.append(line)
        del run
        device.free()
    if args.out:
        with open(args.out, "a") as f:
            f.writelines(json.dumps(line) + "\n" for line in lines)
    return 0


if __name__ == "__main__":
    sys.exit(main())
