"""Runs one cell of the benchmark once and prints its result.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (an entry of BENCHMARK.json's ``workloads``) names a configuration
and a traffic mix, which lead to their files under perfbench/ (see
harness/spec.py). The run makes its weights and inputs from ``--seed``,
sets up and warms the program (``pytorchvideo_tpu_torch``) on the card,
measures for ``--seconds``, compares what the timed path produced with the
plain float32 reference, and prints one JSON object as its last line of
standard output: the end-to-end metrics, or with ``--trace 1`` the
per-layer ones read from a profiled sub-window. The numbers compared and
their limits are its last lines on standard error, and the object's last
key. Without the cards the cell asks for, or with JAX or the JAX package
loaded, it exits with a code other than 0 and prints no result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# Kernel caches at fixed paths inside the checkout (build/ is not committed),
# so only a cell's first run in a checkout compiles. The program builds its
# nvcc library under build/pytorchvideo_tpu_torch/ itself.
CACHE = ROOT / "build" / "perfbench"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ.setdefault("USE_FLAX", "0")  # no library may load JAX in this process
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from perfbench.harness import guard, spec

    bench = spec.load(ROOT / "BENCHMARK.json")
    cell = spec.cell(bench, args.workload)

    import torch

    from perfbench.harness.device import Card, NoCard
    from perfbench.harness.session import execute

    torch.set_num_threads(4)  # the work is the card's; few host threads keep runs steady
    try:
        device = Card(cell["chips"])
    except NoCard as exc:
        print(f"no card: {exc}", file=sys.stderr)
        return 2
    print(f"card ready at {time.perf_counter() - T0:.3f} s", file=sys.stderr, flush=True)
    result = execute(bench, args.workload, args.seed, args.seconds, bool(args.trace), device, T0)
    print(f"card: {device.power_limit() or device.kind}", file=sys.stderr, flush=True)
    found = guard.loaded_forbidden()
    if found:
        print(f"forbidden modules loaded in the run's process: {found}", file=sys.stderr)
        return 3
    for name, check in result["checks"].items():
        print(f"check {name}: {check['value']!r} (limit {check['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
