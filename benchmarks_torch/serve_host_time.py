"""Host and wall time per served MViT-B 16x4 forward of one checkout, on one CUDA card.

    python3 benchmarks_torch/serve_host_time.py [--repo DIR] [--out FILE]
    python3 benchmarks_torch/serve_host_time.py --summarize DIR

Run on a machine with a CUDA card and ``nvcc``. ``pytorchvideo_tpu_torch`` and
``chip_smoke`` are imported from ``--repo`` (default: this checkout), so two
checkouts, a parent and its change, can be run in alternation, one process
each, with this one script. The model is ``hub.mvit_base_16x4()`` at full
width and depth, 16x224x224, with the seeded random weights of
``chip_smoke.randomize_mvit_``, in its bf16 deploy form, unfused ("kernels")
and with ``fused_kvpool=True`` ("fused"), the same weights.

At B1 and B8, each form serves ``WARMUP`` forwards and then ``ITERS`` timed
ones, one request at a time: the card is synchronised before each forward,
the host clock read when the call returns (host ms: the time the host takes
to enqueue the forward) and again after the card is synchronised (wall ms:
the request's latency). Where host ms is close to wall ms, the card waits on
the host. Prints and writes (``--out``) the median and the mean of each.
Where the checkout registers the ``pvt::`` custom ops, it also times the
host's cost of one attention launch at MViT-B's last cls query (B1, Lq 1,
Lk 50, 8 heads of 96) called through its wrapper, as the eager forward
calls it, and through ``torch.ops.pvt.pooled_attention_packed``, as a
traced program calls it: the dispatch an eager forward would pay per
kernel call if it went through the op; and the host's cost of the tracing
test (``torch.compiler.is_compiling()``) each dispatcher makes per call.

``--summarize DIR`` reads the ``<pair>_parent.json`` and ``<pair>_change.json``
files of alternating runs in DIR (no card needed) and prints, per form,
batch and time, each side's median over the pairs, the parent's own spread
(the distance between its quartiles) and the pairs the change wins.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import statistics
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCHES = (1, 8)
WARMUP = 3
ITERS = 30


def summarize(run_dir: str) -> None:
    """Pair statistics of the alternating runs in ``run_dir``."""
    runs = {}
    for name in sorted(os.listdir(run_dir)):
        pair, _, side = name.removesuffix(".json").partition("_")
        if name.endswith(".json") and side in ("parent", "change"):
            with open(os.path.join(run_dir, name)) as f:
                for row in json.load(f)["rows"]:
                    runs.setdefault((row["form"], row["batch"]), {}).setdefault(pair, {})[side] = row
    for (form, B), pairs in runs.items():
        pairs = [p for p in pairs.values() if len(p) == 2]
        for metric in ("wall_ms_median", "host_ms_median"):
            parent = [p["parent"][metric] for p in pairs]
            change = [p["change"][metric] for p in pairs]
            q1, _, q3 = statistics.quantiles(parent, n=4)
            wins = sum(c < p for p, c in zip(parent, change))
            print(f"{form} B{B} {metric.split('_')[0]} ms per forward over {len(pairs)} pairs: "
                  f"parent median {statistics.median(parent)!r} (quartiles {q1!r} - {q3!r}), "
                  f"change median {statistics.median(change)!r}; the change faster in {wins} "
                  f"pairs; parent {[round(t, 2) for t in parent]}, change "
                  f"{[round(t, 2) for t in change]}")


def dispatch_us(calls: int = 500):
    """Host us per attention launch through the wrapper and through the
    custom op, and per tracing test (None where the checkout has no
    ``pvt::`` ops); the faster of two runs each, in turns."""
    import torch
    pa = importlib.import_module("pytorchvideo_tpu_torch.ops.pooled_attention")

    if not hasattr(pa, "_packed_op"):
        return None
    q = torch.randn(1, 1, 768, device="cuda", dtype=torch.bfloat16)
    k = torch.randn(1, 50, 768, device="cuda", dtype=torch.bfloat16)
    scale = 96 ** -0.5
    fns = {"wrapper": lambda: pa.pooled_attention_packed_cuda(q, k, k, 8, scale),
           "op": lambda: torch.ops.pvt.pooled_attention_packed(q, k, k, 8, scale, False),
           "tracing_test": torch.compiler.is_compiling}
    runs = {name: [] for name in fns}
    for name in ("wrapper", "op", "tracing_test", "tracing_test", "op", "wrapper"):
        fns[name]()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fns[name]()
        runs[name].append((time.perf_counter() - t0) * 1e6 / calls)
        torch.cuda.synchronize()
    out = {name: min(times) for name, times in runs.items()}
    print(f"one cls-query attention launch, host us per call: through the wrapper "
          f"{out['wrapper']!r}, through torch.ops.pvt {out['op']!r}; the tracing test "
          f"{out['tracing_test']!r} us", flush=True)
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--repo", default=REPO, help="checkout whose port is timed")
    parser.add_argument("--out", default=os.path.join(REPO, "build", "serve_host_time.json"))
    parser.add_argument("--summarize", metavar="DIR", help="print the pair statistics of DIR")
    args = parser.parse_args()
    if args.summarize:
        summarize(args.summarize)
        return

    import torch

    if not torch.cuda.is_available():
        sys.exit("serve_host_time: torch.cuda.is_available() is false; this run needs a CUDA card")
    repo = os.path.abspath(args.repo)
    sys.path.insert(0, repo)
    from chip_smoke import MVIT_CLIP, nvidia_smi_line, randomize_mvit_
    from pytorchvideo_tpu_torch.accelerate import convert_to_deployable_form
    from pytorchvideo_tpu_torch.models import hub

    card = nvidia_smi_line()
    gen = torch.Generator().manual_seed(0)
    model = hub.mvit_base_16x4()
    randomize_mvit_(model, gen)
    fused = hub.mvit_base_16x4(fused_kvpool=True)
    fused.load_state_dict(model.state_dict(), strict=True)
    forms = {"kernels": convert_to_deployable_form(model, dtype=torch.bfloat16),
             "fused": convert_to_deployable_form(fused, dtype=torch.bfloat16)}
    del model, fused
    report = {"repo": repo, "card": card, "torch": torch.__version__, "iters": ITERS, "rows": []}
    with torch.no_grad():
        for B in BATCHES:
            x = torch.randn(B, 3, *MVIT_CLIP, generator=gen).to("cuda", torch.bfloat16)
            for name, form in forms.items():
                host, wall = [], []
                for i in range(WARMUP + ITERS):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    form(x)
                    t1 = time.perf_counter()
                    torch.cuda.synchronize()
                    t2 = time.perf_counter()
                    if i >= WARMUP:
                        host.append((t1 - t0) * 1e3)
                        wall.append((t2 - t0) * 1e3)
                row = {"form": name, "batch": B,
                       "host_ms_median": statistics.median(host), "host_ms_mean": statistics.mean(host),
                       "wall_ms_median": statistics.median(wall), "wall_ms_mean": statistics.mean(wall)}
                report["rows"].append(row)
                print(f"mvit_base_16x4 deploy ({name}) bf16 B{B} [{repo}]: host "
                      f"{row['host_ms_median']!r} ms (mean {row['host_ms_mean']!r}), wall "
                      f"{row['wall_ms_median']!r} ms (mean {row['wall_ms_mean']!r}) per forward, "
                      f"median of {ITERS} on {card}", flush=True)
        report["dispatch_us"] = dispatch_us()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
