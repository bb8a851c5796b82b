"""The fused kv-pool's pool-LN launch of one checkout, per MViT-B 16x4 geometry, on one CUDA card.

    python3 benchmarks_torch/pool_ln_variants.py [--repo DIR] [--out FILE]

Run on a machine with a CUDA card and ``nvcc``. ``pytorchvideo_tpu_torch`` and
``chip_smoke`` are imported from ``--repo`` (default: this checkout), so two
states of the kernel, each unpacked into its own directory, can be timed in
alternation in one call, one process each. At B32 in bf16, on the inputs of
``chip_smoke.fused_inputs`` for each of ``chip_smoke.MVIT_FUSED``'s seven
geometries, it times the pool-LN launch alone (``_pool_ln_cuda``) on its
tiled route (the faster of two runs of ``ITERS`` launches) and on its scalar
route (the first version), with ``chip_smoke.cuda_time_ms``, and sums each
over the 16 launches of a forward. Prints one line per geometry (the times,
the tile and the shared memory of its plan) and writes them as JSON to
``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 32
ITERS = 20


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--repo", default=REPO)
    parser.add_argument("--out", default=None)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("pool_ln_variants: torch.cuda.is_available() is false; this run needs a CUDA card")
    sys.path.insert(0, os.path.abspath(args.repo))
    import chip_smoke as cs
    from pytorchvideo_tpu_torch.ops import fused_kvpool_attention as fk

    print(cs.nvidia_smi_line())
    gen = torch.Generator(device="cuda").manual_seed(6)
    shapes = []
    for thw, HC, heads, stride, _, calls in cs.MVIT_FUSED:
        t = cs.fused_inputs(gen, BATCH, thw, HC, heads, 8, torch.bfloat16)
        pooled = tuple(fk.pool_out(d, 3, s, 1) for d, s in zip(thw, stride))
        shapes.append((thw, HC, heads, stride, pooled, calls, t))
    rows = []
    for thw, HC, heads, stride, pooled, calls, t in shapes:
        def launch(route):
            return fk._pool_ln_cuda(t["k_grid"], t["v_grid"], t["wk"], t["wv"], t["lnk"], t["lnv"],
                                    t["cls_k"], t["cls_v"], thw, heads, (3, 3, 3), stride,
                                    cs.FUSED_EPS, pooled, route)

        plan = fk.pool_ln_tile_plan(BATCH, *thw, HC, heads, stride, torch.bfloat16)
        rows.append({"grid": list(thw), "stride": list(stride), "calls": calls,
                     "tiled_ms": min(cs.cuda_time_ms(lambda: launch("tiled"), ITERS)
                                     for _ in range(2)),
                     "scalar_ms": cs.cuda_time_ms(lambda: launch("scalar"), ITERS // 2),
                     "tile": [plan.tile_h, plan.tile_w], "depth": plan.depth,
                     "smem_bytes": plan.smem_bytes})
    tiled = sum(r["calls"] * r["tiled_ms"] for r in rows)
    scalar = sum(r["calls"] * r["scalar_ms"] for r in rows)
    print(f"{args.repo}: pool-LN per B{BATCH} forward tiled {tiled!r} ms, scalar {scalar!r} ms")
    for r in rows:
        print(f"    {tuple(r['grid'])} s{tuple(r['stride'])} x{r['calls']}: tiled "
              f"{r['tiled_ms']!r} ms, scalar {r['scalar_ms']!r} ms, tile {tuple(r['tile'])}, "
              f"depth {r['depth']}, {r['smem_bytes']} B")
    report = {"repo": args.repo, "tiled_ms": tiled, "scalar_ms": scalar, "rows": rows}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()
