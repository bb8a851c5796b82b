"""Registers and spills of the port's CUDA kernels, and their SASS against another checkout.

    python3 benchmarks_torch/kernel_build_report.py [--against DIR] [--out FILE]

Run from the root of a checkout on a machine with ``nvcc`` (no card is
used). Each ``pytorchvideo_tpu_torch/csrc/*.cu`` is compiled as the
library build compiles it (``ops/_build.py``'s flags, one process per
source, all at once) with ``-Xptxas -v``; one line per kernel gives its
registers, spill stores and loads, and stack frame. With ``--against DIR``
(the root of another checkout, say the parent unpacked by ``git archive``)
the sources of both that exist in both are compiled again and their
``cuobjdump -sass`` listings compared, with addresses and the translation
unit's anonymous-namespace tag left out: a change that moves code between
files but not what the compiler makes of it shows 0 differing lines.
Writes everything as JSON to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
ENTRY = re.compile(r"Compiling entry function '(\S+)'")
FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
USED = re.compile(r"Used (\d+) registers")
SASS_NOISE = re.compile(r"_GLOBAL__N__[0-9A-Za-z_]+|/\*[0-9a-f]{4,}\*/")


def compile_all(nvcc: str, flags, sources, out_dir: str, extra=()):
    """Compiles every source at once; returns {source: (object, ptxas log)}."""
    procs = {}
    for src in sources:
        obj = os.path.join(out_dir, src.stem + ".o")
        cmd = [nvcc, *flags, *extra, "-c", "-o", obj, str(src)]
        procs[src] = (obj, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                            text=True))
    done = {}
    for src, (obj, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{log}")
        done[src] = (obj, log)
    return done


def kernels_of(log: str):
    """(kernel, registers, spill stores, spill loads, stack bytes) per entry
    function in a ptxas -v log."""
    rows, name, frame = [], None, None
    for line in log.splitlines():
        m = ENTRY.search(line)
        if m:
            name, frame = m.group(1), None
            continue
        m = FRAME.search(line)
        if m and name:
            frame = tuple(int(x) for x in m.groups())
            continue
        m = USED.search(line)
        if m and name and frame:
            rows.append({"kernel": name, "registers": int(m.group(1)), "stack": frame[0],
                         "spill_stores": frame[1], "spill_loads": frame[2]})
            name = None
    return rows


def demangle(names):
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True, text=True,
                             check=True).stdout.splitlines()
        return out if len(out) == len(names) else names
    except (OSError, subprocess.CalledProcessError):
        return names


def sass(cuobjdump: str, obj: str):
    text = subprocess.run([cuobjdump, "-sass", obj], capture_output=True, text=True,
                          check=True).stdout
    return [SASS_NOISE.sub("", line).rstrip() for line in text.splitlines()]


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--against", help="root of another checkout to compare SASS with")
    parser.add_argument("--out", default=str(REPO / "build" / "kernel_build_report.json"))
    args = parser.parse_args()

    sys.path.insert(0, str(REPO))
    from pytorchvideo_tpu_torch.ops import _build

    nvcc = _build.find_nvcc()
    cuobjdump = str(Path(nvcc).with_name("cuobjdump"))
    sources = sorted(_build.CSRC_DIR.glob("*.cu"))
    report = {"nvcc_flags": list(_build.NVCC_FLAGS), "kernels": [], "sass": []}
    with tempfile.TemporaryDirectory() as tmp:
        built = compile_all(nvcc, _build.NVCC_FLAGS, sources, tmp, ("-Xptxas", "-v"))
        for src, (_, log) in built.items():
            rows = kernels_of(log)
            for row, name in zip(rows, demangle([r["kernel"] for r in rows])):
                row.update(source=src.name, name=name)
                report["kernels"].append(row)
                print(f"{src.name}: {name}: {row['registers']} registers, spill stores "
                      f"{row['spill_stores']} / loads {row['spill_loads']} bytes, stack "
                      f"{row['stack']} bytes")
        if args.against:
            other_dir = Path(args.against) / "pytorchvideo_tpu_torch" / "csrc"
            pairs = [(src, other_dir / src.name) for src in sources
                     if (other_dir / src.name).is_file()]
            os.mkdir(os.path.join(tmp, "against"))
            theirs = compile_all(nvcc, _build.NVCC_FLAGS, [o for _, o in pairs],
                                 os.path.join(tmp, "against"))
            for src, other in pairs:
                ours_sass = sass(cuobjdump, built[src][0])
                their_sass = sass(cuobjdump, theirs[other][0])
                differ = sum(a != b for a, b in zip(ours_sass, their_sass)) + abs(
                    len(ours_sass) - len(their_sass))
                report["sass"].append({"source": src.name, "lines": len(ours_sass),
                                       "lines_against": len(their_sass), "differing": differ})
                print(f"{src.name}: SASS {len(ours_sass)} lines against {len(their_sass)} in "
                      f"{args.against}; {differ} differ")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
