"""The benchmark of the PyTorch/CUDA renderer `caitlynrenderer_tpu_torch`:
one run of one cell of BENCHMARK.json, ending in one JSON line.

    python3 -m cellbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the repository's root, on a machine with the CUDA cards the cell
asks for; it exits with code 2 and prints no result without them.  With
`--trace 0` the result's metrics are the cell's end-to-end metrics, with
`--trace 1` its per-layer metrics, read from a traced segment after the
window.  The output check runs in both; its numbers, each beside its
limit, are the last lines on standard error and the last key of the
result.  The program's kernels build at their first use into the
program's own build directory inside the checkout, so only a checkout's
first run compiles.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

# Names no module loaded by the run may have (whole top-level names): the
# JAX reference package of the port and JAX itself.
FORBIDDEN = ("jax", "jaxlib", "flax", "caitlynrenderer_tpu")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from cellbench import manifest

    bench = manifest.load()
    cell = manifest.workload(bench, args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"cell {args.workload} needs {cell['chips']} CUDA card(s); {have} visible",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)

    from cellbench import drive

    result, info = drive.run_cell(bench, args.workload, args.seed, args.seconds,
                                  bool(args.trace), "cuda:0", T_START, chips=cell["chips"])
    found = forbidden_modules()
    if found:
        print(f"the run loaded {', '.join(found)}, which the benchmark forbids", file=sys.stderr)
        return 3
    for line in info:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
