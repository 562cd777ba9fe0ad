#!/usr/bin/env python3
"""Run one cell of the benchmark of raytracing_c_tpu_torch once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with an NVIDIA GPU. It makes the
cell's inputs from the seed, warms up, renders whole frames for at least
--seconds, and prints one JSON line last on stdout: `correct` (a seeded
sample of the window's output against the plain reference), the cell's
end-to-end metrics (--trace 0) or per-layer metrics (--trace 1, read from
one profiled group of batches after the window), the device, and the
numbers of the check beside their limits (also the last lines of stderr).
It exits non-zero and prints no result without a CUDA device, or if JAX
or the JAX package was loaded. BENCHMARK.json at the root names the cells.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
#: modules that must not be loaded, compared by whole top-level name
FORBIDDEN = {"jax", "jaxlib", "flax", "raytracing_c_tpu"}


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every build and kernel cache of the run inside the checkout, at fixed
    # paths (the program's nvcc builds go to raytracing_c_tpu_torch/_build/)
    cache = os.path.join(ROOT, ".bench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    sys.path[:0] = [BENCH, ROOT]

    import torch

    from harness import runner, spec

    bench = spec.load_benchmark()
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}.get(args.workload)
    if chips is None:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    run = runner.Run(args.workload, args.seed, args.seconds, bool(args.trace), "cuda:0",
                     T_START, bench)
    out = runner.run_cell(run)
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    runner.print_result(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
