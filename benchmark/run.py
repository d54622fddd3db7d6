"""Run one cell of ``BENCHMARK.json`` on this machine's card and print its
result as the last line of standard output.

    python3 benchmark/run.py --workload full-ac256.ppo-fused --seed 7 \\
        --seconds 40 --trace 0

``--trace 0`` measures the cell's end-to-end metrics over ``--seconds`` of
work; ``--trace 1`` profiles a few steps of it and reports its per-layer
metrics. Both check what the timed path produced against the plain
reference (``benchmark/reference``) once the work is done, and print each
number compared beside its limit as the last lines of standard error and
under ``checks`` in the result. Run from the root of a checkout; kernels
build into ``build/`` there.
"""
import time

T_START = time.perf_counter()

import argparse                     # noqa: E402
import json                         # noqa: E402
import os                           # noqa: E402
import subprocess                   # noqa: E402
import sys                          # noqa: E402
from pathlib import Path            # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "balatro_gym_tpu"}
THREADS = 1


def _environment() -> None:
    """Caches at fixed paths inside the checkout; no library loads JAX."""
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the run must not load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def power_limit() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    sys.path.insert(0, str(ROOT))
    import torch
    torch.set_num_threads(THREADS)
    from benchmark.harness import manifest as M
    from benchmark.harness import runner
    chips = M.cell(M.load(ROOT), args.workload, ROOT)["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: the cell needs {chips} CUDA card(s); torch sees {n}",
              file=sys.stderr)
        return 2
    result = runner.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                             torch.device("cuda", 0), T_START)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {bad}", file=sys.stderr)
        return 3
    result["device"]["power"] = power_limit()
    checks = result.pop("checks")
    result["checks"] = checks
    for k, v in checks.items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
