"""Readings that a cell's limits are set from, on the card.

    python3 benchmark/calibrate.py --workload full-ac256.ppo-fused \\
        --seeds 11,12,13 --control 3 --out chiprun_out/calib.jsonl

For each seed: the cell's set-up (and, with ``--seconds``, a short window)
as a run makes it, then the reference from the same inputs, and the
numbers compared ("sound"). On the first ``--control`` seeds also the
control, the reference in the precision below the configuration's, in the
program's place ("control"), and each fault of the cell's driver
(``FAULTS``, or ``--faults``) planted in the program ("fault:<name>"),
all against that seed's one reference. One JSON line a reading goes to ``--out``; the last line of
standard output sums them up: per number, the largest sound reading and
the smallest of the control and of each fault.
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--faults", default=None,
                    help="comma-separated; default: the driver's FAULTS")
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    torch.set_num_threads(1)
    from benchmark import faults as FL
    from benchmark.harness import manifest as M
    spec = M.cell(M.load(ROOT), args.workload, ROOT)
    drv = M.driver(spec["traffic"]["driver"])
    dev = torch.device("cuda", 0)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    summary = {}

    def program(seed):
        run = drv.setup(spec, seed, dev)
        if args.seconds:
            drv.window(run, args.seconds)
        drv.release(run)
        gc.collect()
        return run

    def note(seed, kind, nums, t0):
        line = {"seed": seed, "kind": kind, "numbers": nums, "seconds": time.perf_counter() - t0}
        with out.open("a") as f:
            f.write(json.dumps(line) + "\n")
        print(json.dumps(line), flush=True)
        pick = max if kind == "sound" else min
        for k, v in nums.items():
            key = f"{kind}.{k}"
            summary[key] = v if key not in summary else pick(summary[key], v)

    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        run = program(seed)
        ref = drv.reference_record(run)
        note(seed, "sound", drv.numbers(run["record"], ref), t0)
        if i >= args.control:
            continue
        t0 = time.perf_counter()
        note(seed, "control", drv.numbers(drv.reference_record(run, **drv.CONTROL), ref), t0)
        faults = drv.FAULTS if args.faults is None else filter(None, args.faults.split(","))
        for fault in faults:
            t0 = time.perf_counter()
            with FL.planted(spec["traffic"]["driver"], fault):
                bad = program(seed)
            note(seed, f"fault:{fault}", drv.numbers(bad["record"], ref), t0)
    print(json.dumps({"workload": args.workload, "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
