"""The readings that the limits of ``correct`` are set from: the program's
own on many seeds, the control's (TF32) and the planted faults', each at
the cell's own size, all in one process so that the port's set-up is paid
once a seed and the card is the same.

    python3 portbench/calibrate.py --workload <name> --first-seed <n> \\
        --runs program:12,tf32:3,half_batch:3 [--seconds <s>] [--same-seeds] [--detail]

Every run prints one JSON line: its mode, seed and readings. Every run
drives a window of ``--seconds`` at the cell's own load: a training cell's
numbers come from set-up's first steps and the window's last, a served
cell's from every answer of the window. ``tf32_reference`` runs the
program unplanted and prints its sound readings beside the control's, so
one set-up gives both. Seeds count up from
``--first-seed`` across all runs, so no two runs share one. The
benchmark's own runs (``run.py``) never plant anything.
"""
import argparse
import contextlib
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--first-seed", type=int, required=True)
    ap.add_argument("--runs", required=True, help="mode:count,... (program, or a fault name)")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--same-seeds", action="store_true",
                    help="every mode starts again from --first-seed")
    ap.add_argument("--detail", action="store_true",
                    help="print where each training reading comes from")
    args = ap.parse_args(argv)

    import torch

    from portbench import faults, spec

    cell = spec.Cell(args.workload)
    seed = args.first_seed
    from henbun_tpu_torch.ops import _build

    _build.build_all()
    for part in args.runs.split(","):
        mode, count = part.split(":")
        if args.same_seeds:
            seed = args.first_seed
        for _ in range(int(count)):
            t0 = time.perf_counter()
            plant = contextlib.nullcontext() if mode == "program" else faults.planted(mode)
            with plant:
                drv = cell.driver.Driver(cell, seed, "cuda")
                drv.setup()
                window = drv.window(args.seconds)[0]
                drv.release()
            readings = (drv.readings(control=mode) if mode == "tf32_reference"
                        else drv.readings())
            line = {"workload": args.workload, "mode": mode, "seed": seed,
                    "readings": readings, "seconds": time.perf_counter() - t0,
                    "window": window}
            if mode == "tf32_reference":
                line["program_readings"] = drv.readings()
            if getattr(drv, "B", 1) == 1:  # one model: its hyperparameters
                from portbench.reference.common import positive

                line["values"] = {k: float(positive(v.double()).reshape(-1)[0])
                                  for k, v in drv.init.items() if v.numel() == 1}
            if args.detail and hasattr(drv, "detail"):
                line["detail"] = drv.detail
            print(json.dumps(line))
            sys.stdout.flush()
            del drv
            gc.collect()
            torch.cuda.empty_cache()
            seed += 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
