"""One run of one cell of the benchmark of henbun_tpu_torch.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Builds the port's kernels (``henbun_tpu_torch/ops/_build.py``, into
``build/henbun_tpu_torch/`` inside the checkout, so only a checkout's first
run compiles), makes every input from ``--seed`` on the card, warms the
cell's own shapes, drives the cell's entry for ``--seconds`` (``--trace
0``: the end-to-end metrics) or through short traced windows (``--trace
1``: the per-layer metrics), compares what the timed path produced with the
float64 reference, and prints one JSON line last on standard output.

Without a CUDA card, with fewer cards than the cell asks for, or with
``jax``, ``jaxlib``, ``flax`` or ``henbun_tpu`` loaded once the window has
closed, it exits with a code other than 0 and prints no result.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "henbun_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name, taken whole, is forbidden."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def run_cell(name, seed, seconds, trace, device="cuda", t_start=None):
    """One run of cell `name` on `device`: the result's dict (without
    ``device``'s card fields on the CPU). Takes no notice of whether a card
    is there; :func:`main` does."""
    import torch

    from portbench import checks, spec, tracing

    t_start = T_START if t_start is None else t_start
    cell = spec.Cell(name)
    device = torch.device(device)
    if device.type == "cuda":
        from henbun_tpu_torch.ops import _build

        _build.build_all()
        torch.cuda.reset_peak_memory_stats()
    drv = cell.driver.Driver(cell, seed, device)
    drv.setup()
    setup_s = time.perf_counter() - t_start
    out_device = {"platform": "gpu" if device.type == "cuda" else device.type,
                  "kind": torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu",
                  "count": int(cell.workload["chips"])}
    breakdown = None
    if trace:
        # the program's own peak: the host window's profiler keeps every
        # traced step's tensors alive while it runs
        peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
        digest, attempted = drv.traced()
        failed = 0
        metrics = {}
        for mname, reader in spec.metric_readers().items():
            if reader.MOVES not in drv.e2e:
                continue
            value = reader.read(digest)
            if value is not None:
                metrics[mname] = {"value": value, "unit": reader.UNIT}
        out_device.update(busy_s=digest["busy_s"], window_s=digest["window_s"])
        breakdown = {"device_ops": tracing.top(digest["device_ops"]),
                     "idle_gaps": [[n, s] for n, s in digest["host"]["idle_by_host"][:10]]}
    else:
        e2e, attempted, failed = drv.window(seconds)
        metrics = {k: {"value": v, "unit": drv.e2e[k]} for k, v in e2e.items()}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
        if device.type == "cuda":
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
    if device.type == "cuda":
        out_device["memory_peak_bytes"] = int(peak)
    drv.release()
    readings = drv.readings()
    correct, rows = checks.judge(readings, cell.limits)
    result = {"correct": bool(correct and failed == 0), "attempted": int(attempted),
              "failed": int(failed), "metrics": metrics, "device": out_device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks.report(rows)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench import spec

    chips = int(spec.Cell(args.workload).workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print("portbench: the cell needs %d CUDA card(s); torch finds %d"
              % (chips, torch.cuda.device_count() if torch.cuda.is_available() else 0),
              file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, args.trace)
    bad = forbidden_modules()
    if bad:
        print("portbench: forbidden modules loaded: %s" % ", ".join(bad), file=sys.stderr)
        return 3
    print(json.dumps(result))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
