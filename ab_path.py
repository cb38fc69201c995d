"""The 16-model GPR fleet's steps/s (``chip_smoke.path_phase``: n = 40,
500 steps in chunks of 200) of two checkouts, in turns on one card.

    python ab_path.py <checkout A> <checkout B> [--rounds 1] [--profile]
    python ab_path.py --ops <checkout> [--rounds 1]

Each turn is a fresh process that imports the checkout's own package and
``chip_smoke.py``, builds its kernels (into that checkout's ``build/``)
and runs the path phase; the order is A, B, B, A per round, so a drift of
the host's speed over the call falls on both. ``--profile`` then runs the
path phase once more in each checkout under cProfile and prints its
functions by their own host time and its count of Python calls a step.

``--ops`` measures what routing K1 and K2 through their ``torch.library``
custom ops costs the fleet, in one process of one checkout: the path
phase with the ops and with the dispatch calling the kernel wrappers
directly, in turns (op, direct, direct, op per round) after one warm-up
phase.

Prints one line a turn and a JSON summary (each side's turns and median)
last. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

TURN = r"""
import cProfile, io, json, pstats, sys
sys.path.insert(0, sys.argv[1])
import torch
import chip_smoke as cs
import henbun_tpu_torch as hb
from henbun_tpu_torch.ops import _build
_build.build_all()
if sys.argv[2] == "profile":
    cs.path_phase(torch, hb)
    prof = cProfile.Profile()
    prof.enable()
    launches, rate = cs.path_phase(torch, hb)
    prof.disable()
    out = io.StringIO()
    stats = pstats.Stats(prof, stream=out)
    stats.sort_stats("tottime").print_stats(25)
    print(out.getvalue())
    print(json.dumps({"steps_per_s": rate, "launches": launches,
                      "calls_per_step": stats.total_calls / cs.STEPS}))
elif sys.argv[2] == "ops":
    import types
    from henbun_tpu_torch.ops import cuda_chol, library, linalg
    direct = types.SimpleNamespace(
        cholesky128=lambda A: cuda_chol.cholesky128_vbatched(A.contiguous()),
        tri_solve128=library._solve)
    cs.path_phase(torch, hb)
    rates = {"op": [], "direct": []}
    for _ in range(int(sys.argv[3])):
        for label in ("op", "direct", "direct", "op"):
            linalg.library = direct if label == "direct" else library
            rates[label].append(cs.path_phase(torch, hb)[1])
            print("%s steps_per_s=%.1f" % (label, rates[label][-1]), flush=True)
    print(json.dumps(rates))
else:
    launches, rate = cs.path_phase(torch, hb)
    print(json.dumps({"steps_per_s": rate, "launches": launches}))
"""


def turn(checkout, mode="time", rounds=1):
    res = subprocess.run([sys.executable, "-c", TURN, checkout, mode, str(rounds)],
                         cwd=checkout, env=dict(os.environ, PYTHONPATH=checkout),
                         capture_output=True, text=True, timeout=900)
    if res.returncode != 0:
        raise RuntimeError("path phase in %s failed:\n%s\n%s"
                           % (checkout, res.stdout[-3000:], res.stderr[-3000:]))
    lines = res.stdout.strip().splitlines()
    return json.loads(lines[-1]), "\n".join(lines[:-1])


def summary(**fields):
    rates = fields["steps_per_s"]
    fields["median"] = {k: statistics.median(v) for k, v in rates.items() if v}
    print(json.dumps(fields))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("checkouts", nargs="*")
    ap.add_argument("--ops", metavar="CHECKOUT")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args(argv)
    if args.ops:
        rates, log = turn(os.path.abspath(args.ops), "ops", args.rounds)
        print(log)
        summary(checkout=args.ops, steps_per_s=rates)
        return
    a, b = args.checkouts
    rates = {"a": [], "b": []}
    for _ in range(args.rounds):
        for label, checkout in (("a", a), ("b", b), ("b", b), ("a", a)):
            out, _ = turn(os.path.abspath(checkout))
            rates[label].append(out["steps_per_s"])
            print("%s %s steps_per_s=%.1f launches %s"
                  % (label, checkout, out["steps_per_s"], out["launches"]), flush=True)
    calls = {}
    if args.profile:
        for label, checkout in (("a", a), ("b", b)):
            out, log = turn(os.path.abspath(checkout), "profile")
            calls[label] = out["calls_per_step"]
            print("profile %s %s: %.1f Python calls a step\n%s"
                  % (label, checkout, calls[label], log), flush=True)
    summary(a=a, b=b, steps_per_s=rates, calls_per_step=calls)


if __name__ == "__main__":
    main()
