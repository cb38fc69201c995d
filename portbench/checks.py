"""The numbers that decide ``correct``, each against its limit.

A training cell compares the first three steps of set-up's ``optimize``
call (the window's own call, at its chunk size) with the float64
reference's three Adam steps from the same inputs:

* ``loss_gap``: the largest |program - reference| / |reference| of the
  objective the program recorded at each step (a fleet's is its sum);
* ``grad_gap``: the first gradient as the optimizer got it (Adam's first
  moment after one step over 1 - beta1), by the worst leaf: the gap between
  the program's norm and the reference's, over the reference's norm of
  that leaf or of the median leaf, whichever is larger;
* ``step_gap``: the same of the parameters' change over the three steps,
  over the leaves whose reference gradient is at least a thousandth of the
  median leaf's (a leaf nought to rounding moves under Adam by round-off
  alone);
* ``grad_gap_median``, ``step_gap_median``: the median leaf's gap, steady
  from seed to seed where the worst leaf's is not (a fleet's thousands of
  leaves). A cell's ``limits`` name the numbers it compares.

A leaf is one parameter of one model: a fleet's stacked [B, ...] tensor is
B leaves.

It also compares the window's last step, at the program's own state there
(its parameters before the step, with the step's noise, and its Adam
moments): ``last_loss_gap`` the objective the program recorded against the
reference's at those parameters; ``last_grad_gap`` (and ``_median``) the
gradient the optimizer got against the reference's, and ``last_step_gap``
(and ``_median``) the parameters' change against one reference Adam step
from that state, both by leaf as above.

A served cell compares every answer of the window with the reference's:
``mean_gap`` the largest |mean - reference| over sqrt(k_var), the prior's
scale of f, and ``var_gap`` the largest |variance - reference| over k_var.
"""
from __future__ import annotations

import sys

import torch


def _leaf_norms(d, batched):
    """{(path, model): norm}, every model of a fleet its own leaf."""
    out = {}
    for path, v in d.items():
        v = v.double()
        if batched:
            norms = torch.linalg.vector_norm(v.reshape(v.shape[0], -1), dim=1)
            for i, x in enumerate(norms.cpu().tolist()):
                out[(path, i)] = x
        else:
            out[(path, 0)] = float(torch.linalg.vector_norm(v))
    return out


def leaf_gaps(got, ref, batched, keep=None):
    """Every leaf's |norm(got) - norm(ref)| / max(norm(ref), the median
    leaf's norm(ref)), as a float64 tensor; `keep` limits the leaves."""
    g, r = _leaf_norms(got, batched), _leaf_norms(ref, batched)
    keys = [k for k in r if keep is None or k in keep]
    med = float(torch.tensor([r[k] for k in keys], dtype=torch.float64).median())
    gaps = [abs(g[k] - r[k]) / max(r[k], med, 1e-300) for k in keys]
    return torch.nan_to_num(torch.tensor(gaps, dtype=torch.float64), nan=float("inf"))


def moving_leaves(ref_grad, batched, share=1e-3):
    """The leaves whose reference gradient norm is at least `share` of the
    median leaf's."""
    r = _leaf_norms(ref_grad, batched)
    med = float(torch.tensor(list(r.values()), dtype=torch.float64).median())
    return {k for k, x in r.items() if x >= share * med}


def fit_readings(prog, ref, batched):
    """{loss_gap, grad_gap, step_gap} of the program's first three steps
    (`prog`: "losses", "grad", "p0", "p3") against the reference's."""
    losses = [abs(a - b) / max(abs(b), 1e-300) for a, b in zip(prog["losses"], ref["losses"])]
    if len(losses) != len(ref["losses"]):
        losses.append(float("inf"))
    step_p = {k: prog["p3"][k].double() - prog["p0"][k].double() for k in prog["p0"]}
    step_r = {k: ref["p3"][k] - ref["p0"][k] for k in ref["p0"]}
    keep = moving_leaves(ref["grad"], batched)
    grad = leaf_gaps(prog["grad"], ref["grad"], batched)
    step = leaf_gaps(step_p, step_r, batched, keep)
    return {
        "loss_gap": max(losses),
        "grad_gap": float(grad.max()),
        "step_gap": float(step.max()),
        "grad_gap_median": float(grad.median()),
        "step_gap_median": float(step.median()),
    }


def last_readings(prog, ref, batched):
    """{last_loss_gap, last_grad_gap(_median), last_step_gap(_median)} of
    the window's last step (`prog`, `ref`: "loss", "grad", "step")."""
    grad = leaf_gaps(prog["grad"], ref["grad"], batched)
    step = leaf_gaps(prog["step"], ref["step"], batched, moving_leaves(ref["grad"], batched))
    return {
        "last_loss_gap": abs(prog["loss"] - ref["loss"]) / max(abs(ref["loss"]), 1e-300),
        "last_grad_gap": float(grad.max()),
        "last_step_gap": float(step.max()),
        "last_grad_gap_median": float(grad.median()),
        "last_step_gap_median": float(step.median()),
    }


def leaf_detail(got, ref, batched, keep=None):
    """Per path: the worst and the median leaf's gap (as ``norm_gap``
    measures it) and, for the worst, its model, reference norm and program
    norm: what ``calibrate.py --detail`` prints to find where a reading
    comes from."""
    g, r = _leaf_norms(got, batched), _leaf_norms(ref, batched)
    keys = [k for k in r if keep is None or k in keep]
    med = float(torch.tensor([r[k] for k in keys], dtype=torch.float64).median())
    out = {}
    for path in sorted({k[0] for k in keys}):
        gaps = sorted((abs(g[k] - r[k]) / max(r[k], med, 1e-300), k) for k in keys
                      if k[0] == path)
        worst, wk = gaps[-1]
        out[path] = {"worst": worst, "median": gaps[len(gaps) // 2][0], "model": wk[1],
                     "ref_norm": r[wk], "prog_norm": g[wk], "median_leaf": med}
    return out


def fit_detail(prog, ref, batched):
    """``leaf_detail`` of the first gradient and of the three steps'
    change, and the loss gap of each step."""
    step_p = {k: prog["p3"][k].double() - prog["p0"][k].double() for k in prog["p0"]}
    step_r = {k: ref["p3"][k] - ref["p0"][k] for k in ref["p0"]}
    return {"losses": [abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])],
            "grad": leaf_detail(prog["grad"], ref["grad"], batched),
            "step": leaf_detail(step_p, step_r, batched, moving_leaves(ref["grad"], batched))}


def judge(readings, limits):
    """(correct, [(name, value, limit)]): every reading is finite and at or
    under its limit, and every limit has a reading."""
    rows, ok = [], True
    for name in sorted(limits):
        value = readings.get(name, float("nan"))
        good = value == value and value <= limits[name]
        ok = ok and good
        rows.append((name, value, limits[name]))
    return ok, rows


def report(rows):
    """Print each compared number beside its limit as the last lines on
    standard error; return them for the result's line."""
    for name, value, limit in rows:
        print("check %s %r limit %r" % (name, value, limit), file=sys.stderr)
    sys.stderr.flush()
    return {name: {"value": value, "limit": limit} for name, value, limit in rows}
