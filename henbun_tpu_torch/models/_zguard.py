"""Shared trainable-inducing-point guard for the evidence families.

Under evidence objectives a trainable z is unsafe as it is: the evidence
gradient drives neighbouring points into collision and then to a
Cholesky-gradient NaN (see ``gp.gp.z_repulsion``). Every evidence family
(``SparseGPC``, ``SparseGPRobust``) therefore freezes z by default and,
with ``train_z=True``, subtracts this repulsion barrier from its objective,
so collisions are impossible while spacings above the barrier onset stay
unconstrained.
"""
from __future__ import annotations

# The evidence families' abort hint: the Optimizer's nan-guard names this
# instead of the natural-gradient pairing rule when a run goes non-finite
# twice in a row (model.py's abort path reads `model._nan_hint`).
EVIDENCE_NAN_HINT = (
    "Likely causes in an evidence family: (a) colliding inducing points — "
    "with train_z=True the repulsion barrier should prevent this, check "
    "gp.gp.z_min_spacing(model.gp.z.value); (b) likelihood/kernel scale "
    "beyond float32 — the multiclass engine's square-root curvature path "
    "lifts the old n*k_var ~ 2e5 per-class envelope, but custom engines "
    "forming I + A^T W A directly still round its unit eigenvalue floor "
    "away (subsample or reduce k_var); (c) settings.numerics.jitter_level "
    "below the measured 1e-4 Cholesky-gradient floor (docs/PERF.md)."
)


def setup_z_guard(model, z, train_z, z_penalty, n_data):
    """Record the barrier's constants on `model` at setUp time.

    d0 (barrier onset) = half the initial min spacing: a quantile-initialized
    z starts everywhere above d0, so the barrier starts exactly inactive and
    only engages when training closes a gap. weight defaults to n_data
    (evidence gradients are O(n)); ``z_penalty`` overrides it.
    """
    from ..gp.gp import z_min_spacing

    model._nan_hint = EVIDENCE_NAN_HINT
    model._train_z = bool(train_z)
    s0 = z_min_spacing(z)
    model._z_d0 = 0.5 * s0 if s0 > 0 else 1e-3
    model._z_rep_weight = (
        float(z_penalty) if z_penalty is not None else float(n_data)
    )


def z_guard(model):
    """The barrier term to subtract from an evidence objective (0 when z is
    frozen: no penalty is computed at all)."""
    if not model._train_z:
        return 0.0
    from ..gp.gp import z_repulsion

    return z_repulsion(model.gp.z, model._z_d0, model._z_rep_weight)
