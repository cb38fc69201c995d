"""henbun_tpu_torch on the card: each CUDA kernel against its plain
version, the launch counters, the wrappers' refusals, the batched
Functions' values and gradients on the card against the CPU, a Laplace
evidence fleet with the kernels against one without them, the blocked
algorithms against torch.linalg, the exact-gram GPRMarginal evidence
on the card against the CPU, each sampler on a Gaussian, the vmapped
SparseGPC log_prob of 8 chains with the kernels against one without them,
the SparseGPMulticlass evidence on the card against the CPU and its
gradient against float64, the samplers' evaluation captured as a CUDA
graph where the target never reads the host and eager where it does, the
heteroscedastic fleet and the multi-output natural gradient on K1 and K2,
streaming into a model on the card, K1 and K2 through their custom ops,
a served multi-output predictor, a sharded fleet and the row-sharded
multiclass evidence over a one-rank NCCL mesh, the port's dry run (``entry.dryrun_multichip``) on one NCCL rank,
the JAX package's accuracy gates
of the heteroscedastic, multi-output, deep GP, GP-LVM and Expert GPR
families at its tests' step counts and limits, and the gaussian_process
example twin at its default 20,000 steps against the JAX example's
reading (the notebook's accuracy bar).

Every test carries the ``cuda`` marker and skips where torch finds no
CUDA device; the decision is made inside each test. This file imports
neither JAX nor the JAX package, so on a machine without them it runs
alone:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

import henbun_tpu_torch as thb
from henbun_tpu_torch.ops import blocked, cuda_chol, cuda_newton, cuda_solve, cuda_wide
from henbun_tpu_torch.ops import linalg as tlinalg

pytestmark = pytest.mark.cuda


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _spd(B, n, seed):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(B, n, n)))
    return ((Q * np.logspace(-2, 0, n)) @ np.swapaxes(Q, -1, -2)).astype(np.float32)


def _lower(B, n, seed):
    rng = np.random.default_rng(seed)
    L = np.tril(rng.normal(size=(B, n, n)) * (0.5 / np.sqrt(n)))
    L[:, np.arange(n), np.arange(n)] = rng.uniform(1.0, 2.0, size=(B, n))
    L[:, np.triu_indices(n, 1)[0], np.triu_indices(n, 1)[1]] = np.nan
    return L.astype(np.float32)


@pytest.mark.parametrize("B,n", [(16, 40), (16, 60), (5, 128), (2, 1)] + [
    (B, n) for n in (31, 32, 33, 64, 65, 127, 128) for B in (1, 3, 256)])
def test_cholesky_kernel_matches_plain(B, n):
    """The fleets' sizes and the 32-column panel edges (n = 31-33, 64, 65,
    127, 128); in a batch, matrix B // 2 is negated and must come out all
    NaN. atol 1e-5 on O(1) factors: the kernel applies each panel's updates
    in the plain version's order, FMA against mul + sub."""
    dev = _card()
    A = torch.tensor(_spd(B, n, seed=n), device=dev)
    if B > 1:
        A[B // 2] = -A[B // 2]
    before = cuda_chol.cholesky128_vbatched.launches
    L = cuda_chol.cholesky128_vbatched(A)
    assert cuda_chol.cholesky128_vbatched.launches == before + 1
    torch.testing.assert_close(L, cuda_chol.cholesky128_plain(A), rtol=1e-5, atol=1e-5,
                               equal_nan=True)
    ok = torch.isfinite(L).flatten(1).all(1)
    assert int(ok.sum()) == B - (B > 1)
    if B > 1:
        assert torch.isnan(L[B // 2]).all()
    assert (torch.triu(L[ok], 1) == 0).all()


def _late_pivot(B, n, bad, k, seed):
    """_spd's batch with matrix `bad` indefinite at pivot k (its [k, k]
    entry lowered by twice its pivot's square: one negative eigenvalue,
    pivots 0..k-1 unchanged); NaN in every unread upper triangle."""
    A = _spd(B, n, seed).astype(np.float64)
    A[bad, k, k] -= 2.0 * np.linalg.cholesky(A[bad])[k, k] ** 2
    A[:, np.triu_indices(n, 1)[0], np.triu_indices(n, 1)[1]] = np.nan
    return A.astype(np.float32)


@pytest.mark.parametrize("entry", ["cholesky128_vbatched", "cholesky128_batched"])
@pytest.mark.parametrize("B,n,k", [(16, 128, 100), (3, 128, 127), (5, 65, 64), (4, 40, 33)])
def test_cholesky_kernel_late_pivot_failure(entry, B, n, k):
    """A pivot that fails past the first 32-column panel (k = 33 to 127)
    makes that matrix's whole factor NaN, the earlier panels' columns
    included, and no other matrix of the batch is touched (atol 1e-5
    against the plain version)."""
    dev = _card()
    bad = B // 3
    A = torch.tensor(_late_pivot(B, n, bad, k, seed=n + k), device=dev)
    L = getattr(cuda_chol, entry)(A)
    assert torch.isnan(L[bad]).all()
    keep = torch.ones(B, dtype=torch.bool, device=dev)
    keep[bad] = False
    assert torch.isfinite(L[keep]).all()
    torch.testing.assert_close(L, cuda_chol.cholesky128_plain(A), rtol=1e-5, atol=1e-5,
                               equal_nan=True)


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("B,n,m", [(16, 40, 40), (16, 40, 1), (16, 60, 60), (16, 60, 1),
                                   (3, 128, 128)] + [
    (4, n, m) for n in (32, 33, 65, 128) for m in (1, 33, 128)])
def test_solve_kernel_matches_plain(B, n, m, transpose):
    """NaN in the unread triangle; atol 1e-5 on O(1) solutions."""
    dev = _card()
    L = torch.tensor(_lower(B, n, seed=n + m), device=dev)
    R = torch.tensor(np.random.default_rng(m).normal(size=(B, n, m)).astype(np.float32),
                     device=dev)
    before = cuda_solve.tri_solve128_vbatched.launches
    X = cuda_solve.tri_solve128_vbatched(L, R, transpose)
    assert cuda_solve.tri_solve128_vbatched.launches == before + 1
    assert torch.isfinite(X).all()
    torch.testing.assert_close(X, cuda_solve.tri_solve128_plain(L, R, transpose),
                               rtol=1e-5, atol=1e-5)


def test_wrappers_raise_on_cuda_input_they_do_not_take():
    dev = _card()
    with pytest.raises(ValueError):
        cuda_chol.cholesky128_vbatched(torch.eye(4, device=dev)[None].expand(2, 4, 4))
    with pytest.raises(TypeError):
        cuda_chol.cholesky128_vbatched(torch.eye(4, device=dev, dtype=torch.float64)[None])
    with pytest.raises(ValueError):
        cuda_solve.tri_solve128_vbatched(torch.eye(4, device=dev)[None], torch.ones(1, 4, 1))


def test_batched_functions_on_the_card_match_the_cpu():
    """safe_cholesky then tri_solve under torch.func.vmap, value and
    gradient, on the card (kernels) against the CPU (plain versions):
    rtol 1e-4, atol 1e-4 of the largest entry."""
    dev = _card()
    A = _spd(6, 40, seed=3)
    R = np.random.default_rng(4).normal(size=(6, 40, 3)).astype(np.float32)

    def run(device):
        At = torch.tensor(A, device=device, requires_grad=True)
        Rt = torch.tensor(R, device=device, requires_grad=True)
        X = torch.func.vmap(lambda a, r: tlinalg.tri_solve(tlinalg.safe_cholesky(a), r))(At, Rt)
        torch.sum(X ** 2).backward()
        return [t.detach().cpu().numpy() for t in (X, At.grad, Rt.grad)]

    c1, s1 = cuda_chol.cholesky128_vbatched.launches, cuda_solve.tri_solve128_vbatched.launches
    on_card = run(dev)
    assert cuda_chol.cholesky128_vbatched.launches == c1 + 1
    assert cuda_solve.tri_solve128_vbatched.launches == s1 + 4  # forward, its grad, 2 in chol's grad
    for got, want in zip(on_card, run("cpu")):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def _newton_batch(tag, B, n, m, seed, cycle=None):
    """K3 inputs; model b is scaled by 1 + 0.2 b, or by 1 + 0.2 (b % cycle)
    (and its Student-t scale taken at b % cycle) for large batches."""
    rng = np.random.default_rng(seed)
    if n == m:
        Lk, y = [], []
        for b in range(B):
            X = np.sort(rng.uniform(0, 6, (n, 1)))
            K = np.exp(-0.5 * (X - X.T) ** 2 / 0.7**2) + 1e-4 * np.eye(n)
            Lk.append(np.linalg.cholesky(K) * (1.0 + 0.2 * (b if cycle is None else b % cycle)))
            yy = np.sin(X) + 0.1 * rng.standard_normal((n, 1))
            yy[::7] += 2.0
            y.append(yy)
        Lk, y = np.stack(Lk), np.stack(y)
    else:
        Lk = rng.standard_normal((B, n, m)) * 0.4
        y = rng.standard_normal((B, n, 1))
    if tag == "bernoulli_logit":
        y = (y > 0).astype(np.float64)
    var = 0.15 + 0.05 * (np.arange(B) if cycle is None else np.arange(B) % cycle)[:, None]
    return [a.astype(np.float32) for a in (Lk, y, var)]


@pytest.mark.parametrize("tag,B,n,m", [
    ("student_t", 4, 128, 128), ("bernoulli_logit", 4, 128, 128),
    ("student_t", 16, 40, 40), ("bernoulli_logit", 16, 60, 60), ("bernoulli_logit", 4, 96, 24),
])
def test_newton_kernel_matches_plain(tag, B, n, m):
    """K3's mode against its plain version: atol 1e-4 (Student-t) and
    1e-3 (Bernoulli), the tolerances of test_fused_newton.py."""
    dev = _card()
    Lk, y, var = (torch.tensor(a, device=dev) for a in _newton_batch(tag, B, n, m, seed=n + m))
    before = cuda_newton.newton_mode_vbatched.launches
    v = cuda_newton.newton_mode_vbatched(Lk, y, var, tag, df=3.0)
    assert cuda_newton.newton_mode_vbatched.launches == before + 1
    assert v.shape == (B, m, 1) and torch.isfinite(v).all()
    tol = 1e-4 if tag == "student_t" else 1e-3
    torch.testing.assert_close(v, cuda_newton.newton_mode_plain(Lk, y, var, tag, df=3.0),
                               rtol=0, atol=tol)


def test_newton_kernel_isolates_a_nan_model():
    dev = _card()
    Lk, y, var = (torch.tensor(a, device=dev) for a in _newton_batch("student_t", 6, 40, 40, 1))
    clean = cuda_newton.newton_mode_vbatched(Lk, y, var, "student_t", df=3.0)
    y[2, 5] = float("nan")
    v = cuda_newton.newton_mode_vbatched(Lk, y, var, "student_t", df=3.0)
    assert (v[2] == 0).all()
    keep = [0, 1, 3, 4, 5]
    assert torch.equal(v[keep], clean[keep])


def _psi(Lk, y, var, v, tag):
    """psi(v) = sum ll(y, Lk v) - |v|^2 / 2 of each model, in float64."""
    Lk, y, var, v = (t.double() for t in (Lk, y, var, v))
    ll = cuda_newton.lik_terms(tag, 3.0, y, Lk @ v, var.reshape(-1, 1, 1))[0]
    return ll.sum((1, 2)) - 0.5 * (v * v).sum((1, 2))


@pytest.mark.parametrize("tag", ["student_t", "bernoulli_logit"])
@pytest.mark.parametrize("B,n,m", [(3, k, k) for k in (31, 32, 33, 64, 65, 127, 128)]
                         + [(4, 96, 24), (4, 24, 96), (1, 40, 40), (133, 40, 40)])
def test_newton_kernel_panel_edges_and_batches(tag, B, n, m):
    """K3 where the factor's bordered system (m + 1 rows, padded to 4)
    ends at and around a 32-column panel edge, rectangular Lk both ways, a
    single model and more models than SMs. All but a tenth of the models
    (at most one) are within the tolerance of
    test_newton_kernel_matches_plain (1e-4 Student-t, 1e-3 Bernoulli) of
    the plain version's mode, and every mode is as good an optimum: psi at
    the kernel's mode at least psi at the plain version's less 1e-5
    (1 + |psi|), the ladder's tie tolerance. Student-t modes are not
    determined to 1e-4 by float32 everywhere: where the ladder meets a
    near-tie, rounding in another order takes another step (the plain
    version against float64 misses 1e-4 on some models of these batches,
    and the parent kernel missed it too)."""
    dev = _card()
    Lk, y, var = (torch.tensor(a, device=dev)
                  for a in _newton_batch(tag, B, n, m, seed=n + 2 * m, cycle=16))
    v = cuda_newton.newton_mode_vbatched(Lk, y, var, tag, df=3.0)
    assert v.shape == (B, m, 1) and torch.isfinite(v).all()
    tol = 1e-4 if tag == "student_t" else 1e-3
    want = cuda_newton.newton_mode_plain(Lk, y, var, tag, df=3.0)
    missed = (v - want).abs().amax((1, 2)) > tol
    assert int(missed.sum()) <= max(1, B // 10)
    psi_k, psi_p = _psi(Lk, y, var, v, tag), _psi(Lk, y, var, want, tag)
    assert (psi_k >= psi_p - 1e-5 * (1 + psi_p.abs())).all()


def test_newton_kernel_isolates_a_nan_model_at_128():
    """At n = m = 128 (four full panels and the border's narrow one) a NaN
    target keeps its model at v = 0 and leaves the other modes bit-equal."""
    dev = _card()
    Lk, y, var = (torch.tensor(a, device=dev)
                  for a in _newton_batch("student_t", 6, 128, 128, 3))
    clean = cuda_newton.newton_mode_vbatched(Lk, y, var, "student_t", df=3.0)
    y[4, 100] = float("nan")
    v = cuda_newton.newton_mode_vbatched(Lk, y, var, "student_t", df=3.0)
    assert (v[4] == 0).all()
    keep = [0, 1, 2, 3, 5]
    assert torch.equal(v[keep], clean[keep])


def test_laplace_fleet_kernels_on_matches_off():
    """20 steps of a 4-model Laplace evidence fleet (robust GPR, n = 40)
    with the kernels and with use_kernels off: evidence within 1e-4 of its
    scale; K3 launches once a step, and nothing launches with them off."""
    _card()

    def fleet():
        thb.set_seed(0)
        ms = []
        for i in range(4):
            rng = np.random.default_rng(i)
            X = np.sort(rng.uniform(0, 6, 40)).astype(np.float32)[:, None]
            Y = (np.sin(X) + 0.3 * rng.normal(size=X.shape)).astype(np.float32)
            Y[rng.choice(40, 4, replace=False)] += 3.0
            ms.append(thb.models.GPR(seed=i, X=X, Y=Y))
        return thb.BatchedOptimizer(ms, "log_marginal_laplace_student").compile(learning_rate=0.02)

    hist = {}
    for use_kernels in (True, False):
        cfg = thb.settings.get_settings()
        cfg.cuda.use_kernels = use_kernels
        cfg.cuda.scan_chunk = 20
        bo = fleet()
        counts = (cuda_newton.newton_mode_vbatched.launches, cuda_chol.cholesky128_vbatched.launches,
                  cuda_solve.tri_solve128_vbatched.launches)
        with thb.settings.temp_settings(cfg):
            bo.optimize(maxiter=20)
        after = (cuda_newton.newton_mode_vbatched.launches, cuda_chol.cholesky128_vbatched.launches,
                 cuda_solve.tri_solve128_vbatched.launches)
        if use_kernels:
            assert after[0] - counts[0] >= 20 and after[1] > counts[1] and after[2] > counts[2]
        else:
            assert after == counts
        hist[use_kernels] = bo.history[-1]
    assert np.isfinite(hist[True]).all()
    assert np.abs(hist[True] - hist[False]).max() <= 1e-4 * np.abs(hist[False]).max()


@pytest.mark.parametrize("n", [40, 128])
def test_cholesky128_single_matches_plain(n):
    """K4 through its own entry and counter; NaN in the unread upper
    triangle; a negated matrix gives an all-NaN factor. atol 1e-5."""
    dev = _card()
    A = torch.tensor(_spd(1, n, seed=n)[0], device=dev)
    iu = torch.triu_indices(n, n, 1, device=dev)
    A[iu[0], iu[1]] = float("nan")
    before = (cuda_chol.cholesky128.launches, cuda_chol.cholesky128_vbatched.launches)
    L = cuda_chol.cholesky128(A)
    assert (cuda_chol.cholesky128.launches, cuda_chol.cholesky128_vbatched.launches) == (
        before[0] + 1, before[1])
    assert L.shape == (n, n) and torch.isfinite(L).all()
    torch.testing.assert_close(L, cuda_chol.cholesky128_plain(A[None])[0], rtol=1e-5, atol=1e-5)
    assert torch.isnan(cuda_chol.cholesky128(-torch.tril(A))).all()


@pytest.mark.parametrize("B,n", [(16, 40), (256, 128)])
def test_cholesky128_batched_matches_plain_and_isolates_nan(B, n):
    """K5 (B = 256 is past the TPU kernel's VMEM batch cap): one negated
    matrix, NaN in every unread upper triangle; the negated factor is all
    NaN and the others match the plain version, atol 1e-5."""
    dev = _card()
    A = torch.tensor(_spd(B, n, seed=B + n), device=dev)
    A[B // 3] = -A[B // 3]
    iu = torch.triu_indices(n, n, 1, device=dev)
    A[:, iu[0], iu[1]] = float("nan")
    before = cuda_chol.cholesky128_batched.launches
    L = cuda_chol.cholesky128_batched(A)
    assert cuda_chol.cholesky128_batched.launches == before + 1
    assert torch.isnan(L[B // 3]).all()
    keep = torch.ones(B, dtype=torch.bool, device=dev)
    keep[B // 3] = False
    assert torch.isfinite(L[keep]).all()
    torch.testing.assert_close(L, cuda_chol.cholesky128_plain(A), rtol=1e-5, atol=1e-5,
                               equal_nan=True)


@pytest.mark.parametrize("m", [128, 256, 1024, 3712, 3840, 3968, 7552, 7680, 8192])
@pytest.mark.parametrize("upper", [False, True])
def test_wide_solve_kernel_matches_plain(m, upper):
    """K6 in both modes at every tile width it selects (cuda_wide.tile_cols:
    16 up to m = 3712, 32 from 3840 to 7552, 64 from 7680) and at the edges
    between them; NaN in the triangle it must not read never reaches X.
    atol 1e-5 on O(1) solutions."""
    dev = _card()
    L = _lower(1, 128, seed=m)[0]  # NaN above the diagonal
    T = torch.tensor(np.ascontiguousarray(L.T) if upper else L, device=dev)
    Bm = torch.tensor(np.random.default_rng(m).normal(size=(128, m)).astype(np.float32),
                      device=dev)
    entry = cuda_wide.wide_usolve128 if upper else cuda_wide.wide_lsolve128
    before = entry.launches
    X = entry(T, Bm)
    assert entry.launches == before + 1
    assert torch.isfinite(X).all()
    torch.testing.assert_close(X, cuda_wide.wide_solve128_plain(T, Bm, upper),
                               rtol=1e-5, atol=1e-5)


def test_wide_solve_refuses_what_it_does_not_take():
    dev = _card()
    with pytest.raises(ValueError):
        cuda_wide.wide_lsolve128(torch.eye(128, device=dev), torch.ones(128, 100, device=dev))
    with pytest.raises(ValueError):
        cuda_wide.wide_usolve128(torch.eye(128, device=dev), torch.ones(128, 128))


def test_blocked_matches_torch_linalg():
    """n = 512: blocked_cholesky against cholesky_ex, blocked_tri_solve
    (both transposes, 512 columns) against solve_triangular; max error
    within 1e-5 of the reference's largest entry. The panels run K2."""
    dev = _card()
    n = 512
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    G = torch.randn(n, n, generator=g, device=dev)
    A = G @ G.T / n + 2.0 * torch.eye(n, device=dev)
    before = cuda_solve.tri_solve128_vbatched.launches
    L = blocked.blocked_cholesky(A)
    assert cuda_solve.tri_solve128_vbatched.launches == before + 3
    Lx = torch.linalg.cholesky_ex(A)[0]
    assert (L - Lx).abs().max() <= 1e-5 * Lx.abs().max()
    R = torch.randn(n, n, generator=g, device=dev)
    for transpose in (False, True):
        X = blocked.blocked_tri_solve(Lx, R, transpose)
        Xx = torch.linalg.solve_triangular(Lx.mT if transpose else Lx, R, upper=transpose)
        assert (X - Xx).abs().max() <= 1e-5 * Xx.abs().max()


def test_gpr_marginal_on_the_card_matches_the_cpu():
    """n = 512: the exact evidence and its gradients on the card against
    the CPU under the same weights; rtol 1e-4 of the evidence, and of each
    gradient leaf's largest entry."""
    dev = _card()
    rng = np.random.default_rng(0)
    X = np.sort(rng.uniform(0, 6, 512)).astype(np.float32)[:, None]
    Y = (np.sin(X) + 0.3 * rng.standard_normal(X.shape)).astype(np.float32)

    def value_and_grad(device):
        thb.set_seed(0)
        opt = thb.models.GPRMarginal(seed=0, X=X, Y=Y, device=device).log_marginal().compile()
        val, _ = opt._evaluate_core_aux(opt._trainable, opt._frozen, opt._data_args(),
                                        opt.model.generator, None)
        val.backward()
        return val.item(), {k: t.grad.cpu().numpy() for k, t in opt._trainable.items()}

    v_card, g_card = value_and_grad(dev)
    v_cpu, g_cpu = value_and_grad("cpu")
    assert np.isfinite(v_card)
    assert abs(v_card - v_cpu) <= 1e-4 * abs(v_cpu)
    for k, want in g_cpu.items():
        np.testing.assert_allclose(g_card[k], want, rtol=1e-4, atol=1e-4 * np.abs(want).max(),
                                   err_msg=k)


@pytest.mark.parametrize("B,n", [(1, 128), (3, 128), (48, 40)])
def test_kernels_at_the_natural_gradients_shapes(B, n):
    """K1 and K2 at the shapes the natural gradient gives them (SVGP q(u)
    at m = 128: B = 1, and 3 with the stacked retry ladder; the 16-model
    natgrad fleet at n = 40: B = 48), K2 as L X = I: against the plain
    versions, atol 1e-5 on O(1) factors."""
    dev = _card()
    A = torch.tensor(_spd(B, n, seed=B + n), device=dev)
    before = cuda_chol.cholesky128_vbatched.launches
    L = cuda_chol.cholesky128_vbatched(A)
    assert cuda_chol.cholesky128_vbatched.launches == before + 1
    torch.testing.assert_close(L, cuda_chol.cholesky128_plain(A), rtol=1e-5, atol=1e-5)
    Lf = torch.tensor(_lower(B, n, seed=B * n), device=dev)
    eye = torch.eye(n, device=dev).expand(B, n, n).contiguous()
    X = cuda_solve.tri_solve128_vbatched(Lf, eye, False)
    torch.testing.assert_close(X, cuda_solve.tri_solve128_plain(Lf, eye, False), rtol=1e-5,
                               atol=1e-5)


def test_natgrad_fleet_step_kernels_on_matches_off():
    """One natural-gradient step of a 4-model GPR fleet (analytic KL,
    ELBO_student_quadrature, gamma 0.2): the stacked ladder factors
    [12, 40, 40] in one K1 launch and inverts it in one K2 launch. The
    natural step solves with Sigma^-1, so float32 rounding moves q_mu by
    about 1e-4 of itself on any float32 path; both the kernels' step and
    the one with use_kernels off are held to a float64 step from the same
    weights, each leaf's kernel error at most 3x the library's plus 1e-5
    of the leaf's largest entry."""
    dev = _card()
    from henbun_tpu_torch import optimizers

    def fleet():
        thb.set_seed(0)
        ms = []
        for i in range(4):
            rng = np.random.default_rng(i)
            X = np.sort(rng.uniform(0, 6, 40)).astype(np.float32)[:, None]
            Y = (np.sin(X) + 0.3 * rng.normal(size=X.shape)).astype(np.float32)
            ms.append(thb.models.GPR(seed=i, X=X, Y=Y, analytic_kl=True, device=dev))
        return thb.BatchedOptimizer(ms, "ELBO_student_quadrature").compile(
            optimizers.natural_gradient(ms[0], gamma=0.2, rest=thb.adam(0.02)))

    out = {}
    for run, use_kernels, dtype in (("on", True, torch.float32), ("off", False, torch.float32),
                                    ("f64", False, torch.float64)):
        cfg = thb.settings.get_settings()
        cfg.cuda.use_kernels = use_kernels
        cfg.dtypes.float_type = dtype
        with thb.settings.temp_settings(cfg):
            bo = fleet()
            counts = (cuda_chol.cholesky128_vbatched.launches,
                      cuda_solve.tri_solve128_vbatched.launches)
            bo.optimize(maxiter=1)
            after = (cuda_chol.cholesky128_vbatched.launches,
                     cuda_solve.tri_solve128_vbatched.launches)
        # the objective: K1 once, K2 twice (its backward); the natural
        # gradient: K1 twice, K2 twice
        assert after == ((counts[0] + 3, counts[1] + 4) if use_kernels else counts)
        out[run] = {k: v.detach().cpu().double().numpy() for k, v in bo._trainable.items()}
    for k, want in out["f64"].items():
        scale = max(np.abs(want).max(), 1e-6)
        err_on = np.abs(out["on"][k] - want).max() / scale
        err_off = np.abs(out["off"][k] - want).max() / scale
        assert err_on <= 3 * err_off + 1e-5, (k, err_on, err_off)


def _gauss(dev):
    cov = np.array([[1.0, 0.7], [0.7, 2.0]])
    prec = torch.tensor(np.linalg.inv(cov), dtype=torch.float32, device=dev)
    return (lambda t: -0.5 * t @ prec @ t), cov


@pytest.mark.parametrize("name", ["hmc", "chees", "nuts"])
def test_sampler_on_a_gaussian_on_the_card(name):
    """The JAX tests' gates (test_hmc.py, test_chees.py, test_nuts_smc.py)
    on the card: means within 0.15 (ChEES 0.12), covariances within 0.35
    (ChEES 0.3), accept rates in their ranges; the chains stay on the
    card."""
    from henbun_tpu_torch.inference import chees, hmc, nuts

    dev = _card()
    mod = {"hmc": hmc, "chees": chees, "nuts": nuts}[name]
    lp, cov = _gauss(dev)
    g = torch.Generator(device=dev).manual_seed(0)
    chains = 16 if name == "chees" else 8
    init = torch.randn((chains, 2), generator=g, device=dev)
    res = mod.sample(lp, init, g, num_samples=500, num_warmup=500 if name == "chees" else 300)
    assert res.samples.device.type == "cuda"
    x = res.samples.reshape(-1, 2).cpu().numpy()
    mean_tol, cov_tol = (0.12, 0.3) if name == "chees" else (0.15, 0.35)
    assert np.allclose(x.mean(0), 0.0, atol=mean_tol), x.mean(0)
    assert np.allclose(np.cov(x.T), cov, atol=cov_tol), np.cov(x.T)
    acc = float(res.accept_prob.mean())
    assert (0.5 < acc < 0.95) if name == "chees" else acc > (0.6 if name == "nuts" else 0.5)


def test_smc_on_the_card_reaches_the_posterior():
    """test_nuts_smc.py's conjugate model on the card: posterior moments
    and log-evidence against the analytic values."""
    from henbun_tpu_torch.inference import smc

    dev = _card()
    rng = np.random.default_rng(0)
    y = rng.normal(1.5, 1.0, size=20).astype(np.float32)
    marg = np.ones((20, 20)) + np.eye(20)
    log_Z = (-10 * np.log(2 * np.pi) - 0.5 * np.linalg.slogdet(marg)[1]
             - 0.5 * y @ np.linalg.solve(marg, y))
    yt = torch.tensor(y, device=dev)
    c = float(0.5 * np.log(2 * np.pi))
    res = smc.sample(lambda t: -0.5 * torch.sum(t**2) - c,
                     lambda t: torch.sum(-0.5 * (yt - t[0]) ** 2 - c),
                     torch.randn((2048, 1), generator=torch.Generator(device=dev).manual_seed(0),
                                 device=dev), 1, num_move_steps=3, step_size=0.2)
    x = res.particles[:, 0].cpu().numpy()
    assert abs(x.mean() - y.sum() / 21) < 0.1 and abs(x.var() - 1 / 21) < 0.05
    assert abs(float(res.log_evidence) - log_Z) < 1.5 and float(res.final_beta) > 0.999


def _sparse_gpc(device, n=2000, m=32):
    rng = np.random.default_rng(0)
    X = np.sort(rng.uniform(0, 6, (n, 1))).astype(np.float32)
    p_true = 1.0 / (1.0 + np.exp(-3.0 * np.sin(X)))
    Y = (rng.uniform(size=X.shape) < p_true).astype(np.float32)
    return thb.models.SparseGPC(seed=1, X=X, Y=Y, num_inducing=m, device=device)


def test_bayes_log_prob_of_8_chains_kernels_on_matches_off():
    """The vmapped SparseGPC log_posterior of 8 chains and its gradient:
    with the kernels (K1 for every Newton factor and the Kmm factor, K2 for
    the IFT's solves, counted) against use_kernels off and against the
    CPU, 1e-4 of the scale."""
    from henbun_tpu_torch.inference import logprob

    dev = _card()
    model = _sparse_gpc(dev)
    flp = logprob.make_log_prob(model, "log_posterior", thb.graph_key.VARIABLES)
    g = torch.Generator(device=dev).manual_seed(1)
    theta = flp.initial + 0.1 * torch.randn((8, flp.dim), generator=g, device=dev)
    vg = logprob.batched_value_and_grad(flp.log_prob)
    k1, k2 = cuda_chol.cholesky128_vbatched.launches, cuda_solve.tri_solve128_vbatched.launches
    v_on, g_on = vg(theta)
    assert vg.graphed is False  # safe_cholesky's retry flag reads the host: use_kernels applies
    assert cuda_chol.cholesky128_vbatched.launches > k1
    assert cuda_solve.tri_solve128_vbatched.launches > k2
    cfg = thb.settings.get_settings()
    cfg.cuda.use_kernels = False
    with thb.settings.temp_settings(cfg):
        v_off, g_off = vg(theta)
    cpu_model = _sparse_gpc("cpu")
    cpu_model.set_param_dict({k: v.cpu() for k, v in model.param_dict().items()})
    flp_cpu = logprob.make_log_prob(cpu_model, "log_posterior", thb.graph_key.VARIABLES)
    v_cpu, g_cpu = logprob.batched_value_and_grad(flp_cpu.log_prob)(theta.cpu())
    for v, gr in ((v_off, g_off), (v_cpu.to(dev), g_cpu.to(dev))):
        torch.testing.assert_close(v_on, v, rtol=0, atol=1e-4 * float(v.abs().max()))
        for d in range(flp.dim):
            torch.testing.assert_close(g_on[:, d], gr[:, d], rtol=0,
                                       atol=1e-4 * float(gr[:, d].abs().max()))


# the card's float32 gradient against its float64 one at n = 2e4, m = 32,
# each leaf's limit 3.5-3.9x its reading on an H100 80GB HBM3, 700 W (the
# CPU's float32 reading in brackets): lengthscale 4.23e-5 (2.35e-3), k_var
# 1.29e-5 (9.36e-6)
MULTICLASS_F64_LIMITS = {"gp.kern.lengthscales": 1.5e-4, "k_var": 5e-5}


def _three_class_rows(n):
    """n sorted U[0, 6] inputs, labels drawn from the softmax of
    2.5 sin(x + s), s = 0, 2.1, 4.2."""
    rng = np.random.default_rng(0)
    X = np.sort(rng.uniform(0, 6, (n, 1))).astype(np.float32)
    L = 2.5 * np.concatenate([np.sin(X + s) for s in (0.0, 2.1, 4.2)], axis=1)
    P = np.exp(L - L.max(1, keepdims=True))
    P /= P.sum(1, keepdims=True)
    y = (P.cumsum(1) < rng.uniform(size=(n, 1))).sum(1).astype(np.int32)[:, None]
    return X, y


def test_sparse_gp_multiclass_evidence_card_matches_cpu():
    """SparseGPMulticlass at n = 2e4, m = 32, K = 3: the evidence on the card
    against the CPU at the same weights (rtol 1e-4), and every gradient leaf
    of the card held to the card's float64 evaluation at its limit
    (MULTICLASS_F64_LIMITS), whether or not it is within 1e-4 of the CPU's."""
    dev = _card()
    X, y = _three_class_rows(20000)

    def evaluate(device):
        thb.set_seed(0)
        m = thb.models.SparseGPMulticlass(seed=0, X=X, Y=y, num_classes=3, num_inducing=32,
                                          device=device)
        opt = m.log_marginal_laplace().compile(learning_rate=0.05)
        val, _ = opt._evaluate_core_aux(opt._trainable, opt._frozen, opt._data_args(),
                                        m.generator, None)
        val.backward()
        return val.item(), {k: t.grad.cpu().double() for k, t in opt._trainable.items()}

    (v_card, g_card), (v_cpu, g_cpu) = evaluate(dev), evaluate("cpu")
    cfg = thb.settings.get_settings()
    cfg.dtypes.float_type = torch.float64
    with thb.settings.temp_settings(cfg):
        g64 = evaluate(dev)[1]
    rel = {k: [float((g[k] - g64[k]).abs().max() / g64[k].abs().max()) for g in (g_card, g_cpu)]
           for k in g64}
    print("float32 gradient from the card's float64 (card, CPU): %r" % rel)
    assert abs(v_card - v_cpu) <= 1e-4 * abs(v_cpu)
    assert set(rel) == set(MULTICLASS_F64_LIMITS)
    for k, (card, _) in rel.items():
        assert card <= MULTICLASS_F64_LIMITS[k], (k, rel[k])


def test_graphed_log_prob_equals_the_eager_one():
    """The BNN's batched log_prob and gradient of 256 chains never
    synchronize the host, so the evaluation is captured as a CUDA graph and
    replayed: equal to the eager evaluation at the capture's theta and at a
    new one."""
    from henbun_tpu_torch.inference import logprob

    dev = _card()
    X, Y = thb.models.make_bnn_dataset(n=128)
    model = thb.models.BNN(seed=0, X=X, Y=Y, hidden=16, device=dev)
    flp = logprob.make_log_prob(model, "log_posterior")
    graphed = logprob.batched_value_and_grad(flp.log_prob)
    g = torch.Generator(device=dev).manual_seed(0)
    for _ in range(2):
        theta = flp.initial + 0.1 * torch.randn((256, flp.dim), generator=g, device=dev)
        replays = logprob.CudaGraphed.replays
        got = graphed(theta)
        assert graphed.graphed is True
        assert logprob.CudaGraphed.replays == replays + 1
        for a, b in zip(got, graphed.fn(theta)):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_a_target_that_reads_the_host_runs_eagerly():
    """A log density that copies a host constant to the card (a
    synchronizing copy) cannot be captured: the first evaluation finds the
    synchronization, and every evaluation runs eagerly with no replay."""
    from henbun_tpu_torch.inference import logprob

    dev = _card()

    def log_prob(t):
        return -0.5 * torch.sum(t**2) * torch.tensor(2.0, device=t.device)

    vg = logprob.batched_value_and_grad(log_prob)
    theta = torch.randn((8, 3), generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    replays = logprob.CudaGraphed.replays
    for scale in (1.0, 2.0):
        lp, grad = vg(scale * theta)
        torch.testing.assert_close(lp, -torch.sum((scale * theta) ** 2, -1))
        torch.testing.assert_close(grad, -2.0 * scale * theta)
    assert vg.graphed is False
    assert logprob.CudaGraphed.replays == replays


# ------------------------------------------ the remaining families, streaming
def _hetero_fleet(dev, M=4):
    thb.set_seed(0)
    models = []
    for i in range(M):
        X, Y, _ = thb.models.make_hetero_dataset(n=120, seed=i)
        models.append(thb.models.HeteroscedasticGPR(seed=i, X=X, Y=Y, device=dev))
    return thb.BatchedOptimizer(models, "ELBO_analytic").compile(thb.adam(0.02))


def test_hetero_fleet_kernels_on_matches_off():
    """4 HeteroscedasticGPRs (n = 120) under BatchedOptimizer: each step
    factors the two [4, 120, 120] grams on K1 and solves the two Murray
    backwards' L^T systems on K2 (2 and 4 launches a step); 20 steps with
    the kernels against 20 with use_kernels off, within 1e-4 of the
    objective's scale."""
    dev = _card()
    hist = {}
    for use_kernels in (True, False):
        cfg = thb.settings.get_settings()
        cfg.cuda.use_kernels = use_kernels
        with thb.settings.temp_settings(cfg):
            bo = _hetero_fleet(dev)
            before = (cuda_chol.cholesky128_vbatched.launches,
                      cuda_solve.tri_solve128_vbatched.launches)
            bo.optimize(maxiter=20)
            after = (cuda_chol.cholesky128_vbatched.launches,
                     cuda_solve.tri_solve128_vbatched.launches)
        assert after == ((before[0] + 40, before[1] + 80) if use_kernels else before)
        hist[use_kernels] = np.concatenate(bo.history).astype(np.float64)
    assert np.isfinite(hist[True]).all()
    rel = np.abs(hist[True] - hist[False]).max() / np.abs(hist[False]).max()
    assert rel <= 1e-4, rel


def test_multioutput_natgrad_launches_k1_and_k2():
    """MultiOutputGPR (n = 80, Q = 2) under natural_gradient(0.3): the
    layered node's two pairs and the ladder stack to [6, 80, 80], factored
    twice on K1 and inverted twice on K2 each step; the shared kernel's
    own [80, 80] factor goes to torch.linalg."""
    dev = _card()
    thb.set_seed(0)
    X, Y, _ = thb.models.make_multioutput_dataset(n=80, seed=0)
    m = thb.models.MultiOutputGPR(seed=0, X=X, Y=Y, Q=2, device=dev)
    opt = m.ELBO_analytic().compile(
        thb.optimizers.natural_gradient(m, gamma=0.3, rest=thb.adam(0.02)))
    before = (cuda_chol.cholesky128_vbatched.launches, cuda_solve.tri_solve128_vbatched.launches)
    opt.optimize(maxiter=5)
    after = (cuda_chol.cholesky128_vbatched.launches, cuda_solve.tri_solve128_vbatched.launches)
    assert after == (before[0] + 10, before[1] + 10)
    assert np.isfinite(np.concatenate(opt.history)).all()


class _LinReg(thb.Model):
    def setUp(self):
        self.x = thb.MinibatchData(np.zeros((8, 3), np.float32))
        self.y = thb.MinibatchData(np.zeros((8, 1), np.float32))
        self.w = thb.Variable([3, 1], stddev=0.1)

    @thb.AutoOptimize()
    def obj(self):
        return -torch.sum(torch.square(self.y - torch.matmul(self.x, self.w)))


def test_streaming_into_a_model_on_the_card(tmp_path):
    """optimize_streaming into a model on the card: at every megabatch
    after the first, the device copy of the one before still equals, bit
    for bit, what the loader handed out (the workers have refilled its
    ring buffer since: the loader returns a host copy and the device copy
    is synchronous), and the fit recovers the coefficients."""
    dev = _card()
    from henbun_tpu_torch.io import OutOfCoreLoader, optimize_streaming, write_dataset

    rng = np.random.default_rng(0)
    X = rng.normal(size=(20000, 3)).astype(np.float32)
    Y = (X @ np.array([1.0, -2.0, 0.5], np.float32))[:, None] + 0.05 * rng.normal(
        size=(20000, 1)).astype(np.float32)
    path = str(tmp_path / "rows.f32")
    n, row_floats, slices, _ = write_dataset(path, X, Y)
    m = _LinReg(seed=0, device=dev)
    opt = m.obj().compile(thb.adam(0.05))
    handed, checked = [], []

    class Recording:
        def __init__(self, inner):
            self.inner = inner

        def next(self):
            if handed:
                dev_rows = torch.cat([m.x.device_value(), m.y.device_value()], 1)
                assert dev_rows.device.type == "cuda"
                assert np.array_equal(dev_rows.cpu().numpy(), handed[-1])
                checked.append(True)
            mega = self.inner.next()
            handed.append(mega.copy())
            return mega

    cfg = thb.settings.get_settings()
    cfg.cuda.scan_chunk = 100
    with thb.settings.temp_settings(cfg), \
            OutOfCoreLoader(path, n, row_floats, batch_rows=4096, n_buffers=2, seed=4) as dl:
        optimize_streaming(opt, Recording(dl), slices, maxiter=1500, minibatch_size=64)
    assert len(handed) == 15 and len(checked) == 14
    assert np.allclose(m.w.value[:, 0], [1.0, -2.0, 0.5], atol=0.1)


# The JAX package's accuracy gates, at its tests' step counts and limits
def test_custom_ops_launch_the_kernels():
    """K1 and K2 through their torch.library ops: the CUDA implementations
    launch the kernels (counted once a call) and equal the wrappers; the
    solve's width is decided inside the op, so m = 200 goes to
    torch.linalg without a launch."""
    from henbun_tpu_torch.ops import library

    dev = _card()
    A = torch.tensor(_spd(6, 80, 3), device=dev)
    before = cuda_chol.cholesky128_vbatched.launches
    L = library.cholesky128(A)
    assert cuda_chol.cholesky128_vbatched.launches == before + 1
    assert torch.equal(L, cuda_chol.cholesky128_vbatched(A))
    R = torch.randn(6, 80, 100, device=dev)
    before = cuda_solve.tri_solve128_vbatched.launches
    X = library.tri_solve128(L, R, True)
    assert cuda_solve.tri_solve128_vbatched.launches == before + 1
    assert torch.equal(X, cuda_solve.tri_solve128_vbatched(L, R, transpose=True))
    wide = torch.randn(6, 80, 200, device=dev)
    before = cuda_solve.tri_solve128_vbatched.launches
    Xw = library.tri_solve128(L, wide, False)
    assert cuda_solve.tri_solve128_vbatched.launches == before
    want = torch.linalg.solve_triangular(L, wide, upper=False)
    assert torch.allclose(Xw, want, rtol=1e-5, atol=1e-5)


def test_served_multioutput_predictor_on_the_card():
    """MultiOutputGPR (per-latent kernels) exported for the card serves
    any size: K1 factors the frozen grams once, at the first call (the
    fold), and never again; K2 launches from the program for n* <= 128,
    the 200-point solve goes to torch.linalg, and every answer equals the
    eager predict_f (rtol 1e-5, atol 1e-6)."""
    from henbun_tpu_torch import serving

    dev = _card()
    X, Y, _ = thb.models.make_multioutput_dataset(n=80, seed=0)
    m = thb.models.MultiOutputGPR(seed=0, X=X, Y=Y, Q=2, shared_kernel=False, device=dev)
    m.ELBO_analytic().compile(thb.adam(0.02)).optimize(maxiter=20)
    art = serving.export_predictor(m, "predict_f", np.zeros((8, 1), np.float32),
                                   platforms=("cuda",), batch_polymorphic=True)
    for n in (5, 100, 200):
        x = np.linspace(-0.5, 6.5, n, dtype=np.float32)[:, None]
        k1, k2 = cuda_chol.cholesky128_vbatched.launches, cuda_solve.tri_solve128_vbatched.launches
        got = art(torch.tensor(x, device=dev))
        k1 = cuda_chol.cholesky128_vbatched.launches - k1
        k2 = cuda_solve.tri_solve128_vbatched.launches - k2
        assert (k1 > 0 if n == 5 else k1 == 0) and (k2 > 0 if n <= 128 else k2 == 0), (n, k1, k2)
        want = m.run(lambda mm: mm.predict_f(x))
        for g, w in zip(got, want):
            assert torch.allclose(g, w, rtol=1e-5, atol=1e-6)


def test_sharded_fleet_over_nccl_matches_the_batched_optimizer():
    """A one-rank NCCL mesh (make_mesh starts the group itself): the
    sharded fleet equals BatchedOptimizer under the same injected noise."""
    import torch.distributed as dist
    from henbun_tpu_torch import parallel

    dev = _card()
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    noise = [torch.randn(4, 20, generator=g, device=dev) for _ in range(5)]
    try:
        mesh = parallel.make_mesh(device_type="cuda")
        assert dist.get_backend() == "nccl"
        hists = []
        for sharded in (False, True):
            thb.set_seed(0)
            ms = []
            for i in range(4):
                Xi, Yi = thb.models.make_sine_dataset(n=20, seed=i)
                ms.append(thb.models.GPR(seed=i, X=Xi, Y=Yi, device=dev))
            bo = (parallel.ShardedBatchedOptimizer(ms, "ELBO_gaussian", mesh=mesh) if sharded
                  else thb.BatchedOptimizer(ms, "ELBO_gaussian"))
            bo.compile(learning_rate=0.01)
            bo.noise_source = lambda s: {"q": noise[s]}
            bo.optimize(maxiter=5)
            hists.append(bo.history[-1])
        np.testing.assert_allclose(hists[1], hists[0], rtol=1e-6)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_row_sharded_multiclass_over_one_nccl_rank_is_one_process():
    """SparseGPMulticlass.log_marginal_laplace (row_sharded) at n = 2e4,
    m = 32, K = 3 under ShardedOptimizer on a one-rank NCCL mesh: its one
    data rank takes every row, and the objective, the first step's
    gradients, 5 Adam steps and the weights are bit for bit the
    one-process run's."""
    import torch.distributed as dist
    from henbun_tpu_torch import parallel

    dev = _card()
    X, y = _three_class_rows(20000)
    try:
        mesh = parallel.make_mesh(device_type="cuda")
        assert dist.get_backend() == "nccl"
        runs = []
        for sharded in (False, True):
            thb.set_seed(0)
            m = thb.models.SparseGPMulticlass(seed=0, X=X, Y=y, num_classes=3, num_inducing=32,
                                              device=dev)
            opt = (parallel.ShardedOptimizer(m, "log_marginal_laplace", mesh=mesh) if sharded
                   else m.log_marginal_laplace())
            opt.compile(learning_rate=0.05)
            opt.optimize(maxiter=1)
            grads = {k: t.grad.cpu().numpy() for k, t in opt._trainable.items()}
            opt.optimize(maxiter=4)
            runs.append((np.concatenate(opt.history), grads,
                         {k: v.detach().cpu().numpy() for k, v in m.param_dict().items()}))
        (h0, g0, p0), (h1, g1, p1) = runs
        assert np.isfinite(h0).all()
        np.testing.assert_array_equal(h1, h0)
        for k in g0:
            np.testing.assert_array_equal(g1[k], g0[k], err_msg=k)
        for k in p0:
            np.testing.assert_array_equal(p1[k], p0[k], err_msg=k)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_dryrun_multichip_one_rank_over_nccl():
    """henbun_tpu_torch.entry's dry run on one NCCL rank on the card: the
    six sharded mechanisms finish finite."""
    from henbun_tpu_torch import entry

    _card()
    (out,) = entry.dryrun_multichip(1)
    assert out["backend"] == "nccl" and out["device"].startswith("cuda"), out
    assert {"svi", "fleet", "log_marginal_laplace", "log_marginal_ep", "chees",
            "smc"} <= set(out)


def test_hetero_accuracy_gate_on_the_card():
    """tests/test_hetero.py:46-63: n = 120, 3,000 Adam(0.02) steps of the
    analytic ELBO; the mean within RMSE 0.25 of sin(x), the learned noise
    profile rising (loud / quiet > 2)."""
    dev = _card()
    thb.set_seed(0)
    X, Y, sd = thb.models.make_hetero_dataset(n=120, seed=0)
    m = thb.models.HeteroscedasticGPR(seed=0, X=X, Y=Y, device=dev)
    m.ELBO_analytic().compile(thb.adam(0.02)).optimize(maxiter=3000)
    grid = np.linspace(0.2, 5.8, 40).reshape(-1, 1).astype(np.float32)
    fmean, yvar = m.run(lambda mm: mm.predict_y(grid))
    fmean = fmean.cpu().numpy()[:, 0]
    rmse = np.sqrt(np.mean((fmean - np.sin(grid[:, 0])) ** 2))
    assert rmse < 0.25, rmse
    gmean, _ = m.run(lambda mm: mm.predict_g(grid))
    learned_sd = np.exp(0.5 * gmean.cpu().numpy()[:, 0])
    quiet = learned_sd[grid[:, 0] < 2.0].mean()
    loud = learned_sd[grid[:, 0] > 4.0].mean()
    assert loud / quiet > 2.0, (quiet, loud)
    assert quiet < 0.2, quiet
    assert 0.2 < loud < 0.9, loud


W_TRUE = np.array([[1.0, 0.0], [0.8, 0.6], [-0.9, 0.4]], np.float32)


def test_multioutput_accuracy_gates_on_the_card():
    """tests/test_multioutput.py:46-69: n = 80, Q = 2, 4,000 Adam(0.02)
    steps; each output within RMSE 0.2 of the generator at new inputs,
    the implied output correlations of the generator's signs, each within
    0.35."""
    dev = _card()
    thb.set_seed(0)
    X, Y, F = thb.models.make_multioutput_dataset(n=80, seed=0)
    m = thb.models.MultiOutputGPR(seed=0, X=X, Y=Y, Q=2, device=dev)
    m.ELBO_analytic().compile(thb.adam(0.02)).optimize(maxiter=4000)
    grid = np.linspace(0.2, 5.8, 40).reshape(-1, 1).astype(np.float32)
    mean, var = m.run(lambda mm: mm.predict_y(grid))
    mean = mean.cpu().numpy()
    truth = np.concatenate([np.sin(grid), np.cos(grid)], 1) @ W_TRUE.T
    for p in range(3):
        rmse = np.sqrt(np.mean((mean[:, p] - truth[:, p]) ** 2))
        assert rmse < 0.2, (p, rmse)
    assert (var.cpu().numpy() > 0).all()
    C = m.run(lambda mm: mm.output_correlation()).cpu().numpy()
    B = W_TRUE @ W_TRUE.T
    d = np.sqrt(np.diag(B))
    C_true = B / np.outer(d, d)
    for i in range(3):
        for j in range(i):
            assert np.sign(C[i, j]) == np.sign(C_true[i, j]), (i, j, C)
            assert abs(C[i, j] - C_true[i, j]) < 0.35, (i, j, C, C_true)


def test_multioutput_natgrad_beats_adam_on_the_card():
    """tests/test_multioutput.py:100-129: n = 80, 800 steps each,
    natural_gradient(0.3, rest=Adam(0.02)) ends more than 20 nats above
    Adam(0.02)."""
    dev = _card()
    thb.set_seed(0)
    X, Y, _ = thb.models.make_multioutput_dataset(n=80, seed=0)
    m_ng = thb.models.MultiOutputGPR(seed=0, X=X, Y=Y, Q=2, device=dev)
    opt_ng = m_ng.ELBO_analytic().compile(
        thb.optimizers.natural_gradient(m_ng, gamma=0.3, rest=thb.adam(0.02)))
    opt_ng.optimize(maxiter=800)
    m_ad = thb.models.MultiOutputGPR(seed=0, X=X, Y=Y, Q=2, device=dev)
    opt_ad = m_ad.ELBO_analytic().compile(thb.adam(0.02))
    opt_ad.optimize(maxiter=800)
    ng, ad = float(opt_ng.run()), float(opt_ad.run())
    assert np.isfinite(ng) and np.isfinite(ad)
    assert ng > ad + 20.0, (ng, ad)


def test_deep_gp_accuracy_gates_on_the_card():
    """tests/test_deepgp.py's fixture and gates: n = 400, m = 32, 6,000
    Adam(0.01) steps in minibatches of 128 for the two-layer DGP and for
    an SVGP with the same budget; the DGP's 64-draw mean within RMSE 0.1
    of the step away from the jump, its plateaus within 0.06 of 0 and 1,
    and below the SVGP's RMSE."""
    dev = _card()
    grid = np.linspace(-0.9, 0.9, 61).reshape(-1, 1).astype(np.float32)
    truth = (grid > 0).astype(np.float32)[:, 0]
    away = np.abs(grid[:, 0]) > 0.1

    def rmse(pred):
        return float(np.sqrt(np.mean((pred[away] - truth[away]) ** 2)))

    thb.set_seed(0)
    X, Y = thb.models.make_step_dataset(n=400, seed=0)
    dgp = thb.models.DeepGPRegression(seed=0, X=X, Y=Y, num_inducing=32, device=dev)
    dgp.ELBO().compile(thb.adam(0.01)).optimize(maxiter=6000, minibatch_size=128)
    svgp = thb.models.SVGPRegression(seed=0, X=X, Y=Y, num_inducing=32, device=dev)
    svgp.ELBO().compile(thb.adam(0.01)).optimize(maxiter=6000, minibatch_size=128)
    dgp_mean = dgp.draws(lambda mm: mm.predict_f(grid), 64).mean(0)[:, 0].cpu().numpy()
    svgp_mean = svgp.draws(lambda mm: mm.predict_f(grid)[0], 64).mean(0).cpu().numpy()
    assert rmse(dgp_mean) < 0.1, rmse(dgp_mean)
    assert abs(dgp_mean[grid[:, 0] < -0.3].mean() - 0.0) < 0.06
    assert abs(dgp_mean[grid[:, 0] > 0.3].mean() - 1.0) < 0.06
    assert rmse(dgp_mean) < rmse(svgp_mean), (rmse(dgp_mean), rmse(svgp_mean))


def test_gplvm_accuracy_gates_on_the_card():
    """tests/test_gplvm.py:27-38: n = 1,000, 3,000 Adam(0.01) steps in
    minibatches of 128; the encoder's latent mean correlates with the
    generating coordinate beyond 0.97 in magnitude, and the 64-draw
    reconstruction is within RMSE 0.09 of the observations."""
    dev = _card()
    thb.set_seed(0)
    Y, t_true = thb.models.make_curve_dataset(n=1000, seed=0)
    m = thb.models.GPLVM(seed=0, Y=Y, d_z=1, num_inducing=16, hidden=32, device=dev)
    m.ELBO().compile(thb.adam(0.01)).optimize(maxiter=3000, minibatch_size=128)
    lat = m.run(lambda mm: mm.latent_mean(Y)).cpu().numpy()[:, 0]
    corr = abs(np.corrcoef(lat, t_true)[0, 1])
    assert corr > 0.97, corr
    rec = m.draws(lambda mm: mm.reconstruct(Y), 64).mean(0).cpu().numpy()
    rmse = np.sqrt(np.mean((rec - Y) ** 2))
    assert rmse < 0.09, rmse


def _exponential_decay_adam(init, transition, rate, end):
    """Adam whose learning rate at update t is max(init rate^(t /
    transition), end) (optax.exponential_decay with end_value, rate < 1)."""
    def make(params):
        opt = torch.optim.Adam(params, lr=init, betas=(0.9, 0.999), eps=1e-8)
        count = [0]
        step = opt.step

        def scheduled_step(*a, **k):
            for g in opt.param_groups:
                g["lr"] = max(init * rate ** (count[0] / transition), end)
            count[0] += 1
            return step(*a, **k)

        opt.step = scheduled_step
        return opt

    return make


class _FixedExpertGPR(thb.Model):
    """tests/test_accuracy_gates.py's FixedExpertGPR: the three-GP mixture
    with fixed kernels and noise; only the variational posteriors train
    (collection 'vi'), cold."""

    NOISE_VAR = 0.01

    def setUp(self, X, Y):
        from henbun_tpu_torch.ops.linalg import matmul_hp

        self._matmul = matmul_hp
        self.X = thb.Data(X)
        self.Y = thb.Data(Y)
        self.q_s = thb.variationals.Gaussian(shape=list(X.shape), q_shape="fullrank",
                                             collections=["vi"])
        self.q_l = thb.variationals.Gaussian(shape=list(X.shape), q_shape="fullrank",
                                             collections=["vi", "init_l"])
        self.q_r = thb.variationals.Normal(shape=list(X.shape), q_shape="fullrank",
                                           collections=["vi"])
        self.kern_s = thb.gp.kernels.UnitRBF(np.array([0.15], np.float32))
        self.kern_l = thb.gp.kernels.UnitRBF(np.array([1.0], np.float32))
        self.kern_r = thb.gp.kernels.UnitRBF(np.array([0.6], np.float32))
        for k in (self.kern_s, self.kern_l, self.kern_r):
            k.lengthscales.collections = "frozen_hyp"

    def gate(self):
        return torch.sigmoid(self._matmul(self.kern_r.Cholesky(self.X), self.q_r) * 4.0)

    def f_mixture(self):
        f_s = self._matmul(self.kern_s.Cholesky(self.X), self.q_s)
        f_l = self._matmul(self.kern_l.Cholesky(self.X), self.q_l)
        frac = self.gate()
        return frac * f_s + (1 - frac) * f_l

    @thb.AutoOptimize()
    def ELBO(self):
        f = self.f_mixture()
        return torch.sum(thb.densities.gaussian(self.Y, f, self.NOISE_VAR)) - self.KL()

    @thb.AutoOptimize()
    def ELBO_smooth(self):
        f_l = self._matmul(self.kern_l.Cholesky(self.X), self.q_l)
        return torch.sum(thb.densities.gaussian(self.Y, f_l, self.NOISE_VAR)) - self.KL("init_l")


def test_expert_gpr_accuracy_gate_on_the_card():
    """tests/test_accuracy_gates.py:218-288, the Expert GPR gate: n = 120,
    the smooth-only baseline 3,000 Adam(0.02) steps on collection
    'init_l'; the mixture 20,000 steps on 'vi' with the exponential-decay
    Adam and 4 ELBO samples a step. The 200-draw mean mixture within RMSE
    0.1 of the generating function, the ELBO within 90 nats of the
    noise-limited ceiling and 1,000 above the single smooth GP, and the
    posterior-mean gate separating the two regimes by more than 0.5."""
    dev = _card()
    thb.set_seed(0)
    n = 120
    rng = np.random.default_rng(0)
    X = np.linspace(-1, 1, n).reshape(-1, 1).astype(np.float32)
    true_gate = 1.0 / (1.0 + np.exp(-8 * X))
    f_true = true_gate * (np.sin(14 * X) * 0.6) + (1 - true_gate) * (0.8 * X)
    Y = (f_true + rng.normal(size=(n, 1)) * 0.1).astype(np.float32)

    m_smooth = _FixedExpertGPR(seed=1, X=X, Y=Y, device=dev)
    sm = m_smooth.ELBO_smooth().compile(thb.adam(0.02), collection="init_l")
    sm.optimize(maxiter=3000)
    elbo_single = float(np.mean([sm.run() for _ in range(20)]))

    m = _FixedExpertGPR(seed=0, X=X, Y=Y, device=dev)
    opt = m.ELBO().compile(_exponential_decay_adam(0.02, 3000, 0.5, 1e-3), collection="vi",
                           num_elbo_samples=4)
    opt.optimize(maxiter=20000)
    elbo_mix = float(np.mean([opt.run() for _ in range(20)]))

    f_mean = m.draws(lambda mm: mm.f_mixture(), 200)[:, :, 0].mean(0).cpu().numpy()
    rmse = float(np.sqrt(np.mean((f_mean - f_true[:, 0]) ** 2)))
    assert rmse < 0.1, rmse
    ceiling = float(np.sum(-0.5 * np.log(2 * np.pi * _FixedExpertGPR.NOISE_VAR)
                           - (Y - f_true) ** 2 / (2 * _FixedExpertGPR.NOISE_VAR)))
    assert elbo_mix > ceiling - 90.0, (elbo_mix, ceiling)
    assert elbo_mix > elbo_single + 1000.0, (elbo_mix, elbo_single)
    g_mean = m.draws(lambda mm: mm.gate(), 200)[:, :, 0].mean(0).cpu().numpy()
    left = float(g_mean[X[:, 0] < -0.5].mean())
    right = float(g_mean[X[:, 0] > 0.5].mean())
    assert abs(right - left) > 0.5, (left, right)


# examples/gaussian_process.py on a CPU at its defaults (20,000 Adam steps;
# JAX package): the first GPR's hyperparameters
GP_JAX_READING = {"lengthscale:": 0.89303714, "kernel var:": 0.2206784, "noise var:": 0.06612204}
# their Monte Carlo spread: the standard deviation over 16 copies of that fit,
# each drawing its own noise (python -m henbun_tpu_torch.utils.gp_spread on an
# NVIDIA H100 80GB HBM3, 700 W)
GP_MC_SD = {"lengthscale:": 0.0142294, "kernel var:": 0.00470313, "noise var:": 0.00543248}
GP_Z = 4.0


def test_gaussian_process_twin_at_its_defaults_on_the_card(capsys):
    """The notebook's accuracy bar: the gaussian_process twin at its default
    20,000 steps on the card (about 385 s). Its lengthscale, kernel variance
    and noise variance within GP_Z standard deviations of the difference
    of two runs (sqrt(2) GP_MC_SD) of the JAX example's CPU reading, and
    the posterior-mean RMSE against sin(x) under 0.3."""
    _card()
    from henbun_tpu_torch.examples import gaussian_process

    gaussian_process.main([])
    out = capsys.readouterr().out

    def reading(label):
        lines = [ln for ln in out.splitlines() if label in ln]
        assert len(lines) == 1, (label, out)
        after = lines[0].split(label, 1)[1]
        return float(after.split("]")[0].strip(" ["))

    for label, want in GP_JAX_READING.items():
        got = reading(label)
        assert abs(got - want) <= GP_Z * np.sqrt(2.0) * GP_MC_SD[label], (label, got, want)
    rmse = float(out.split("posterior-mean RMSE vs sin(x):")[1].split()[0])
    assert rmse < 0.3, rmse
