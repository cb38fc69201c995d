"""henbun_tpu_torch linear algebra against the JAX package on the CPU.

The plain versions of the two CUDA kernels (K1 batched Cholesky, K2
batched triangular solve) are held against the JAX package's Pallas
kernels run in interpret mode and against XLA; ``safe_cholesky`` and
``tri_solve`` values and gradients are held against ``jax.grad`` through
``jax.vmap`` of the JAX functions, including per-matrix jitter escalation.
Inputs come from a numpy seed; tolerances are stated per test.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from henbun_tpu.ops import linalg as jlinalg
from henbun_tpu.ops.pallas_chol import cholesky128_vbatched as jax_chol128
from henbun_tpu.ops.pallas_solve import tri_solve128_vbatched as jax_solve128
from henbun_tpu_torch.ops import cuda_chol, cuda_solve
from henbun_tpu_torch.ops import linalg as tlinalg


def _spd(B, n, seed, cond=1e2):
    """SPD batch with condition number `cond`: eigenvalues log-spaced in
    [1/cond, 1], so factor entries are O(1); random orthogonal
    eigenvectors."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(B, n, n)))
    ev = np.logspace(-np.log10(cond), 0, n)
    return ((Q * ev[None, None, :]) @ np.swapaxes(Q, -1, -2)).astype(np.float32)


def _lower(B, n, seed):
    """Well-conditioned lower-triangular factors, with NaN planted in the
    strictly upper triangle (which no solve may read)."""
    rng = np.random.default_rng(seed)
    L = np.tril(rng.normal(size=(B, n, n)) * 0.3).astype(np.float32)
    L[:, np.arange(n), np.arange(n)] = rng.uniform(1.0, 2.0, size=(B, n))
    iu = np.triu_indices(n, 1)
    L[:, iu[0], iu[1]] = np.nan
    return L


# ---------------------------------------------------------------- K1 plain
@pytest.mark.parametrize("B,n", [(3, 17), (2, 5), (1, 1)])
def test_plain_cholesky_matches_pallas_and_xla(B, n):
    """rtol 1e-5, atol 1e-6 at cond <= 1e3 (float32 factorization error)."""
    A = _spd(B, n, seed=B * 100 + n, cond=1e3)
    L = cuda_chol.cholesky128_plain(torch.tensor(A)).numpy()
    L_pallas = np.asarray(jax_chol128(jnp.asarray(A), interpret=True))
    L_xla = np.asarray(jnp.linalg.cholesky(jnp.asarray(A)))
    np.testing.assert_allclose(L, L_pallas, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(L, L_xla, rtol=1e-5, atol=1e-6)
    assert np.all(np.triu(L, 1) == 0.0)


def test_plain_cholesky_reads_only_lower_triangle():
    A = _spd(2, 9, seed=3)
    Adirty = A.copy()
    iu = np.triu_indices(9, 1)
    Adirty[:, iu[0], iu[1]] = np.nan
    L = cuda_chol.cholesky128_plain(torch.tensor(A)).numpy()
    Ld = cuda_chol.cholesky128_plain(torch.tensor(Adirty)).numpy()
    np.testing.assert_array_equal(L, Ld)


def test_plain_cholesky_nan_isolation():
    """The non-SPD matrix of a batch is all NaN (the Pallas kernel's NaN
    pattern inside a failed matrix is not compared: it writes NaN from the
    failed pivot on); the others still match (rtol 1e-5, atol 1e-6)."""
    A = _spd(3, 8, seed=11)
    A[1] = -A[1]
    L = cuda_chol.cholesky128_plain(torch.tensor(A)).numpy()
    L_pallas = np.asarray(jax_chol128(jnp.asarray(A), interpret=True))
    assert np.isnan(L[1]).all()
    assert np.isnan(L_pallas[1]).any()
    for b in (0, 2):
        assert np.isfinite(L[b]).all()
        np.testing.assert_allclose(L[b], L_pallas[b], rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------- K2 plain
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("B,n,m", [(3, 17, 4), (2, 6, 1), (1, 9, 9)])
def test_plain_solve_matches_pallas(B, n, m, transpose):
    """Both modes, NaN in the unread triangle; rtol 1e-5, atol 1e-5 on
    solutions of O(1) (float32 substitution, well-conditioned factors)."""
    L = _lower(B, n, seed=n + m)
    R = np.random.default_rng(n * m).normal(size=(B, n, m)).astype(np.float32)
    X = cuda_solve.tri_solve128_plain(torch.tensor(L), torch.tensor(R), transpose).numpy()
    X_pallas = np.asarray(
        jax_solve128(jnp.asarray(L), jnp.asarray(R), transpose=transpose, interpret=True)
    )
    assert np.isfinite(X).all()
    np.testing.assert_allclose(X, X_pallas, rtol=1e-5, atol=1e-5)
    Lc = np.nan_to_num(np.tril(np.nan_to_num(L)))
    M = np.swapaxes(Lc, -1, -2) if transpose else Lc
    np.testing.assert_allclose(M @ X, R, rtol=1e-4, atol=1e-4)


# ------------------------------------------------------- wrapper contract
def test_wrappers_take_plain_version_on_cpu_and_count_nothing():
    A = torch.tensor(_spd(2, 6, seed=1))
    L = torch.tensor(np.nan_to_num(_lower(2, 6, seed=2)))
    R = torch.ones(2, 6, 3)
    c0, s0 = cuda_chol.cholesky128_vbatched.launches, cuda_solve.tri_solve128_vbatched.launches
    torch.testing.assert_close(
        cuda_chol.cholesky128_vbatched(A), cuda_chol.cholesky128_plain(A), rtol=0, atol=0
    )
    torch.testing.assert_close(
        cuda_solve.tri_solve128_vbatched(L, R, transpose=True),
        cuda_solve.tri_solve128_plain(L, R, True), rtol=0, atol=0,
    )
    assert cuda_chol.cholesky128_vbatched.launches == c0
    assert cuda_solve.tri_solve128_vbatched.launches == s0


@pytest.mark.parametrize(
    "bad",
    [
        torch.eye(4)[None].double(),          # float64
        torch.eye(4),                          # 2-D
        torch.eye(129)[None],                  # n > 128
        torch.eye(4)[None].expand(2, 4, 4),    # not contiguous
        torch.eye(4, device="meta")[None],     # neither CUDA nor CPU
    ],
)
def test_wrappers_raise_on_what_they_do_not_take(bad):
    with pytest.raises((TypeError, ValueError)):
        cuda_chol.cholesky128_vbatched(bad)
    rhs = torch.ones(bad.shape[:-1] + (1,), dtype=bad.dtype, device=bad.device)
    with pytest.raises((TypeError, ValueError)):
        cuda_solve.tri_solve128_vbatched(bad, rhs)


def test_solve_wrapper_raises_on_wide_rhs():
    with pytest.raises(ValueError):
        cuda_solve.tri_solve128_vbatched(torch.eye(4)[None], torch.ones(1, 4, 129))


# ---------------------------------------------------------------- dispatch
def test_dispatch_routes_by_shape(monkeypatch):
    """3-D float32 n <= 128 on the CPU -> the K1/K2 wrapper (plain
    version); 2-D, n > 128 or float64 -> torch.linalg."""
    calls = []
    chol, solve = cuda_chol.cholesky128_vbatched, cuda_solve.tri_solve128_vbatched
    monkeypatch.setattr(cuda_chol, "cholesky128_vbatched",
                        lambda A: calls.append("K1") or chol(A))
    monkeypatch.setattr(cuda_solve, "tri_solve128_vbatched",
                        lambda L, R, transpose=False: calls.append("K2") or solve(L, R, transpose))
    A3 = torch.tensor(_spd(2, 5, seed=0))
    tlinalg.safe_cholesky(A3)
    tlinalg.tri_solve(A3, A3)
    assert calls == ["K1", "K2"]
    calls.clear()
    tlinalg.safe_cholesky(A3[0])
    tlinalg.safe_cholesky(A3.double())
    tlinalg.safe_cholesky(torch.eye(130)[None])
    tlinalg.tri_solve(A3[0], A3[0])
    assert calls == []


def test_linalg_branch_writes_nan_over_failed_factor():
    """torch.linalg.cholesky_ex leaves a finite partial factor where
    jnp.linalg.cholesky gives NaN; the dispatch writes NaN over it."""
    A = torch.tensor([[1.0, 2.0], [2.0, 1.0]])
    assert torch.isfinite(torch.linalg.cholesky_ex(A)[0]).all()
    assert np.isnan(np.asarray(jnp.linalg.cholesky(jnp.asarray(A.numpy())))).any()
    assert torch.isnan(tlinalg._cholesky_dispatch(A)).all()


# ------------------------------------------ Functions against jax.vmap/grad
def _escalation_batch():
    """B=3, n=6: matrix 1 has a -1e-3 eigenvalue (the 1e-4 jitter fails,
    x100 succeeds), matrix 2 a -5 one (fails at every jitter up to 1)."""
    A = _spd(3, 6, seed=5, cond=10.0)
    rng = np.random.default_rng(6)
    for b, lam in ((1, -1e-3), (2, -5.0)):
        Q, _ = np.linalg.qr(rng.normal(size=(6, 6)))
        ev = np.linspace(1.0, 3.0, 6)
        ev[0] = lam
        A[b] = ((Q * ev) @ Q.T).astype(np.float32)
    return A


def test_safe_cholesky_escalates_per_matrix_like_jax_vmap():
    """Per-element escalation: values match jax.vmap(safe_cholesky) (rtol
    1e-5, atol 1e-6); the hopeless matrix stays NaN, the others finite."""
    A = _escalation_batch()
    L_jax = np.asarray(jax.vmap(lambda a: jlinalg.safe_cholesky(a, 1e-4))(jnp.asarray(A)))
    L_direct = tlinalg.safe_cholesky(torch.tensor(A), 1e-4).numpy()
    L_vmap = torch.func.vmap(lambda a: tlinalg.safe_cholesky(a, 1e-4))(torch.tensor(A)).numpy()
    for L in (L_direct, L_vmap):
        assert np.isfinite(L[:2]).all() and np.isnan(L[2]).all()
        np.testing.assert_allclose(L[:2], L_jax[:2], rtol=1e-5, atol=1e-6)
    # matrix 1 was refactorized at 1e-2, matrix 0 kept its 1e-4 factor
    np.testing.assert_allclose(
        L_direct[1] @ L_direct[1].T, A[1] + 1e-2 * np.eye(6), rtol=1e-4, atol=1e-5
    )
    np.testing.assert_allclose(
        L_direct[0] @ L_direct[0].T, A[0] + 1e-4 * np.eye(6), rtol=1e-4, atol=1e-5
    )


@pytest.mark.parametrize("escalate", [False, True])
def test_safe_cholesky_grad_matches_jax_under_vmap(escalate):
    """d/dA sum(W * L) through vmap: rtol 1e-4 (float32 solves in the
    Murray backward), atol 1e-4 of the largest entry."""
    A = _escalation_batch()[:2] if escalate else _spd(3, 7, seed=9, cond=50.0)
    W = np.random.default_rng(1).normal(size=A.shape).astype(np.float32)

    def jloss(a):
        return jnp.sum(jnp.asarray(W) * jax.vmap(lambda x: jlinalg.safe_cholesky(x, 1e-4))(a))

    g_jax = np.asarray(jax.grad(jloss)(jnp.asarray(A)))
    At = torch.tensor(A, requires_grad=True)
    L = torch.func.vmap(lambda x: tlinalg.safe_cholesky(x, 1e-4))(At)
    (torch.tensor(W) * L).sum().backward()
    g = At.grad.numpy()
    np.testing.assert_allclose(g, g_jax, rtol=1e-4, atol=1e-4 * np.abs(g_jax).max())


@pytest.mark.parametrize("rhs_batched", [True, False])
def test_tri_solve_value_and_grad_match_jax_under_vmap(rhs_batched):
    """Value and both gradients through vmap, with an unbatched RHS
    broadcast by the vmap rule; rtol 1e-4, atol 1e-4 of the largest
    entry."""
    B, n, m = 3, 7, 4
    L = np.nan_to_num(_lower(B, n, seed=21))
    rng = np.random.default_rng(22)
    R = rng.normal(size=(B, n, m) if rhs_batched else (n, m)).astype(np.float32)
    W = rng.normal(size=(B, n, m)).astype(np.float32)
    r_axis = 0 if rhs_batched else None

    def jloss(l, r):
        X = jax.vmap(jlinalg.tri_solve, in_axes=(0, r_axis))(l, r)
        return jnp.sum(jnp.asarray(W) * X), X

    (_, X_jax), (gL_jax, gR_jax) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(L), jnp.asarray(R)
    )
    Lt = torch.tensor(L, requires_grad=True)
    Rt = torch.tensor(R, requires_grad=True)
    X = torch.func.vmap(tlinalg.tri_solve, in_dims=(0, r_axis))(Lt, Rt)
    (torch.tensor(W) * X).sum().backward()
    for got, want in ((X.detach(), X_jax), (Lt.grad, gL_jax), (Rt.grad, gR_jax)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())
    assert np.all(np.triu(Lt.grad.numpy()[0], 1) == 0.0)


def test_single_matrix_functions_match_jax():
    """The torch.linalg branch (2-D) of both Functions: value and gradient
    against jax.grad; rtol 1e-4, atol 1e-4 of the largest entry."""
    A = _spd(1, 6, seed=31, cond=20.0)[0]
    R = np.random.default_rng(32).normal(size=(6, 2)).astype(np.float32)

    def jloss(a, r):
        L = jlinalg.safe_cholesky(a, 1e-4)
        return jnp.sum(jlinalg.tri_solve(L, r) ** 2)

    v_jax, (gA_jax, gR_jax) = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(A), jnp.asarray(R))
    At = torch.tensor(A, requires_grad=True)
    Rt = torch.tensor(R, requires_grad=True)
    v = torch.sum(tlinalg.tri_solve(tlinalg.safe_cholesky(At, 1e-4), Rt) ** 2)
    v.backward()
    np.testing.assert_allclose(v.item(), float(v_jax), rtol=1e-4)
    for got, want in ((At.grad, gA_jax), (Rt.grad, gR_jax)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())


# ------------------------------------------------------------- packing ops
def test_triangle_packings_match_jax():
    vec = np.random.default_rng(4).normal(size=(2, 15)).astype(np.float32)
    for tfn, jfn in (
        (tlinalg.vec_to_tri, jlinalg.vec_to_tri),
        (tlinalg.fill_triangular, jlinalg.fill_triangular),
    ):
        np.testing.assert_array_equal(tfn(torch.tensor(vec)).numpy(), np.asarray(jfn(jnp.asarray(vec))))
    mat = tlinalg.fill_triangular(torch.tensor(vec))
    np.testing.assert_array_equal(tlinalg.fill_triangular_inverse(mat).numpy(), vec)
    np.testing.assert_array_equal(
        tlinalg.tri_to_vec(tlinalg.vec_to_tri(torch.tensor(vec))).numpy(), vec
    )
    np.testing.assert_array_equal(
        tlinalg.fill_triangular_diag_indices(5), jlinalg.fill_triangular_diag_indices(5)
    )
