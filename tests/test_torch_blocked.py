"""henbun_tpu_torch's K4, K5 and K6 entry points and blocked algorithms
against the JAX package on the CPU.

* ``cuda_chol.cholesky128`` (K4) and ``cholesky128_batched`` (K5), whose
  plain version runs on a CPU tensor, against the Pallas kernels
  ``pallas_chol.cholesky128`` / ``cholesky128_batched`` in interpret mode;
* ``cuda_wide.wide_lsolve128`` / ``wide_usolve128`` (K6's plain version)
  against ``pallas_wide``'s kernels in interpret mode, at the smallest
  legal width (m = 128: interpret mode unrolls 16 panels of 8 steps);
* the shape checks, which must refuse what the reference refuses;
* ``ops.blocked`` (whose 128-column panel solves run K2's plain version
  here) against ``henbun_tpu.ops.blocked`` at n = 128 and 384, and NaN
  from a broken diagonal block.

The same numpy inputs go to both packages.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from henbun_tpu.ops import blocked as jblocked
from henbun_tpu.ops import pallas_chol, pallas_wide
from henbun_tpu_torch.ops import blocked as tblocked
from henbun_tpu_torch.ops import cuda_chol, cuda_solve, cuda_wide


def _spd(n, seed=0, batch=None):
    """test_pallas.py's SPD matrices: G G^T + n I."""
    shape = (batch, n, n) if batch else (n, n)
    G = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return G @ np.swapaxes(G, -1, -2) + n * np.eye(n, dtype=np.float32)


def _spd_large(n, seed=0):
    """test_blocked.py's SPD matrices: G G^T / n + 2 I."""
    G = np.random.default_rng(seed).standard_normal((n, n)).astype(np.float32)
    return G @ G.T / n + 2.0 * np.eye(n, dtype=np.float32)


# ------------------------------------------------------------------ K4, K5
@pytest.mark.parametrize("n", [8, 40])
def test_cholesky128_plain_matches_pallas_interpret(n):
    """K4 on one matrix; NaN in the unread upper triangle of the port's
    input: atol 1e-5 of the factor's largest entry (float32, another
    order of the updates)."""
    A = _spd(n, seed=n)
    want = np.asarray(pallas_chol.cholesky128(jnp.asarray(A), interpret=True))
    At = torch.tensor(A)
    iu = np.triu_indices(n, 1)
    At[iu[0], iu[1]] = float("nan")
    got = cuda_chol.cholesky128(At).numpy()
    assert got.shape == (n, n) and np.all(np.triu(got, 1) == 0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("n", [8, 40])
def test_cholesky128_batched_plain_matches_pallas_interpret(n):
    """K5 on a batch of 4, one of them negated (not positive definite): that
    factor is all NaN in the port (the Pallas kernel writes NaN from the
    failed pivot on) and the other three match the reference, atol 1e-5 of
    the largest entry."""
    A = _spd(n, seed=n + 4, batch=4)
    want = np.asarray(pallas_chol.cholesky128_batched(jnp.asarray(A), interpret=True))
    A[2] = -A[2]
    got = cuda_chol.cholesky128_batched(torch.tensor(A)).numpy()
    assert got.shape == (4, n, n)
    assert np.isnan(got[2]).all()
    keep = [0, 1, 3]
    np.testing.assert_allclose(got[keep], want[keep], rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_cholesky128_entries_count_only_their_own_launches_on_the_cpu():
    """The plain version launches nothing: every counter stays put."""
    before = (cuda_chol.cholesky128.launches, cuda_chol.cholesky128_batched.launches,
              cuda_chol.cholesky128_vbatched.launches)
    cuda_chol.cholesky128(torch.eye(3))
    cuda_chol.cholesky128_batched(torch.eye(3)[None])
    assert (cuda_chol.cholesky128.launches, cuda_chol.cholesky128_batched.launches,
            cuda_chol.cholesky128_vbatched.launches) == before


def test_cholesky128_casts_like_the_reference():
    """The reference computes in float32 whatever it is given."""
    A = _spd(6, seed=1).astype(np.float64)
    got = cuda_chol.cholesky128(torch.tensor(A))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.linalg.cholesky(A), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------- K6
@pytest.mark.parametrize("upper", [False, True])
def test_wide_solve_plain_matches_pallas_interpret(upper):
    """K6 in both modes at m = 128; the port's factor holds NaN in the
    triangle it must not read: atol 1e-5 on O(0.1) solutions (the
    reference test's factor, diagonal 10 plus N(0, 1))."""
    rng = np.random.default_rng(0)
    L = np.tril(rng.standard_normal((128, 128))).astype(np.float32)
    L += 10.0 * np.eye(128, dtype=np.float32)
    B = rng.standard_normal((128, 128)).astype(np.float32)
    T = np.ascontiguousarray(L.T) if upper else L
    ref = pallas_wide.wide_usolve128 if upper else pallas_wide.wide_lsolve128
    want = np.asarray(ref(jnp.asarray(T), jnp.asarray(B), interpret=True))
    Tt = torch.tensor(T)
    off = np.tril_indices(128, -1) if upper else np.triu_indices(128, 1)
    Tt[off[0], off[1]] = float("nan")
    port = cuda_wide.wide_usolve128 if upper else cuda_wide.wide_lsolve128
    got = port(Tt, torch.tensor(B)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("m", [256, 1024])
@pytest.mark.parametrize("upper", [False, True])
def test_wide_solve_plain_matches_solve_triangular(m, upper):
    """Wider panels against torch.linalg on the same factor: rtol 1e-5,
    atol 1e-6."""
    rng = np.random.default_rng(m)
    L = np.tril(rng.standard_normal((128, 128)) * 0.1).astype(np.float32)
    L[np.arange(128), np.arange(128)] = rng.uniform(1.0, 2.0, 128)
    T = torch.tensor(L.T.copy() if upper else L)
    B = torch.tensor(rng.standard_normal((128, m)).astype(np.float32))
    got = cuda_wide.wide_solve128_plain(T, B, upper)
    want = torch.linalg.solve_triangular(T, B, upper=upper)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def _raises_in_both(ref_call, port_call):
    with pytest.raises(ValueError):
        ref_call()
    with pytest.raises(ValueError):
        port_call()


@pytest.mark.parametrize("case", [
    "chol_129", "chol_not_square", "batched_2d", "batched_129",
    "wide_m_100", "wide_m_8320", "wide_factor_64", "wide_rhs_rows",
])
def test_shape_checks_refuse_what_the_reference_refuses(case):
    z = lambda *s: np.zeros(s, np.float32)
    eye = lambda n: np.eye(n, dtype=np.float32)
    chol = {
        "chol_129": (pallas_chol.cholesky128, cuda_chol.cholesky128, eye(129)),
        "chol_not_square": (pallas_chol.cholesky128, cuda_chol.cholesky128, z(3, 4)),
        "batched_2d": (pallas_chol.cholesky128_batched, cuda_chol.cholesky128_batched, eye(4)),
        "batched_129": (pallas_chol.cholesky128_batched, cuda_chol.cholesky128_batched,
                        z(1, 129, 129)),
    }
    wide = {
        "wide_m_100": (eye(128), z(128, 100)),
        "wide_m_8320": (eye(128), z(128, 8320)),
        "wide_factor_64": (eye(64), z(64, 128)),
        "wide_rhs_rows": (eye(128), z(64, 128)),
    }
    if case in chol:
        ref, port, A = chol[case]
        _raises_in_both(lambda: ref(jnp.asarray(A)), lambda: port(torch.tensor(A)))
    else:
        T, B = wide[case]
        for ref, port in ((pallas_wide.wide_lsolve128, cuda_wide.wide_lsolve128),
                          (pallas_wide.wide_usolve128, cuda_wide.wide_usolve128)):
            _raises_in_both(lambda: ref(jnp.asarray(T), jnp.asarray(B)),
                            lambda: port(torch.tensor(T), torch.tensor(B)))


# ----------------------------------------------------------------- blocked
@pytest.mark.parametrize("n", [128, 384])
def test_blocked_cholesky_matches_jax(n):
    """atol 2e-6 on O(1) factors (test_blocked.py's bound against XLA)."""
    A = _spd_large(n)
    want = np.asarray(jax.jit(jblocked.blocked_cholesky)(jnp.asarray(A)))
    got = tblocked.blocked_cholesky(torch.tensor(A)).numpy()
    assert np.all(np.triu(got, 1) == 0)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


@pytest.mark.parametrize("n", [128, 384])
@pytest.mark.parametrize("transpose", [False, True])
def test_blocked_tri_solve_matches_jax(n, transpose):
    """m = n right-hand sides: atol 5e-6 (test_blocked.py's bound)."""
    L = np.linalg.cholesky(_spd_large(n).astype(np.float64)).astype(np.float32)
    B = np.random.default_rng(1).standard_normal((n, n)).astype(np.float32)
    want = np.asarray(jax.jit(lambda l, b: jblocked.blocked_tri_solve(l, b, transpose))(L, B))
    got = tblocked.blocked_tri_solve(torch.tensor(L), torch.tensor(B), transpose).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-6)


@pytest.mark.parametrize("m", [128, 1])
def test_blocked_tri_solve_narrow_rhs_matches_jax(m):
    """n = 384 against 128 columns (one K2 chunk a block) and against one
    (torch.linalg panels): atol 5e-6."""
    n = 384
    L = np.linalg.cholesky(_spd_large(n).astype(np.float64)).astype(np.float32)
    B = np.random.default_rng(2).standard_normal((n, m)).astype(np.float32)
    want = np.asarray(jax.jit(jblocked.blocked_tri_solve)(L, B))
    got = tblocked.blocked_tri_solve(torch.tensor(L), torch.tensor(B)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-6)


def test_blocked_panels_take_k2_plain_on_the_cpu(monkeypatch):
    """A 128-multiple panel goes through tri_solve128_vbatched with its
    chunks on the batch axis; a narrow one does not."""
    calls = []
    real = cuda_solve.tri_solve128_vbatched

    def spy(L, R, transpose=False):
        calls.append(tuple(R.shape))
        return real(L, R, transpose)

    monkeypatch.setattr(cuda_solve, "tri_solve128_vbatched", spy)
    L = torch.tensor(np.linalg.cholesky(_spd_large(256)).astype(np.float32))
    tblocked.blocked_tri_solve(L, torch.ones(256, 384))
    assert calls == [(3, 128, 128), (3, 128, 128)]
    calls.clear()
    tblocked.blocked_tri_solve(L, torch.ones(256, 5))
    assert calls == []


def test_blocked_nan_propagates_like_jax():
    """A broken second diagonal block (n = 384): the first block column
    matches JAX, and NaN fills the rest of the factor's lower part in both
    packages."""
    A = _spd_large(384)
    A[200, 200] = -1e6
    want = np.asarray(jax.jit(jblocked.blocked_cholesky)(jnp.asarray(A)))
    got = tblocked.blocked_cholesky(torch.tensor(A)).numpy()
    np.testing.assert_allclose(got[:, :128], want[:, :128], rtol=0, atol=2e-6)
    low = np.tril(np.ones((256, 256), bool))
    assert np.isnan(got[128:, 128:][low]).all()
    assert np.isnan(want[128:, 128:][low]).all()


def test_blocked_refuses_sizes_that_are_not_128_multiples():
    with pytest.raises(ValueError):
        tblocked.blocked_cholesky(torch.eye(130))
    with pytest.raises(ValueError):
        tblocked.blocked_tri_solve(torch.eye(128), torch.ones(64, 3))
