"""henbun_tpu_torch's multiclass (softmax) Laplace engine and
models.SparseGPMulticlass against the JAX package on the CPU.

Both packages get the same numpy data and the same weights (the JAX
model's ``param_dict()`` after ``initialize()``, carried over by
``interop.params_from_jax``):

* ``_softmax_G``: its Gram matrix is the blocked softmax curvature
  (float64), and it equals the JAX package's;
* ``_sqrt_gram_factor`` / ``logdet_sqrt_gram`` / ``_sqrt_solve`` at the
  adversarial conditioning of the JAX package's ``test_sqrt_factor.py``
  (lambda_max(H) ~ 1e5 over a unit floor) against float64 and the JAX
  package, the logdet's gradient against float64 finite differences;
* ``multiclass_laplace_projected``: value and A-gradient, implicit and
  unrolled, at n = 60, m = 8, K = 3;
* ``multiclass_laplace_joint_marginals``;
* ``SparseGPMulticlass``: evidence and gradients, ``predict_p`` with the
  JAX package's draws injected, a two-model fleet against the single
  models, and z = X against the numpy float64 oracle of
  ``test_multiclass_oracle.py``.

Tolerance: values rtol 1e-4, gradients 1e-4 of the largest entry, unless a
test states otherwise. The JAX references are jitted with their inputs as
arguments.
"""
import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from henbun_tpu import models as jmodels
from henbun_tpu.inference import laplace as jlap
import henbun_tpu_torch as thb
from henbun_tpu_torch.inference import laplace as tlap
from henbun_tpu_torch.interop import params_from_jax

from test_multiclass_oracle import oracle_predict, softmax_laplace_oracle

N, M_IND, K = 60, 8, 3


def _close(got, want, what, rtol=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rtol * max(np.abs(want).max(), 1e-6), err_msg=what)


def _three_class(n, seed=0):
    """test_multiclass_oracle.py's data: sorted U[0, 6] inputs, labels from
    the softmax of 2.5 sin(x + s), s = 0, 2.1, 4.2."""
    rng = np.random.default_rng(seed)
    X = np.sort(rng.uniform(0, 6, (n, 1))).astype(np.float32)
    L = 2.5 * np.concatenate([np.sin(X + s) for s in (0.0, 2.1, 4.2)], axis=1)
    P = np.exp(L - L.max(1, keepdims=True))
    P /= P.sum(1, keepdims=True)
    y = np.array([rng.choice(K, p=p) for p in P], np.int32)[:, None]
    return X, y


def _projection(n, m, kv=2.0, ell=0.8, seed=0):
    """A = sqrt(kv) (Lm^-1 Kmn)^T for an RBF kernel (float32) and labels."""
    X, y = _three_class(n, seed)
    x = X[:, 0].astype(np.float64)
    z = np.linspace(0.0, 6.0, m)
    k = lambda a, b: np.exp(-0.5 * (a[:, None] - b[None, :]) ** 2 / ell**2)
    Lm = np.linalg.cholesky(k(z, z) + 1e-6 * np.eye(m))
    A = np.sqrt(kv) * np.linalg.solve(Lm, k(z, x)).T
    return A.astype(np.float32), y[:, 0]


def _hard_G(n=4000, p=96, scale=200.0, seed=0):
    """test_sqrt_factor.py's tall G: lambda_max(I + G^T G) ~ scale^2 over a
    cluster of eigenvalues at the unit floor."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(-1, 1, n))
    z = np.linspace(-1, 1, p)
    return np.exp(-0.5 * (x[:, None] - z[None, :]) ** 2 / 0.15**2) * (scale / np.sqrt(n))


def test_softmax_G_is_the_square_root_of_the_blocked_curvature():
    rng = np.random.default_rng(0)
    n, m = 30, 5
    A = rng.standard_normal((n, m))
    F = rng.standard_normal((n, K))
    Pi = np.exp(F) / np.exp(F).sum(1, keepdims=True)
    G64 = tlap._softmax_G(torch.tensor(A), torch.tensor(Pi)).numpy()
    # blocks(A^T W_cc' A), W_i = diag(pi_i) - pi_i pi_i^T
    H = np.zeros((K * m, K * m))
    for c in range(K):
        for e in range(K):
            w = Pi[:, c] * ((c == e) - Pi[:, e])
            H[c * m:(c + 1) * m, e * m:(e + 1) * m] = A.T @ (w[:, None] * A)
    np.testing.assert_allclose(G64.T @ G64, H, rtol=0, atol=1e-10 * np.abs(H).max())
    A32, Pi32 = A.astype(np.float32), Pi.astype(np.float32)
    got = tlap._softmax_G(torch.tensor(A32), torch.tensor(Pi32)).numpy()
    want = np.asarray(jax.jit(jlap._softmax_G)(A32, Pi32))
    _close(got, want, "_softmax_G", rtol=1e-6)


def test_sqrt_factor_and_logdet_match_jax_and_float64():
    G64 = _hard_G()
    H64 = np.eye(G64.shape[1]) + G64.T @ G64
    ld_true = np.linalg.slogdet(H64)[1]
    lam = np.linalg.eigvalsh(H64)
    assert lam.max() > 1e4 and lam.min() < 1.0 + 1e-6  # the hard regime
    G32 = G64.astype(np.float32)
    R = tlap._sqrt_gram_factor(torch.tensor(G32)).double().numpy()
    assert np.abs(R.T @ R - H64).max() / np.abs(H64).max() < 1e-5
    assert np.abs(np.tril(R, -1)).max() == 0.0 and np.diag(R).min() > 0
    ld = float(tlap.logdet_sqrt_gram(torch.tensor(G32)))
    assert abs(ld - ld_true) / abs(ld_true) < 1e-4
    ld_jax = float(jax.jit(jlap.logdet_sqrt_gram)(G32))
    assert abs(ld - ld_jax) / abs(ld_jax) < 1e-4, (ld, ld_jax)
    R_jax = np.asarray(jax.jit(jlap._sqrt_gram_factor)(G32), np.float64)
    _close(R, R_jax, "CholQR2 factor", rtol=1e-4)


def test_sqrt_solve_matches_float64_and_jax():
    G64 = _hard_G(seed=1)
    H64 = np.eye(G64.shape[1]) + G64.T @ G64
    b = np.random.default_rng(2).standard_normal((G64.shape[1], 1))
    x64 = np.linalg.solve(H64, b)
    G32, b32 = G64.astype(np.float32), b.astype(np.float32)
    R = tlap._sqrt_gram_factor(torch.tensor(G32))
    xs = tlap._sqrt_solve(R, torch.tensor(b32)).double().numpy()
    assert np.linalg.norm(xs - x64) / np.linalg.norm(x64) < 1e-3
    xj = np.asarray(jax.jit(lambda g, bb: jlap._sqrt_solve(jlap._sqrt_gram_factor(g), bb))(
        G32, b32), np.float64)
    assert np.linalg.norm(xs - xj) / np.linalg.norm(xj) < 1e-3


def test_logdet_gradient_is_the_exact_identity():
    """2 G H^-1 against float64 finite differences along a random direction
    (the JAX package's 2e-3) and against the JAX package's gradient."""
    G64 = _hard_G(n=600, p=32, scale=40.0, seed=3)
    V = np.random.default_rng(4).standard_normal(G64.shape)

    def ld64(Gm):
        return np.linalg.slogdet(np.eye(Gm.shape[1]) + Gm.T @ Gm)[1]

    d_true = (ld64(G64 + 1e-5 * V) - ld64(G64 - 1e-5 * V)) / 2e-5
    G = torch.tensor(G64.astype(np.float32), requires_grad=True)
    tlap.logdet_sqrt_gram(G).backward()
    d_hat = float(torch.sum(G.grad.double() * torch.tensor(V)))
    assert abs(d_hat - d_true) / abs(d_true) < 2e-3
    gj = np.asarray(jax.jit(jax.grad(jlap.logdet_sqrt_gram))(G64.astype(np.float32)))
    _close(G.grad.numpy(), gj, "logdet gradient")


@pytest.mark.parametrize("implicit", [True, False], ids=["implicit", "unrolled"])
def test_multiclass_laplace_projected_matches_jax(implicit):
    """Value, mode and A-gradient. The JAX package cannot take a reverse-mode
    gradient through its unrolled softmax Newton iterations (jax.grad
    raises "Linearization failed"), so the port's unrolled gradient is held
    to the JAX package's implicit one: at a converged mode the two are the
    same derivative."""
    A, y = _projection(N, M_IND)

    def jax_fn(a, implicit_diff):
        r = jlap.multiclass_laplace_projected(a, y, K, implicit_diff=implicit_diff)
        return r.log_marginal, r

    jres = jax.jit(lambda a: jax_fn(a, implicit)[1])(A)
    jg = jax.jit(jax.grad(lambda a: jax_fn(a, True)[0]))(A)
    At = torch.tensor(A, requires_grad=True)
    res = tlap.multiclass_laplace_projected(At, torch.tensor(y), K, implicit_diff=implicit)
    res.log_marginal.backward()
    _close(res.log_marginal.item(), float(jres.log_marginal), "evidence")
    _close(res.u_mode.detach().numpy(), jres.u_mode, "mode")
    _close(res.f_mode.detach().numpy(), jres.f_mode, "logits")
    assert float(res.grad_norm.detach()) < 1e-3 and float(jres.grad_norm) < 1e-3
    _close(At.grad.numpy(), jg, "A-gradient")


def test_joint_marginals_match_jax():
    A, y = _projection(N, M_IND)
    Astar, _ = _projection(7, M_IND, seed=5)
    corr = np.linspace(0.01, 0.1, 7).astype(np.float32)
    jres = jlap.multiclass_laplace_projected(A, y, K)
    jm, jc = jax.jit(jlap.multiclass_laplace_joint_marginals)(A, jres, Astar, corr)
    tres = tlap.multiclass_laplace_projected(torch.tensor(A), torch.tensor(y), K)
    tm, tc = tlap.multiclass_laplace_joint_marginals(
        torch.tensor(A), tres, torch.tensor(Astar), torch.tensor(corr))
    _close(tm.numpy(), jm, "means")
    _close(tc.numpy(), jc, "covariances")
    assert tc.shape == (7, K, K)


def _pair(n=N, m=M_IND, seed=0):
    X, y = _three_class(n, seed)
    jm = jmodels.SparseGPMulticlass(seed=0, X=X, Y=y, num_classes=K, num_inducing=m)
    tm = thb.models.SparseGPMulticlass(seed=0, X=X, Y=y, num_classes=K, num_inducing=m,
                                       device="cpu")
    jm.initialize()
    tm.set_param_dict(params_from_jax(jm.param_dict()))
    return jm, tm


def test_sparse_gp_multiclass_evidence_and_gradients_match_jax():
    jm, tm = _pair()
    jopt = jm.log_marginal_laplace().compile(optax.adam(0.05))
    key = jax.random.PRNGKey(0)
    jv, jg = jax.jit(lambda t, fr, d: jax.value_and_grad(
        lambda tt: jopt._evaluate(tt, fr, d, None, key))(t))(
        jopt._trainable, jopt._frozen, jopt._data_args())
    topt = tm.log_marginal_laplace().compile(learning_rate=0.05)
    val, _ = topt._evaluate_core_aux(topt._trainable, topt._frozen, topt._data_args(),
                                     tm.generator, None)
    val.backward()
    _close(val.item(), float(jv), "evidence")
    assert set(jg) == set(topt._trainable) == {"k_var", "gp.kern.lengthscales"}
    for k in jg:
        _close(topt._trainable[k].grad.numpy(), jg[k], k)
    res = tm.run(lambda mm: mm.laplace())
    assert res.u_mode.shape == (M_IND, K) and res.f_mode.shape == (N, K)


def test_sparse_gp_multiclass_predict_p_matches_jax_with_its_draws():
    jm, tm = _pair()
    grid = np.linspace(0.2, 5.8, 9, dtype=np.float32)[:, None]
    num = 64
    jp = np.asarray(jax.jit(lambda: jm.run(lambda mm: mm.predict_p(grid, num=num)))())
    eps = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (num, 9, K), dtype=jnp.float32))
    tp = tm.run(lambda mm: mm.predict_p(grid, num=num),
                noise={"predict_p": torch.tensor(eps)}).numpy()
    _close(tp, jp, "predict_p")
    # the port's own fixed draws: the same at every call, rows sum to one
    a = tm.run(lambda mm: mm.predict_p(grid, num=num)).numpy()
    b = tm.run(lambda mm: mm.predict_p(grid, num=num)).numpy()
    assert np.array_equal(a, b) and np.allclose(a.sum(-1), 1.0, atol=1e-5)


def test_sparse_gp_multiclass_fleet_matches_the_single_models():
    """Two models under BatchedOptimizer: the engine's Functions run their
    vmap rules (K m = 24 <= 128, so the factorizations and solves take the
    batched kernels' plain versions) and give each model its own evidence
    and gradients."""
    pairs = [_pair(n=40, seed=s) for s in (0, 1)]
    tms = [p[1] for p in pairs]
    fleet = thb.BatchedOptimizer(tms, "log_marginal_laplace").compile(learning_rate=0.05)
    val, _ = fleet._evaluate_core_aux(fleet._trainable, fleet._frozen, fleet._data_args(),
                                      tms[0].generator, None)
    val.backward()
    singles = 0.0
    for i, tm in enumerate(tms):
        opt = tm.log_marginal_laplace().compile(learning_rate=0.05)
        v, _ = opt._evaluate_core_aux(opt._trainable, opt._frozen, opt._data_args(),
                                      tm.generator, None)
        v.backward()
        singles += v.item()
        for k, t in opt._trainable.items():
            _close(fleet._trainable[k].grad[i].numpy(), t.grad.numpy(), "%s[%d]" % (k, i))
    _close(val.item(), singles, "fleet evidence")


def test_z_equal_x_matches_the_numpy_oracle():
    """The JAX package's test_multiclass_oracle gate on the port: with z = X
    the engine is the float64 oracle's GPML 3.5 Laplace (evidence within
    1e-3, probabilities within 0.02)."""
    X, y = _three_class(N)
    thb.set_seed(0)
    m = thb.models.SparseGPMulticlass(seed=0, X=X, Y=y, num_classes=K, num_inducing=N,
                                      device="cpu")
    m.gp.z = X.copy()
    m.initialize()
    kv = float(np.asarray(m.k_var.value)[0])
    ell = float(np.asarray(m.gp.kern.lengthscales.value)[0])
    res = m.run(lambda mm: mm.laplace())
    assert float(res.grad_norm) < 1e-3
    jit = float(thb.settings.numerics.jitter_level)
    Xd = X[:, 0].astype(np.float64)
    Kg = kv * (np.exp(-0.5 * (Xd[:, None] - Xd[None, :]) ** 2 / ell**2) + jit * np.eye(N))
    _, g, W, ev, gn = softmax_laplace_oracle(Kg, y[:, 0], K)
    assert gn < 1e-2
    assert abs(float(res.log_marginal) - ev) < 1e-3 * abs(ev)
    grid = np.linspace(0.2, 5.8, 20, dtype=np.float32)[:, None]
    p = m.run(lambda mm: mm.predict_p(grid, num=4096)).numpy()
    gd = grid[:, 0].astype(np.float64)
    ks = kv * np.exp(-0.5 * (Xd[:, None] - gd[None, :]) ** 2 / ell**2)
    p_or = oracle_predict(Kg, ks, np.full(len(gd), kv), g, W, K)
    assert np.abs(p - p_or).max() < 0.02, np.abs(p - p_or).max()
