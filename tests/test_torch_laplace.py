"""henbun_tpu_torch's Laplace engine against the JAX package on the CPU.

The same inputs (numpy seeds) and, for the models, the same weights (the
JAX model's ``param_dict()`` carried over by ``interop.params_from_jax``)
go through both packages:

* the batched Newton mode of K3's plain version
  (``ops/cuda_newton.newton_mode_plain``) against JAX's
  ``jax.vmap(_newton_iterations)``, and once against the Pallas kernel in
  interpret mode;
* ``laplace_whitened`` (mode, evidence, marginals, IFT gradients), the IFT
  against the unrolled loop, and ``fused=`` unbatched and under vmap;
* 3-model ``BatchedOptimizer`` fleets of ``GPR.log_marginal_laplace_student``
  and ``GPC.log_marginal_laplace`` (their batched Newton forward is the
  plain K3 on the CPU): value and gradients, then 5 Adam steps against
  optax;
* ``GPC.predict_p``, ``GPR.predict_f_laplace``,
  ``laplace_projected_marginals`` (square and rectangular),
  ``densities.bernoulli_logit`` and ``gauss_hermite_expectation``.

Small sizes (n <= 24, fleets of 3) keep the file to seconds.
"""
import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from henbun_tpu import densities as jdens
from henbun_tpu import models as jmodels
from henbun_tpu.batched import BatchedOptimizer as JaxBatched
from henbun_tpu.inference.laplace import _newton_iterations as jax_newton
from henbun_tpu.inference.laplace import laplace_whitened as jax_laplace
from henbun_tpu.ops.quadrature import gauss_hermite_expectation as jax_gh
import henbun_tpu_torch as thb
from henbun_tpu_torch import densities as tdens
from henbun_tpu_torch.inference import laplace as tlap
from henbun_tpu_torch.interop import params_from_jax
from henbun_tpu_torch.ops import cuda_newton
from henbun_tpu_torch.ops.quadrature import gauss_hermite_expectation as torch_gh

M = 3


def _rbf_batch(B, n, seed):
    """Scaled RBF factors and outlier-laden sine targets, as
    test_fused_newton.py builds them."""
    rng = np.random.default_rng(seed)
    Lks, ys = [], []
    for b in range(B):
        X = np.sort(rng.uniform(0, 6, (n, 1)))
        K = np.exp(-0.5 * (X - X.T) ** 2 / 0.7**2) + 1e-4 * np.eye(n)
        Lks.append(np.linalg.cholesky(K) * (1.0 + 0.2 * b))
        y = np.sin(X) + 0.1 * rng.standard_normal((n, 1))
        y[::7] += 2.0
        ys.append(y)
    var = np.asarray([[0.15 + 0.05 * b] for b in range(B)])
    return (np.stack(Lks).astype(np.float32), np.stack(ys).astype(np.float32),
            var.astype(np.float32))


def _jax_bernoulli(y):
    return lambda f: y * jax.nn.log_sigmoid(f) + (1 - y) * jax.nn.log_sigmoid(-f)


def _jax_modes(tag, Lk, y, var):
    if tag == "student_t":
        fn = lambda L, yy, vv: jax_newton(lambda f: jdens.student_t(yy, f, vv, 3.0), L, 15, 1e-6)
    else:
        fn = lambda L, yy, vv: jax_newton(_jax_bernoulli(yy), L, 15, 1e-6)
    return np.asarray(jax.vmap(fn)(Lk, y, var))


# ------------------------------------------------------------ K3's plain version
@pytest.mark.parametrize("tag,B,n,m,tol", [
    ("student_t", 3, 16, 16, 1e-4),
    ("bernoulli_logit", 3, 16, 16, 1e-3),
    ("rectangular", 2, 24, 8, 1e-3),
])
def test_plain_newton_matches_jax_generic_loop(tag, B, n, m, tol):
    """The tolerances of test_fused_newton.py (Pallas against the generic
    loop): float32 factorizations and sums in another order, through 15
    dependent iterations."""
    if tag == "rectangular":
        rng = np.random.default_rng(2)
        Lk = (rng.standard_normal((B, n, m)) * 0.4).astype(np.float32)
        y = (rng.standard_normal((B, n, 1)) > 0).astype(np.float32)
        var = np.ones((B, 1), np.float32)
        tag = "bernoulli_logit"
    else:
        Lk, y, var = _rbf_batch(B, n, seed=0 if tag == "student_t" else 1)
        if tag == "bernoulli_logit":
            y = (y > 0).astype(np.float32)
    want = _jax_modes(tag, Lk, y, var)
    got = cuda_newton.newton_mode_plain(
        torch.tensor(Lk), torch.tensor(y), torch.tensor(var), tag, df=3.0
    )
    assert got.shape == (B, m, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)


def test_plain_newton_matches_pallas_interpret():
    """The Pallas kernel itself (interpret mode) at B = 2, n = 12: atol
    1e-4. Its floor holds one jitter (1e-6) less than the generic loop's,
    which the plain version follows; that moves v* by far less."""
    from henbun_tpu.ops.pallas_newton import newton_mode_vbatched

    Lk, y, var = _rbf_batch(2, 12, seed=3)
    want = np.asarray(newton_mode_vbatched(
        jnp.asarray(Lk), jnp.asarray(y), jnp.asarray(var), "student_t", df=3.0,
        iters=15, interpret=True,
    ))
    got = cuda_newton.newton_mode_plain(
        torch.tensor(Lk), torch.tensor(y), torch.tensor(var), "student_t", df=3.0
    )
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_plain_newton_isolates_a_nan_model():
    """One model's NaN target leaves that model at v = 0 (every comparison
    with a NaN psi fails) and the others exactly as without it."""
    Lk, y, var = (torch.tensor(a) for a in _rbf_batch(3, 10, seed=4))
    clean = cuda_newton.newton_mode_plain(Lk, y, var, "student_t", df=3.0)
    y_bad = y.clone()
    y_bad[1, 4] = float("nan")
    got = cuda_newton.newton_mode_plain(Lk, y_bad, var, "student_t", df=3.0)
    assert torch.equal(got[1], torch.zeros_like(got[1]))
    assert torch.equal(got[0], clean[0]) and torch.equal(got[2], clean[2])


def test_wrapper_takes_plain_version_on_cpu_and_refuses_bad_input():
    Lk, y, var = (torch.tensor(a) for a in _rbf_batch(2, 8, seed=5))
    before = cuda_newton.newton_mode_vbatched.launches
    got = cuda_newton.newton_mode_vbatched(Lk, y, var, "student_t", df=3.0)
    assert cuda_newton.newton_mode_vbatched.launches == before
    assert torch.equal(got, cuda_newton.newton_mode_plain(Lk, y, var, "student_t", df=3.0))
    with pytest.raises(TypeError):
        cuda_newton.newton_mode_vbatched(Lk.double(), y, var, "student_t", df=3.0)
    with pytest.raises(ValueError):
        cuda_newton.newton_mode_vbatched(Lk, y, var, "poisson")
    with pytest.raises(ValueError):
        cuda_newton.newton_mode_vbatched(Lk, y, var, "student_t")  # df = 0
    with pytest.raises(ValueError):
        cuda_newton.newton_mode_vbatched(torch.zeros(2, 129, 4), torch.zeros(2, 129, 1), var,
                                         "bernoulli_logit")


# ------------------------------------------------------------ laplace_whitened
def _one_problem(n, seed, outliers):
    rng = np.random.default_rng(seed)
    X = np.sort(rng.uniform(0, 6, n)).astype(np.float32)[:, None]
    y = np.sin(X) + rng.normal(size=X.shape).astype(np.float32) * 0.3
    if outliers:
        idx = rng.choice(n, outliers, replace=False)
        y[idx] += rng.choice([-3.0, 3.0], outliers)[:, None]
    K = np.exp(-0.5 * (X - X.T) ** 2 / 0.8**2) + 1e-5 * np.eye(n)
    return np.linalg.cholesky(K).astype(np.float32), y.astype(np.float32)


def _port_laplace(L0, y, kv, var, fused=False, **kw):
    yt = torch.tensor(y)
    spec = ("student_t", {"y": yt, "var": var, "df": 3.0}) if fused else None
    return tlap.laplace_whitened(
        lambda f: tdens.student_t(yt, f, var, 3.0), torch.tensor(L0) * torch.sqrt(kv),
        fused=spec, **kw,
    )


def test_laplace_whitened_matches_jax():
    """n = 12 Student-t: mode, evidence and marginals rtol 1e-4, and the
    IFT gradients in k_var and the scale rtol 1e-4. grad_norm, the
    residual |grad psi| at the mode (~1e-5 here), is float32 noise in both
    packages: both must be below 1e-3. (The fused spec's unbatched path is
    this same generic loop: test_fused_changes_nothing_unbatched_or_under_vmap.)"""
    L0, y = _one_problem(12, seed=6, outliers=2)

    def jres(kv, var):
        ll = lambda f: jdens.student_t(jnp.asarray(y), f, var, 3.0)
        return jax_laplace(ll, jnp.asarray(L0) * jnp.sqrt(kv))

    kv0, var0 = np.array([1.3], np.float32), np.array([0.2], np.float32)
    (_, want), gwant = jax.jit(jax.value_and_grad(
        lambda a, b: (jres(a, b).log_marginal, jres(a, b)), argnums=(0, 1), has_aux=True
    ))(jnp.asarray(kv0), jnp.asarray(var0))
    kv = torch.tensor(kv0, requires_grad=True)
    var = torch.tensor(var0, requires_grad=True)
    got = _port_laplace(L0, y, kv, var)
    for name in ("v_mode", "f_mode", "f_var", "log_marginal"):
        np.testing.assert_allclose(getattr(got, name).detach().numpy(),
                                   np.asarray(getattr(want, name)), rtol=1e-4, atol=1e-5,
                                   err_msg=name)
    assert float(want.grad_norm) < 1e-3 and got.grad_norm.item() < 1e-3
    gk, gv = torch.autograd.grad(got.log_marginal, (kv, var))
    np.testing.assert_allclose(gk.numpy(), np.asarray(gwant[0]), rtol=1e-4)
    np.testing.assert_allclose(gv.numpy(), np.asarray(gwant[1]), rtol=1e-4)


def test_ift_gradient_matches_unrolled_loop():
    """As test_laplace.py: at a converged mode (30 iterations) the IFT
    gradient agrees with reverse mode through the unrolled loop (rel 1e-3),
    and the values are the same."""
    L0, y = _one_problem(24, seed=7, outliers=2)
    kv = torch.tensor([1.0], requires_grad=True)
    var = torch.tensor([0.3], requires_grad=True)
    ift = _port_laplace(L0, y, kv, var, newton_iters=30)
    unrolled = _port_laplace(L0, y, kv, var, newton_iters=30, implicit_diff=False)
    assert ift.grad_norm.item() < 1e-3
    assert ift.log_marginal.item() == unrolled.log_marginal.item()
    gi = torch.autograd.grad(ift.log_marginal, (kv, var))
    gu = torch.autograd.grad(unrolled.log_marginal, (kv, var))
    for a, b in zip(gi, gu):
        assert (a - b).abs().max().item() / b.abs().max().item() < 1e-3


def test_fused_changes_nothing_unbatched_or_under_vmap():
    """Unbatched, fused= runs the same generic loop: values and gradients
    rtol 1e-6. Under vmap the fused forward is K3's plain version (closed
    forms) and the unfused one the vmapped generic loop: the evidence
    agrees to rtol 1e-5 and the gradients to rtol 1e-4 (v* differs at
    float32 resolution, and the IFT gradient is first order in v*)."""
    L0, y = _one_problem(12, seed=3, outliers=1)

    def ev(kv, var, fused):
        return _port_laplace(L0, y, kv, var, fused=fused).log_marginal

    kv = torch.tensor([1.3], requires_grad=True)
    var = torch.tensor([0.2], requires_grad=True)
    e0, e1 = ev(kv, var, False), ev(kv, var, True)
    assert e0.item() == pytest.approx(e1.item(), rel=1e-6)
    for a, b in zip(torch.autograd.grad(e0, (kv, var)), torch.autograd.grad(e1, (kv, var))):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6)

    kvs = torch.tensor([[1.0], [1.5], [2.0]], requires_grad=True)
    vs = torch.tensor([[0.15], [0.2], [0.3]], requires_grad=True)
    ef = torch.func.vmap(lambda a, b: ev(a, b, True))(kvs, vs)
    eg = torch.func.vmap(lambda a, b: ev(a, b, False))(kvs, vs)
    np.testing.assert_allclose(ef.detach().numpy(), eg.detach().numpy(), rtol=1e-5)
    for a, b in zip(torch.autograd.grad(ef.sum(), (kvs, vs)), torch.autograd.grad(eg.sum(), (kvs, vs))):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4)


def test_batched_fused_forward_dispatch(monkeypatch):
    """Under vmap a fused call reaches the K3 wrapper once for the whole
    batch (its plain version on the CPU), under a nested vmap once for
    both batch axes; float64 goes to the generic loop."""
    calls = []
    real = cuda_newton.newton_mode_vbatched
    monkeypatch.setattr(cuda_newton, "newton_mode_vbatched",
                        lambda *a, **k: calls.append(a[0].shape) or real(*a, **k))
    L0, y = _one_problem(8, seed=1, outliers=0)
    kvs = torch.tensor([[1.0], [2.0]])
    with torch.no_grad():
        torch.func.vmap(lambda a: _port_laplace(L0, y, a, torch.tensor([0.2]), fused=True))(kvs)
        assert calls == [(2, 8, 8)]
        nested = torch.func.vmap(torch.func.vmap(
            lambda a: _port_laplace(L0, y, a, torch.tensor([0.2]), fused=True).log_marginal
        ))(kvs[None].expand(3, 2, 1))
        assert calls == [(2, 8, 8), (6, 8, 8)] and nested.shape == (3, 2)
        calls.clear()
        Lk = torch.tensor(L0, dtype=torch.float64)[None].expand(2, 8, 8)
        v = tlap.FusedNewtonMode.apply(Lk, torch.tensor(y, dtype=torch.float64)[None].expand(2, 8, 1),
                                       torch.ones(2, 1, dtype=torch.float64), "student_t", 3.0, 15,
                                       1e-6)
    assert calls == [] and v.shape == (2, 8, 1) and v.dtype == torch.float64


def test_fused_student_t_spec_without_df_raises():
    """The JAX package takes a missing df as 0 (lgamma(0): no density);
    the port refuses the spec."""
    L0, y = _one_problem(6, seed=0, outliers=0)
    yt = torch.tensor(y)
    var = torch.tensor([0.2])
    with pytest.raises(ValueError, match="df"):
        tlap.laplace_whitened(lambda f: tdens.student_t(yt, f, var, 3.0), torch.tensor(L0),
                              fused=("student_t", {"y": yt, "var": var}))
    with pytest.raises(ValueError, match="unsupported"):
        tlap.laplace_whitened(lambda f: tdens.student_t(yt, f, var, 3.0), torch.tensor(L0),
                              fused=("poisson", {"y": yt}))


# ------------------------------------------------------------ model fleets
def _toy(n, seed, outliers):
    """benchmarks/laplace_bench.py's data."""
    rng = np.random.default_rng(seed)
    X = np.sort(rng.uniform(0, 6, n)).astype(np.float32)[:, None]
    y = np.sin(X) + rng.normal(size=X.shape).astype(np.float32) * 0.3
    idx = rng.choice(n, outliers, replace=False)
    y[idx] += rng.choice([-3.0, 3.0], outliers)[:, None]
    return X.astype(np.float32), y.astype(np.float32)


def _gpc_data(n, seed):
    """test_gpc.py's data."""
    rng = np.random.default_rng(seed)
    X = np.sort(rng.uniform(-3, 3, n)).astype(np.float32)[:, None]
    p_true = 1.0 / (1.0 + np.exp(-3.0 * np.sin(X)))
    return X, (rng.uniform(size=X.shape) < p_true).astype(np.float32)


def _fleets(kind):
    jms, tms = [], []
    for i in range(M):
        if kind == "student":
            X, Y = _toy(10, seed=i, outliers=2)
            jms.append(jmodels.GPR(seed=i, X=X, Y=Y))
            tms.append(thb.models.GPR(seed=i, X=X, Y=Y, device="cpu"))
        else:
            X, Y = _gpc_data(10, seed=i)
            jms.append(jmodels.GPC(seed=i, X=X, Y=Y))
            tms.append(thb.models.GPC(seed=i, X=X, Y=Y, device="cpu"))
    method = "log_marginal_laplace_student" if kind == "student" else "log_marginal_laplace"
    lr = 0.02 if kind == "student" else 0.05
    jopt = JaxBatched(jms, method).compile(optax.adam(lr))
    for tm, p in zip(tms, params_from_jax(jopt._trainable, stacked=True)):
        tm.set_param_dict(p)
    return jopt, thb.BatchedOptimizer(tms, method).compile(learning_rate=lr), lr


def _jax_value_and_grad_fn(jopt):
    """JAX's fleet objective and gradient at trainable weights t. The data
    and frozen weights enter the jitted function as arguments: closed over
    as constants, JAX's own fused-Newton trace leaks a batch tracer."""
    key = jax.random.PRNGKey(0)
    fn = jax.jit(lambda t, fr, d: jax.value_and_grad(
        lambda tt: jopt._evaluate(tt, fr, d, None, key))(t))
    frozen, data = jopt._frozen, jopt._data_args()
    return lambda t: fn(t, frozen, data)


@pytest.mark.parametrize("kind", ["student", "gpc"])
def test_fleet_value_grad_and_adam_steps_match_jax(kind):
    """A 3-model fleet: the summed evidence and every model's gradients
    (rtol 1e-4, atol 1e-4 of the leaf's largest entry), then 5 Adam steps
    against 5 optax steps (objectives rtol 1e-4, parameters rtol 1e-4 /
    atol 1e-5). GPR's q gets no gradient on this objective: torch's Adam
    skips it and optax applies a zero update, so it stays put in both."""
    jopt, topt, lr = _fleets(kind)
    vg = _jax_value_and_grad_fn(jopt)
    val_j, g_j = vg(jopt._trainable)
    val_t, _ = topt._evaluate_core_aux(topt._trainable, topt._frozen, topt._data_args(),
                                       topt.model.generator, None)
    val_t.backward()
    np.testing.assert_allclose(val_t.item(), float(val_j), rtol=1e-4)
    assert set(g_j) == set(topt._trainable)
    for k, want in g_j.items():
        want = np.asarray(want)
        got = topt._trainable[k].grad
        if np.all(want == 0):  # q: no gradient at all in the port
            assert got is None, k
            continue
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max(), err_msg=k)

    tx = optax.adam(lr)
    t, objs = jopt._trainable, []
    state = tx.init(t)
    for _ in range(5):
        val, g = vg(t)
        upd, state = tx.update(jax.tree_util.tree_map(lambda a: -a, g), state, t)
        t = optax.apply_updates(t, upd)
        objs.append(float(val))
    before = {k: v.detach().clone() for k, v in topt._trainable.items()}
    topt.optimize(maxiter=5)
    np.testing.assert_allclose(topt.history[-1], objs, rtol=1e-4)
    for k, want in t.items():
        np.testing.assert_allclose(topt._trainable[k].detach().numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
        if k.startswith("q."):
            assert torch.equal(topt._trainable[k].detach(), before[k])
            np.testing.assert_array_equal(np.asarray(want), np.asarray(jopt._trainable[k]))


def test_gpc_predict_p_matches_jax():
    """predict_p (Laplace marginals, then 20-point Gauss-Hermite of the
    sigmoid) at the same weights: rtol 1e-4."""
    X, Y = _gpc_data(12, seed=2)
    jm = jmodels.GPC(seed=0, X=X, Y=Y)
    tm = thb.models.GPC(seed=0, X=X, Y=Y, device="cpu")
    jm.initialize()
    tm.initialize()
    tm.set_param_dict(params_from_jax(jm.param_dict()))
    grid = np.linspace(-3, 3, 7, dtype=np.float32)[:, None]
    want = np.asarray(jm.run(lambda mm: mm.predict_p(grid)))
    got = tm.run(lambda mm: mm.predict_p(grid)).numpy()
    assert got.shape == (7, 1)
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_gpr_predict_f_laplace_matches_jax():
    """predict_f_laplace (the Student-t Laplace mode, then
    laplace_latent_marginals) at the same weights: rtol 1e-4."""
    X, Y = _toy(12, seed=5, outliers=2)
    jm = jmodels.GPR(seed=0, X=X, Y=Y)
    tm = thb.models.GPR(seed=0, X=X, Y=Y, device="cpu")
    jm.initialize()
    tm.initialize()
    tm.set_param_dict(params_from_jax(jm.param_dict()))
    grid = np.linspace(0, 6, 7, dtype=np.float32)[:, None]
    want = jax.jit(lambda g: jm.run(lambda mm: mm.predict_f_laplace(g)))(grid)
    got = tm.run(lambda mm: mm.predict_f_laplace(grid))
    for name, g, w in zip(("mean", "var"), got, want):
        assert g.shape == (7, 1)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, err_msg=name)


def _projected_problem(shape):
    """(loglik tag, A [n, m], y [n, 1], A* [n*, m], corr_diag [n*]):
    ``square``, the n = 12 Student-t GPR with A = Lk and A*, corr_diag the
    exact projection of 5 new inputs; ``rectangular``, n = 12, m = 4
    Bernoulli with Gaussian projections (0.4 N(0, 1)) and a positive
    residual variance."""
    rng = np.random.default_rng(8)
    if shape == "square":
        L0, y = _one_problem(12, seed=8, outliers=2)
        X = np.sort(np.random.default_rng(8).uniform(0, 6, 12))[:, None]
        xs = np.linspace(0, 6, 5)[:, None]
        Ks = np.exp(-0.5 * (X - xs.T) ** 2 / 0.8**2)
        As = np.linalg.solve(L0.astype(np.float64), Ks)  # [n, n*]
        corr = 1.0 - np.sum(As * As, axis=0)
        return "student_t", L0, y, As.T.astype(np.float32), corr.astype(np.float32)
    A = (rng.standard_normal((12, 4)) * 0.4).astype(np.float32)
    y = (rng.standard_normal((12, 1)) > 0).astype(np.float32)
    Astar = (rng.standard_normal((5, 4)) * 0.4).astype(np.float32)
    corr = rng.uniform(0.05, 0.5, 5).astype(np.float32)
    return "bernoulli_logit", A, y, Astar, corr


@pytest.mark.parametrize("shape", ["square", "rectangular"])
def test_laplace_projected_marginals_matches_jax(shape):
    """laplace_whitened then laplace_projected_marginals in both packages
    on the same inputs: mean and variance rtol 1e-4."""
    from henbun_tpu.inference.laplace import laplace_projected_marginals as jax_proj

    tag, A, y, Astar, corr = _projected_problem(shape)
    if tag == "student_t":
        jll = lambda f: jdens.student_t(jnp.asarray(y), f, 0.2, 3.0)
        tll = lambda f: tdens.student_t(torch.tensor(y), f, 0.2, 3.0)
    else:
        jll = _jax_bernoulli(jnp.asarray(y))
        tll = lambda f: tdens.bernoulli_logit(torch.tensor(y), f)
    want = jax.jit(lambda a, s, c: jax_proj(jll, a, jax_laplace(jll, a), s, c))(A, Astar, corr)
    tA = torch.tensor(A)
    with torch.no_grad():
        got = tlap.laplace_projected_marginals(
            tll, tA, tlap.laplace_whitened(tll, tA), torch.tensor(Astar), torch.tensor(corr)
        )
    for name, g, w in zip(("mean", "var"), got, want):
        assert g.shape == (5, 1)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, err_msg=name)


def test_bernoulli_logit_density_matches_jax_inline_likelihood():
    """densities.bernoulli_logit against the JAX package's inline
    y log_sigmoid(f) + (1 - y) log_sigmoid(-f), large |f| included: rtol
    1e-6."""
    rng = np.random.default_rng(9)
    y = (rng.uniform(size=(8, 1)) > 0.5).astype(np.float32)
    f = np.concatenate([rng.normal(size=(6, 1)) * 3, [[40.0], [-40.0]]]).astype(np.float32)
    want = np.asarray(_jax_bernoulli(jnp.asarray(y))(jnp.asarray(f)))
    got = tdens.bernoulli_logit(torch.tensor(y), torch.tensor(f))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_predict_f_laplace_is_the_projected_marginals_of_its_factor():
    """GPR.predict_f_laplace (laplace_latent_marginals, square Lk) equals
    laplace_projected_marginals with the projection A* = (Lk^-1 K(X, x*))^T
    and the residual prior variance k** - colnorm(Lk^-1 K(X, x*))^2, the
    same posterior written the inducing-point way (rtol 1e-4: the
    projected form adds the scale-aware floor to B). GPC.predict_p holds
    laplace_latent_marginals against JAX."""
    X, Y = _toy(10, seed=4, outliers=2)
    tm = thb.models.GPR(seed=0, X=X, Y=Y, device="cpu")
    grid = torch.linspace(0, 6, 5)[:, None]

    def both(mm):
        Lk = mm._laplace_Lk()
        res = tlap.laplace_whitened(mm._student_loglik(), Lk)
        A = thb.ops.tri_solve(Lk, mm.kern.K(mm.X, grid) * mm.k_var)
        corr = mm.kern.Kdiag(grid) * mm.k_var[0] - torch.sum(A * A, dim=0)
        proj = tlap.laplace_projected_marginals(mm._student_loglik(), Lk, res, A.mT, corr)
        return mm.predict_f_laplace(grid), proj

    got, want = tm.run(both)
    for g, w in zip(got, want):
        assert g.shape == (5, 1) and torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4, atol=1e-6)


def test_gauss_hermite_expectation_matches_jax():
    rng = np.random.default_rng(0)
    mean = rng.normal(size=(5,)).astype(np.float32)
    var = rng.uniform(0.1, 2.0, size=(5,)).astype(np.float32)
    y = rng.normal(size=(5,)).astype(np.float32)
    want = np.asarray(jax_gh(lambda f: jdens.student_t(jnp.asarray(y)[:, None], f, 0.5, 3.0),
                             jnp.asarray(mean), jnp.asarray(var)))
    got = torch_gh(lambda f: tdens.student_t(torch.tensor(y)[:, None], f, 0.5, 3.0),
                   torch.tensor(mean), torch.tensor(var))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
