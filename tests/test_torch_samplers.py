"""henbun_tpu_torch's samplers (inference/logprob, hmc, chees, nuts, smc,
diagnostics, api) against the JAX package on the CPU.

Deterministic parts are held to the JAX package on the same inputs, with
the draws the JAX samplers make taken from JAX and injected (torch cannot
reproduce threefry streams):

* diagnostics on the same numpy samples (1e-6);
* ``make_log_prob`` on ``BNN`` and ``SparseGPC`` (n = 100, m = 8): value
  and gradient of one theta and of a batch through
  ``batched_value_and_grad``, Jacobians on and off, a collection subset,
  ``minibatch_index`` (rtol 1e-4 of the value, 1e-4 of the largest
  gradient entry; z's gradient 1e-3, with a float64 witness: float32
  holds neither package to 1e-4 there);
* the leapfrog integrator, dual-averaging sequences, one HMC transition
  with JAX's momentum and uniform, ChEES's Halton points and step rule,
  NUTS's U-turn test, popcount, trailing ones and checkpoint slots,
  systematic resampling with JAX's uniform and the tempering bisection
  (1e-5).

The chaotic parts (accept/reject paths) are held in distribution: each
sampler's moments on a correlated Gaussian within the JAX tests' Monte
Carlo error, SMC's log-evidence against the analytic one, and
``sample_posterior`` on a small ``SparseGPC``.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from henbun_tpu import models as jmodels
from henbun_tpu.inference import chees as jchees
from henbun_tpu.inference import diagnostics as jdiag
from henbun_tpu.inference import hmc as jhmc
from henbun_tpu.inference import logprob as jlogprob
from henbun_tpu.inference import nuts as jnuts
from henbun_tpu.inference import smc as jsmc
import henbun_tpu_torch as thb
from henbun_tpu_torch.inference import chees, diagnostics, hmc, logprob, nuts, smc
from henbun_tpu_torch.inference.api import sample_posterior
from henbun_tpu_torch.interop import params_from_jax

COV = np.array([[1.0, 0.7], [0.7, 2.0]])
PREC = np.linalg.inv(COV)


def _close(got, want, what, rtol=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rtol * max(np.abs(want).max(), 1e-6), err_msg=what)


def _gauss_lp():
    prec = torch.tensor(PREC, dtype=torch.float32)
    return lambda t: -0.5 * t @ prec @ t


def _banana_pair():
    """A non-quadratic target in both packages."""
    def jlp(t):
        return -0.5 * (t[0] ** 2 + (t[1] - 0.5 * t[0] ** 2) ** 2) - 0.05 * jnp.sum(t[2:] ** 4)

    def tlp(t):
        return -0.5 * (t[0] ** 2 + (t[1] - 0.5 * t[0] ** 2) ** 2) - 0.05 * torch.sum(t[2:] ** 4)

    return jlp, tlp


# ---------------------------------------------------------------- diagnostics
def test_diagnostics_equal_the_jax_packages():
    rng = np.random.default_rng(0)
    x = np.cumsum(rng.standard_normal((200, 4, 3)), axis=0) * 0.05 + rng.standard_normal(
        (200, 4, 3))
    acc = rng.uniform(size=(200, 4))
    acc[3, 1] = 0.0
    for name in ("ess_bulk", "split_rhat", "effective_sample_size"):
        _close(getattr(diagnostics, name)(x), getattr(jdiag, name)(x), name, rtol=1e-6)
    got, want = diagnostics.summarize(x, acc), jdiag.summarize(x, acc)
    assert got.keys() == want.keys() and got["divergences"] == want["divergences"] == 1
    for k in want:
        _close(got[k], want[k], k, rtol=1e-6)


# ---------------------------------------------------------------- log-prob
def _bnn_pair():
    X, Y = jmodels.make_bnn_dataset(n=32)
    jm = jmodels.BNN(seed=0, X=X, Y=Y, hidden=4)
    tm = thb.models.BNN(seed=0, X=X, Y=Y, hidden=4, device="cpu")
    jm.initialize()
    tm.set_param_dict(params_from_jax(jm.param_dict()))
    return jm, tm


def _sparse_gpc_pair():
    rng = np.random.default_rng(0)
    X = np.sort(rng.uniform(0, 6, (100, 1))).astype(np.float32)
    p_true = 1.0 / (1.0 + np.exp(-3.0 * np.sin(X)))
    Y = (rng.uniform(size=X.shape) < p_true).astype(np.float32)
    jm = jmodels.SparseGPC(seed=0, X=X, Y=Y, num_inducing=8)
    tm = thb.models.SparseGPC(seed=0, X=X, Y=Y, num_inducing=8, device="cpu")
    jm.initialize()
    tm.set_param_dict(params_from_jax(jm.param_dict()))
    return jm, tm


@pytest.mark.parametrize("case", [
    ("bnn", None, True, None), ("bnn", None, False, None), ("bnn", None, True, "rows"),
    ("sparse_gpc", "variables", True, None), ("sparse_gpc", "variables", False, None),
    ("sparse_gpc", "inducing_z", True, None),
], ids=["bnn", "bnn-nojac", "bnn-minibatch", "sgpc", "sgpc-nojac", "sgpc-z-only"])
def test_make_log_prob_matches_jax(case):
    kind, collection, jac, rows = case
    jm, tm = _bnn_pair() if kind == "bnn" else _sparse_gpc_pair()
    idx = np.arange(0, 32, 3) if rows else None
    jf = jlogprob.make_log_prob(jm, "log_posterior", collection, jac, minibatch_index=idx)
    tf = logprob.make_log_prob(tm, "log_posterior", collection, jac, minibatch_index=idx)
    assert tf.paths == jf.paths and tf.dim == jf.dim
    assert [tuple(s) for s in tf.shapes] == [tuple(s) for s in jf.shapes]
    _close(tf.initial.numpy(), jf.initial, "initial")
    rng = np.random.default_rng(1)
    thetas = (np.asarray(jf.initial)[None]
              + 0.1 * rng.standard_normal((3, jf.dim))).astype(np.float32)
    jv, jg = jax.jit(jax.vmap(jax.value_and_grad(jf.log_prob)))(thetas)
    tv, tg = logprob.batched_value_and_grad(tf.log_prob)(torch.tensor(thetas))
    _close(tv.numpy(), jv, "batched value")
    # z's gradient: float32 holds neither package to 1e-4 of the leaf (both
    # 2.4e-4 to 7.1e-4 from a float64 port evaluation), so both are held to
    # float64 at 1e-3 and to each other at 1e-3
    gtol = 1e-3 if collection == "inducing_z" else 1e-4
    g64 = _float64_batched_grad(tm, collection, jac, thetas) if collection == "inducing_z" else None
    for c in range(3):
        _close(tg[c].numpy(), jg[c], "gradient of chain %d" % c, rtol=gtol)
        if g64 is not None:
            _close(tg[c].numpy(), g64[c], "port gradient from float64", rtol=gtol)
            _close(jg[c], g64[c], "JAX gradient from float64", rtol=gtol)
    _close(float(tf.log_prob(torch.tensor(thetas[0]))), float(jv[0]), "one theta")
    # unravel / ravel round trip and the write-back
    back = tf.ravel(tf.unravel(torch.tensor(thetas[1])))
    assert torch.equal(back, torch.tensor(thetas[1]))
    tf.set_model_state(torch.tensor(thetas[2]))
    _close(tf.ravel(tm.param_dict(collection)).numpy(), thetas[2], "set_model_state")


def _float64_batched_grad(tm, collection, jac, thetas):
    """The port's SparseGPC log_posterior gradients at `thetas`, in float64."""
    cfg = thb.settings.get_settings()
    cfg.dtypes.float_type = torch.float64
    with thb.settings.temp_settings(cfg):
        m64 = thb.models.SparseGPC(seed=0, X=tm.x.value, Y=tm.y.value, num_inducing=8,
                                   device="cpu")
        m64.set_param_dict({k: v.double() for k, v in tm.param_dict().items()})
        f64 = logprob.make_log_prob(m64, "log_posterior", collection, jac)
        return logprob.batched_value_and_grad(f64.log_prob)(
            torch.tensor(thetas, dtype=torch.float64))[1].numpy()


def test_make_log_prob_refuses_an_empty_collection():
    _, tm = _bnn_pair()
    with pytest.raises(ValueError, match="no variables"):
        logprob.make_log_prob(tm, "log_posterior", "nope")


def test_cpu_evaluation_runs_eagerly_and_leaves_the_graph_undecided():
    """On a CPU theta the batched evaluation runs the eager function (no
    capture, no replay), and the graph decision waits for a CUDA theta."""
    _, tlp = _banana_pair()
    vg = logprob.batched_value_and_grad(tlp)
    theta = torch.tensor(np.random.default_rng(1).standard_normal((4, 5)).astype(np.float32))
    replays = logprob.CudaGraphed.replays
    for a, b in zip(vg(theta), vg.fn(theta)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert vg.graphed is None and not vg.graphs
    assert logprob.CudaGraphed.replays == replays


# ------------------------------------------------------ HMC's deterministic parts
def test_leapfrog_matches_jax():
    jlp, tlp = _banana_pair()
    rng = np.random.default_rng(2)
    theta = rng.standard_normal((4, 5)).astype(np.float32)
    mom = rng.standard_normal((4, 5)).astype(np.float32)
    inv_mass = rng.uniform(0.5, 2.0, (4, 5)).astype(np.float32)
    eps = np.float32(0.15)
    jt, jr = jax.jit(jax.vmap(lambda t, r, im: jhmc._leapfrog(
        jax.grad(jlp), t, r, eps, im, 7)))(theta, mom, inv_mass)
    vg = logprob.batched_value_and_grad(tlp)
    _, g0 = vg(torch.tensor(theta))
    tt, tr, tlpv, _ = hmc._leapfrog(vg, torch.tensor(theta), torch.tensor(mom), g0,
                                    torch.tensor(eps), torch.tensor(inv_mass), 7)
    _close(tt.numpy(), jt, "theta", rtol=1e-5)
    _close(tr.numpy(), jr, "momentum", rtol=1e-5)
    _close(tlpv.numpy(), jax.vmap(jlp)(jt), "end log density", rtol=1e-5)


def test_dual_averaging_sequence_matches_jax():
    acc = np.random.default_rng(3).uniform(size=(60, 5)).astype(np.float32)
    js = jhmc._da_init(jnp.full((5,), 0.1))
    ts = hmc._da_init(torch.full((5,), 0.1))
    for a in acc:
        js = jhmc._da_update(js, jnp.asarray(a), target=0.8)
        ts = hmc._da_update(ts, torch.tensor(a), target=0.8)
        for name in ("log_eps", "log_eps_bar", "h_bar", "count"):
            _close(getattr(ts, name).numpy(), getattr(js, name), name, rtol=1e-5)


@pytest.mark.parametrize("eps0", [0.3, 1.6], ids=["accepting", "rejecting"])
def test_one_hmc_transition_with_the_jax_draws(eps0):
    """jax hmc.sample with one sampling iteration and no warmup, against the
    port's transition fed the momentum and uniform that run drew."""
    jlp, tlp = _banana_pair()
    C, dim, L = 6, 5, 9
    init = np.random.default_rng(4).standard_normal((C, dim)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    res = jhmc.sample(jlp, init, key, num_samples=1, num_warmup=0, num_leapfrog=L,
                      initial_step_size=eps0, jitter_steps=False, adapt_mass=False)
    # the keys of hmc.sample's run -> sample_step -> kernel
    _, k_samp = jax.random.split(key)
    k_it, _ = jax.random.split(jax.random.split(k_samp, 1)[0])
    keys = jax.random.split(k_it, C)
    z = np.stack([np.asarray(jax.random.normal(jax.random.split(k)[0], (dim,))) for k in keys])
    u = np.array([float(jax.random.uniform(jax.random.split(k)[1])) for k in keys], np.float32)
    vg = logprob.batched_value_and_grad(tlp)
    theta0 = torch.tensor(init)
    logp0, g0 = vg(theta0)
    eps = torch.exp(hmc._da_init(torch.full((C,), eps0)).log_eps_bar)
    theta, logp, _, accept_prob = hmc._transition(
        vg, theta0, logp0, g0, torch.tensor(z), torch.tensor(u), eps,
        torch.ones((C, dim)), L)
    _close(accept_prob.numpy(), res.accept_prob[0], "accept_prob", rtol=1e-5)
    _close(theta.numpy(), res.samples[0], "theta", rtol=1e-5)
    _close(logp.numpy(), res.final_logp, "logp", rtol=1e-5)
    moved = (np.abs(np.asarray(res.samples[0]) - init).max(-1) > 0)
    assert moved.any() if eps0 < 1 else (~moved).any()


def test_chees_halton_and_step_rule_match_jax():
    its = list(range(300))
    _close([chees._halton(i) for i in its],
           [float(jchees._halton(jnp.asarray(i))) for i in its], "halton", rtol=0)

    @jax.jit
    def jax_steps(traj, eps, it):
        return jnp.clip(jnp.ceil(jchees._halton(it) * traj / eps).astype(jnp.int32), 1, 256)

    for traj, eps in ((1.0, 0.1), (3.7, 0.031), (900.0, 0.9), (0.01, 2.0)):
        t32, e32 = np.float32(traj), np.float32(eps)
        got = [int(chees._steps_from(torch.tensor(t32), torch.tensor(e32), i, 256)) for i in its]
        want = [int(jax_steps(t32, e32, jnp.asarray(i))) for i in its]
        assert got == want, (traj, eps)


def test_chees_needs_two_chains():
    with pytest.raises(ValueError, match="at least 2 chains"):
        chees.sample(_gauss_lp(), torch.zeros(1, 2), 0, num_samples=1, num_warmup=1)


# ---------------------------------------------------- NUTS's deterministic parts
def test_nuts_bit_helpers_and_u_turn_match_jax():
    for i in range(2**9):
        assert nuts._popcount(i) == int(jnuts._popcount(jnp.asarray(i)))
        assert nuts._trailing_ones(i) == int(jnuts._trailing_ones(jnp.asarray(i)))
    rng = np.random.default_rng(5)
    a = [rng.standard_normal((64, 3)).astype(np.float32) for _ in range(4)]
    im = rng.uniform(0.5, 2.0, (64, 3)).astype(np.float32)
    want = np.asarray(jax.vmap(jnuts._is_turning)(*a, im))
    got = nuts._is_turning(*[torch.tensor(x) for x in a], torch.tensor(im)).numpy()
    assert 0 < want.sum() < 64 and np.array_equal(got, want)


def test_nuts_checkpoint_slots_give_the_recursive_trees_pairs():
    """With the port's popcount and trailing ones: the pairs the iterative
    scheme checks at odd leaves are exactly the (leftmost, rightmost) leaf
    pairs of every internal node of the recursive doubling tree, and each
    pair's left leaf is still in its slot when the check reads it."""

    def recursive_pairs(lo, hi):
        if lo == hi:
            return set()
        mid = (lo + hi) // 2
        return {(lo, hi)} | recursive_pairs(lo, mid) | recursive_pairs(mid + 1, hi)

    for d in range(1, 9):
        slots, pairs = {}, set()
        for i in range(2**d):
            pc = nuts._popcount(i)
            if i % 2 == 0:
                slots[pc] = i
            else:
                for k in range(1, nuts._trailing_ones(i) + 1):
                    assert slots[pc - k] == i - 2**k + 1, (d, i, k)
                    pairs.add((slots[pc - k], i))
        assert pairs == recursive_pairs(0, 2**d - 1), d


# ----------------------------------------------------- SMC's deterministic parts
def test_systematic_resample_matches_jax_with_its_uniform():
    rng = np.random.default_rng(6)
    log_w = (3.0 * rng.standard_normal(1000)).astype(np.float32)
    particles = rng.standard_normal((1000, 2)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jax.jit(jsmc.systematic_resample)(key, log_w, particles))
    u0 = torch.tensor(float(jax.random.uniform(key)))
    got = smc.systematic_resample(None, torch.tensor(log_w), torch.tensor(particles), u0=u0)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("beta", [0.0, 0.35, 0.97])
def test_find_next_beta_matches_jax(beta):
    log_lik = (-50.0 * np.random.default_rng(7).uniform(size=4096)).astype(np.float32)
    want = float(jax.jit(jsmc._find_next_beta, static_argnums=(2,))(
        jnp.float32(beta), log_lik, 0.5))
    got = float(smc._find_next_beta(torch.tensor(beta), torch.tensor(log_lik), 0.5))
    assert abs(got - want) <= 1e-5 * max(abs(want), 1e-3), (got, want)


# ------------------------------------------------------------ in distribution
@pytest.mark.parametrize("name", ["hmc", "chees", "nuts"])
def test_sampler_recovers_a_correlated_gaussian(name):
    """The JAX tests' gates (test_hmc.py, test_chees.py, test_nuts_smc.py):
    means within 0.15 (ChEES 0.12), covariances within 0.35 (ChEES 0.3),
    accept rate in their ranges."""
    mod = {"hmc": hmc, "chees": chees, "nuts": nuts}[name]
    chains, warm = (16, 500) if name == "chees" else (8, 300)
    init = torch.randn((chains, 2), generator=torch.Generator().manual_seed(0))
    res = mod.sample(_gauss_lp(), init, 1, num_samples=500, num_warmup=warm)
    x = res.samples.reshape(-1, 2).numpy()
    mean_tol, cov_tol = (0.12, 0.3) if name == "chees" else (0.15, 0.35)
    assert np.allclose(x.mean(0), 0.0, atol=mean_tol), x.mean(0)
    assert np.allclose(np.cov(x.T), COV, atol=cov_tol), np.cov(x.T)
    acc = float(res.accept_prob.mean())
    assert (0.5 < acc < 0.95) if name == "chees" else acc > (0.6 if name == "nuts" else 0.5)
    assert torch.isfinite(res.step_size).all() and torch.isfinite(res.final_logp).all()
    if name == "nuts":
        assert res.num_steps.shape == (500, chains) and int(res.num_steps.min()) >= 1


def test_smc_gaussian_posterior_and_evidence():
    """test_nuts_smc.py's conjugate model: prior N(0, 1), 20 observations of
    N(mu, 1); posterior moments and log-evidence against the analytic
    values (its gates: 0.1, 0.05, 1.5 nats)."""
    rng = np.random.default_rng(0)
    n_obs = 20
    y = rng.normal(1.5, 1.0, size=n_obs).astype(np.float32)
    post_var = 1.0 / (1 + n_obs)
    post_mean = post_var * y.sum()
    marg_cov = np.ones((n_obs, n_obs)) + np.eye(n_obs)
    log_Z = (-0.5 * n_obs * np.log(2 * np.pi) - 0.5 * np.linalg.slogdet(marg_cov)[1]
             - 0.5 * y @ np.linalg.solve(marg_cov, y))
    yt = torch.tensor(y)
    c = float(0.5 * np.log(2 * np.pi))

    def log_prior(t):
        return -0.5 * torch.sum(t**2) - c

    def log_lik(t):
        return torch.sum(-0.5 * (yt - t[0]) ** 2 - c)

    particles = torch.randn((2048, 1), generator=torch.Generator().manual_seed(0))
    res = smc.sample(log_prior, log_lik, particles, 1, num_move_steps=3, step_size=0.2)
    x = res.particles[:, 0].numpy()
    assert abs(x.mean() - post_mean) < 0.1
    assert abs(x.var() - post_var) < 0.05
    assert abs(float(res.log_evidence) - log_Z) < 1.5
    assert float(res.final_beta) > 0.999 and res.num_stages >= 1


def test_sample_posterior_on_a_sparse_gpc():
    """Paths, shapes and diagnostics of sample_posterior over SparseGPC's
    log_posterior (n = 100, m = 8): the default collection samples k_var and
    the lengthscale and leaves the frozen z alone."""
    _, tm = _sparse_gpc_pair()
    z0 = tm.gp.z.value.copy()
    res, post, diag = sample_posterior(tm, "log_posterior", num_chains=4, num_samples=12,
                                       num_warmup=12, return_diagnostics=True)
    assert set(post) == {"k_var", "gp.kern.lengthscales"}
    for v in post.values():
        assert v.shape == (12, 4, 1) and np.isfinite(v).all() and (v > 0).all()
    assert res.samples.shape == (12, 4, 2) and torch.isfinite(res.samples).all()
    for k in ("ess_bulk_min", "rhat_max", "accept_mean", "divergences"):
        assert k in diag
    assert np.array_equal(tm.gp.z.value, z0)


def test_bad_sampler_and_a_mesh_raise():
    _, tm = _bnn_pair()
    with pytest.raises(ValueError, match="sampler must be one of"):
        sample_posterior(tm, "log_posterior", sampler="mala")
    # a mesh is a DeviceMesh (parallel.make_mesh); anything else raises
    with pytest.raises(TypeError, match="DeviceMesh"):
        sample_posterior(tm, "log_posterior", mesh=object())
    init = torch.zeros((2, 2))
    for mod in (hmc, chees, nuts):
        with pytest.raises(TypeError, match="DeviceMesh"):
            mod.sample(_gauss_lp(), init, 0, num_samples=1, num_warmup=1, mesh=object())
    with pytest.raises(TypeError, match="DeviceMesh"):
        smc.sample(_gauss_lp(), _gauss_lp(), init, 0, mesh=object())
