"""henbun_tpu_torch elementwise modules (densities, transforms, priors) and
the variational KL estimators against the JAX package on the CPU: the
same numpy inputs through both, float32, rtol 1e-5 / atol 1e-5 unless a
test states otherwise."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from henbun_tpu import densities as jd, priors as jp, transforms as jt
import henbun_tpu_torch as thb
from henbun_tpu_torch import densities as td, priors as tp, transforms as tt

RNG = np.random.default_rng(0)


def _pos(*shape):
    return RNG.uniform(0.5, 2.0, size=shape).astype(np.float32)


def _real(*shape):
    return RNG.normal(size=shape).astype(np.float32)


def _unit(*shape):
    return RNG.uniform(0.05, 0.95, size=shape).astype(np.float32)


DENSITY_ARGS = {
    "gaussian": lambda: (_real(5), _real(5), _pos(5)),
    "lognormal": lambda: (_pos(5), _real(5), _pos(5)),
    "bernoulli": lambda: (_unit(5), (RNG.uniform(size=5) > 0.5).astype(np.float32)),
    "poisson": lambda: (_pos(5), RNG.integers(0, 5, size=5).astype(np.float32)),
    "exponential": lambda: (_pos(5), _pos(5)),
    "gamma": lambda: (_pos(5), _pos(5), _pos(5)),
    "student_t": lambda: (_real(5), _real(5), _pos(5), 3.0),
    "beta": lambda: (_pos(5), _pos(5), _unit(5)),
    "laplace": lambda: (_real(5), _pos(5), _real(5)),
    "bimixture": lambda: (_unit(5), _real(5), _real(5)),
}


def _close(got, want, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(
        np.asarray(got.detach() if isinstance(got, torch.Tensor) else got),
        np.asarray(want), rtol=rtol, atol=atol,
    )


@pytest.mark.parametrize("name", sorted(DENSITY_ARGS))
def test_density_matches_jax(name):
    args = DENSITY_ARGS[name]()
    targs = [torch.tensor(a) if isinstance(a, np.ndarray) else a for a in args]
    jargs = [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]
    _close(getattr(td, name)(*targs), getattr(jd, name)(*jargs))


def test_multivariate_normal_matches_jax():
    A = _real(4, 4)
    L = np.linalg.cholesky(A @ A.T + 4 * np.eye(4)).astype(np.float32)
    x, mu = _real(4, 2), _real(4, 2)
    _close(
        td.multivariate_normal(torch.tensor(x), torch.tensor(mu), torch.tensor(L)),
        jd.multivariate_normal(jnp.asarray(x), jnp.asarray(mu), jnp.asarray(L)),
        rtol=1e-5, atol=1e-4,
    )


TRANSFORMS = {
    "Identity": (lambda m: m.Identity(), _real),
    "Exp": (lambda m: m.Exp(), _real),
    "Log1pe": (lambda m: m.Log1pe(), _real),
    "Logistic": (lambda m: m.Logistic(-1.0, 2.0), _real),
    "Scale": (lambda m: m.Scale(0.3), _real),
    "LowerTriangular": (lambda m: m.LowerTriangular(3), _real),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_matches_jax(name):
    make, draw = TRANSFORMS[name]
    t, j = make(tt), make(jt)
    x = draw(6)
    _close(t.tf_forward(torch.tensor(x)), j.tf_forward(jnp.asarray(x)))
    _close(torch.sum(t.tf_log_jacobian(torch.tensor(x))), jnp.sum(j.tf_log_jacobian(jnp.asarray(x))))
    _close(np.asarray(t.forward(x)), np.asarray(j.forward(x)))
    y = np.asarray(j.forward(x))
    _close(np.asarray(t.backward(y)), np.asarray(j.backward(y)), atol=1e-4)


PRIORS = {
    "Normal": lambda m: m.Normal(),
    "Gaussian": lambda m: m.Gaussian(0.5, 2.0),
    "LogNormal": lambda m: m.LogNormal(0.1, 0.5),
    "Gamma": lambda m: m.Gamma(2.0, 1.5),
    "Laplace": lambda m: m.Laplace(0.0, 1.0),
    "Uniform": lambda m: m.Uniform(0.0, 3.0),
}


@pytest.mark.parametrize("name", sorted(PRIORS))
def test_prior_logp_matches_jax(name):
    x = _pos(7)
    _close(PRIORS[name](tp).logp(torch.tensor(x)), PRIORS[name](jp).logp(jnp.asarray(x)))


@pytest.mark.parametrize("q_shape", ["diagonal", "fullrank", "fullrank_packed"])
@pytest.mark.parametrize("analytic_kl", [False, True])
def test_gaussian_variational_sample_and_kl_match_jax(q_shape, analytic_kl):
    """One Gaussian q node in each form: the sample and the KL under the
    same weights and injected noise (rtol 1e-5, atol 1e-5)."""
    import henbun_tpu as jhb

    def build(hb, **kw):
        class Q(hb.model.Model):
            def setUp(self):
                self.q = hb.variationals.Gaussian(
                    shape=[4], q_shape=q_shape, analytic_kl=analytic_kl
                )

        return Q(seed=0, **kw)

    jm, tm = build(jhb), build(thb, device="cpu")
    jm.initialize()
    tm.set_param_dict(thb.interop.params_from_jax(jm.param_dict()))
    u = _real(4)
    from henbun_tpu.core import context as jctx

    # the JAX side takes u through its sample cache: the state a draw with
    # noise u would have left there
    with jctx.trace(jm, jm.param_dict(), {}, None) as ctx:
        node = jm.__dict__["q"]
        raw = node._sample(jnp.asarray(u))
        ctx.samples["q"] = {"u": jnp.asarray(u), "raw": raw,
                            "transformed": node.transform.tf_forward(raw)}
        j_sample, j_kl = jm.q, jm.KL()
    t_sample, t_kl = tm.run(lambda m: (m.q, m.KL()), noise={"q": torch.tensor(u)})
    assert tuple(t_sample.shape) == j_sample.shape
    _close(t_sample, j_sample)
    _close(t_kl, j_kl)
