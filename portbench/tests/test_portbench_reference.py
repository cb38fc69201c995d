"""The float64 references against the port itself run in float64 on the
CPU at a tiny size: the same objective and gradient from the same free
values, data and injected noise, and the same predictions. The references
share no code with the port; this holds their equations to its."""
import numpy as np
import pytest
import torch

from portbench import data
from portbench.reference import gpr_exact, gpr_n40

import henbun_tpu_torch as hb
from henbun_tpu_torch import models

REL = 1e-10


@pytest.fixture
def float64():
    cfg = hb.settings.get_settings()
    cfg.dtypes.float_type = torch.float64
    with hb.settings.temp_settings(cfg):
        yield


def _inputs(cfg, models_, n, seed):
    g = torch.Generator().manual_seed(seed)
    X, Y = data.regression_data(cfg["data"], models_, n, g, torch.device("cpu"))
    return X.double(), Y.double(), g


def _port_value_and_grad(opt, noise=None):
    data_ = opt._data_args()
    val, _ = opt._evaluate_core_aux(opt._trainable, opt._frozen, data_, opt.model.generator,
                                    noise)
    val.backward()
    return float(val.detach()), {k: t.grad.detach().clone() for k, t in opt._trainable.items()}


def _close(a, b, rel=REL):
    scale = max(float(torch.max(torch.abs(b))), 1e-300)
    return float(torch.max(torch.abs(a - b))) <= rel * scale


def test_elbo_and_gradient_with_injected_noise(float64):
    from portbench import spec

    cfg = spec.Cell("gpr_n40.fleet8192").config
    X, Y, g = _inputs(cfg, 1, 40, 3)
    m = models.GPR(seed=0, X=X[0].numpy(), Y=Y[0].numpy(), device="cpu")
    shapes = {k: tuple(v.shape) for k, v in m.param_dict().items()}
    init = {k: v.double() for k, v in data.free_values(cfg["init"], shapes, 1, g,
                                                      torch.device("cpu")).items()}
    m.set_param_dict({k: v[0] for k, v in init.items()})
    opt = m.ELBO_gaussian().compile(hb.adam(0.01))
    u = torch.randn(40, generator=g, dtype=torch.float64)
    val, grad = _port_value_and_grad(opt, {"q": u})

    p = {k: v.clone().requires_grad_(True) for k, v in init.items()}
    ref = gpr_n40.objective(p, {"X": X, "Y": Y}, {"q": u[None]})
    rgrad = torch.autograd.grad(ref.sum(), [p[k] for k in sorted(p)])
    assert abs(val - float(ref[0])) <= REL * abs(float(ref[0]))
    for k, gk in zip(sorted(p), rgrad):
        assert _close(grad[k], gk[0]), k


def test_exact_evidence_and_predictions(float64):
    from portbench import spec

    cfg = spec.Cell("gpr_exact.n16384").config
    X, Y, g = _inputs(cfg, 1, 50, 4)
    m = models.GPRMarginal(seed=0, X=X[0].numpy(), Y=Y[0].numpy(), device="cpu")
    shapes = {k: tuple(v.shape) for k, v in m.param_dict().items()}
    init = {k: v[0].double() for k, v in data.free_values(cfg["init"], shapes, 1, g,
                                                         torch.device("cpu")).items()}
    m.set_param_dict(dict(init))
    opt = m.log_marginal().compile(hb.adam(0.01))
    val, grad = _port_value_and_grad(opt)

    d = {"X": X[0], "Y": Y[0]}
    p = {k: v.clone().requires_grad_(True) for k, v in init.items()}
    ref = gpr_exact.objective(p, d)
    rgrad = torch.autograd.grad(ref, [p[k] for k in sorted(p)])
    assert abs(val - float(ref)) <= REL * abs(float(ref))
    for k, gk in zip(sorted(p), rgrad):
        assert _close(grad[k], gk), k

    x = torch.linspace(-0.5, 6.5, 33, dtype=torch.float64)[:, None]
    mean, var = m.run(lambda mm: mm.predict_f(x.numpy()))
    rmean, rvar = gpr_exact.Predictor(init, d)(x)
    assert _close(mean, rmean) and _close(var, rvar, 1e-8)


def test_tf32_rounding():
    from portbench.reference.common import tf32

    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10, -(1.0 + 3 * 2 ** -12)])
    assert tf32(x).tolist() == [1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -10, -(1.0 + 2 ** -10)]
    y = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    assert float(torch.max(torch.abs(tf32(y) - y) / torch.abs(y))) <= 2 ** -11
    assert np.all(np.asarray((tf32(y).view(torch.int32) & 0x1FFF) == 0))
