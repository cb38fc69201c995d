"""One rank of the multi-process cases of ``tests/test_torch_parallel.py``.

    python tests/test_torch_parallel_ranks.py <rank> <world_size> <directory>

The ranks meet through a ``FileStore`` in <directory> (gloo, CPU tensors),
read the shared inputs from <directory>/inputs.npz (written by the test),
run every case below on a mesh of the world, and write their results to
<directory>/rank<r>.pt. This file imports no JAX: the test compares the
results with the JAX package and with the one-process port.
"""
import contextlib
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import henbun_tpu_torch as thb  # noqa: E402
from henbun_tpu_torch.inference import chees, hmc, nuts, smc  # noqa: E402
from henbun_tpu_torch.inference.ep import ep_gp_projected  # noqa: E402
from henbun_tpu_torch.parallel import (  # noqa: E402
    ShardedBatchedOptimizer, ShardedOptimizer, chains, initialize_distributed, make_mesh,
    row_sharded, rows, sharding)

STEPS = 5
TWIN_STEPS = 20
# the row-sharded evidence cases: (name, family, objective, rows)
EVIDENCE = (("gpc_laplace", "gpc", "log_marginal_laplace", 200),
            ("gpc_ep", "gpc", "log_marginal_ep", 200),
            ("robust_laplace", "robust", "log_marginal_laplace", 200),
            ("gpc_laplace_201", "gpc", "log_marginal_laplace", 201),
            ("multiclass_laplace", "multiclass", "log_marginal_laplace", 200),
            ("multiclass_laplace_201", "multiclass", "log_marginal_laplace", 201))
M_IND = 12
CLASSES = 3
# each evidence family's constructor arguments beyond the data
FAMILY_KW = {"gpc": {}, "robust": {}, "multiclass": {"num_classes": CLASSES}}
# tests/test_parallel.py's SVGP families: (name, objective)
SVGP_FAMILIES = (("multiclass", "ELBO"), ("count", "ELBO_analytic"),
                 ("hetero", "ELBO_analytic"), ("multioutput", "ELBO_analytic"))
FAMILY_ROWS = 8  # minibatch rows a rank
SMC_MOVES = (2, 4)
PREC = np.array([[2.0, 0.3, 0.0], [0.3, 1.0, 0.2], [0.0, 0.2, 0.5]], np.float32)


class LinReg(thb.Model):
    def setUp(self):
        self.x = thb.MinibatchData(np.zeros((8, 3), np.float32))
        self.y = thb.MinibatchData(np.zeros((8, 1), np.float32))
        self.w = thb.Variable([3, 1], stddev=0.1)

    @thb.AutoOptimize()
    def obj(self):
        return -torch.sum(torch.square(self.y - torch.matmul(self.x, self.w)))


class MeanModel(thb.Model):
    """tests/test_parallel.py's _MeanModel: p converges to the column
    means of its minibatched rows."""

    def setUp(self, data):
        self.x = thb.MinibatchData(data)
        self.p = thb.Variable([2])

    @thb.AutoOptimize()
    def obj(self):
        return -torch.sum(torch.square(self.x - self.p))


class Bad(thb.Model):
    """An objective that is NaN everywhere (tests/test_parallel.py)."""

    def setUp(self):
        self.p = thb.Variable([2])

    @thb.AutoOptimize()
    def bad(self):
        return torch.log(-torch.ones(()) - torch.sum(torch.square(self.p)))


class FewSweeps(thb.models.SparseGPC):
    """The projected EP evidence after 3 sweeps, far from converged, so
    that its reported ep_delta is a mean of large site changes."""

    @thb.AutoOptimize()
    @row_sharded
    def ep_few(self):
        return ep_gp_projected(self._loglik(), self._A(self.x), sweeps=3,
                               delta_tol=1e9).log_marginal


def evidence_model(inp, family, n, cls=None):
    """The sparse evidence model at n rows with the JAX package's weights,
    in the current float type."""
    X, Y = inp["se_%s_%d_X" % (family, n)], inp["se_%s_%d_Y" % (family, n)]
    prefix = "se_p:%s_%d:" % (family, n)
    cls = cls or {"gpc": thb.models.SparseGPC, "robust": thb.models.SparseGPRobust,
                  "multiclass": thb.models.SparseGPMulticlass}[family]
    m = cls(seed=0, X=X, Y=Y, num_inducing=M_IND, device="cpu", **FAMILY_KW[family])
    dtype = thb.settings.dtypes.float_type
    m.set_param_dict({k[len(prefix):]: torch.tensor(inp[k]).to(dtype) for k in inp
                      if k.startswith(prefix)})
    return m


def float64():
    """Settings under which models are built and run in float64."""
    cfg = thb.settings.get_settings()
    cfg.dtypes.float_type = torch.float64
    return thb.settings.temp_settings(cfg)


def evidence_step(opt):
    """One step of `opt` with a zero learning rate: the objective, and the
    gradient left in each leaf (of the negated objective, after the
    ShardedOptimizer's reduction), with the row-sum collectives it took."""
    opt.compile(optimizer=lambda params: torch.optim.SGD(params, lr=0.0))
    rows.reset_stats()
    opt.optimize(maxiter=1)
    grads = {k: t.grad.detach().numpy().copy() for k, t in opt._trainable.items()}
    return {"value": float(opt.history[-1][0]), "grads": grads, "stats": dict(rows.stats),
            "metrics": dict(opt.metrics.rows[-1])}


@contextlib.contextmanager
def cholesky_flags():
    """Records, for every factorization that safe_cholesky's ladder reads
    back, whether its factor has a NaN (the flag the host reads), in
    order: a list, filled while inside."""
    from henbun_tpu_torch.ops import linalg

    flags, real = [], linalg._cholesky_dispatch

    def recording(A):
        L = real(A)
        flags.append(bool(torch.isnan(L).any()))
        return L

    linalg._cholesky_dispatch = recording
    try:
        yield flags
    finally:
        linalg._cholesky_dispatch = real


def collective_stats():
    """The three counters of the port's collectives, as plain dicts."""
    return {"sharding": dict(sharding.stats), "rows": dict(rows.stats),
            "chains": {k: (dict(v) if isinstance(v, dict) else v)
                       for k, v in chains.stats.items()}}


def reset_collective_stats():
    sharding.reset_stats()
    rows.reset_stats()
    chains.reset_stats()


def gauss_lp():
    prec = torch.tensor(PREC)
    return lambda t: -0.5 * t @ prec @ t


def lik_lp():
    return lambda t: -0.5 * torch.sum((t - 1.0) ** 2) / 0.3


def params_of(model):
    return {k: v.detach().numpy().copy() for k, v in model.param_dict().items()}


def mesh_sizes(inp, rank, world):
    out = {"default": tuple(make_mesh(device_type="cpu").shape),
           "chain": tuple(make_mesh(n_data=1, n_chain=world, device_type="cpu").shape)}
    try:
        make_mesh(n_data=world + 1, n_chain=1, device_type="cpu")
        out["uncovered"] = "no error"
    except ValueError as err:
        out["uncovered"] = str(err)
    return out


def gpr_fullbatch(inp, rank, world):
    """Full-batch GPR.ELBO_gaussian, the JAX package's draws injected."""
    thb.set_seed(0)
    tm = thb.models.GPR(seed=0, X=inp["gpr_X"], Y=inp["gpr_Y"], device="cpu")
    tm.set_param_dict({k[6:]: torch.tensor(inp[k]) for k in inp if k.startswith("gpr_p:")})
    opt = ShardedOptimizer(tm, "ELBO_gaussian", mesh=make_mesh(device_type="cpu")).compile(learning_rate=0.01)
    noise = inp["gpr_noise"]
    opt.noise_source = lambda s: {"q": torch.tensor(noise[s])}
    opt.optimize(maxiter=STEPS)
    return {"hist": opt.history[-1], "params": params_of(tm)}


def amortized(inp, rank, world):
    """Minibatch amortized SVI, this rank's rows and noise injected."""
    thb.set_seed(0)
    m = thb.models.AmortizedRegression(seed=0, X=inp["am_X"], Y=inp["am_Y"], d_z=2,
                                       hidden=8, device="cpu")
    opt = ShardedOptimizer(m, "ELBO", mesh=make_mesh(device_type="cpu")).compile(learning_rate=0.01)
    pos, noise = inp["am_pos"][rank], inp["am_noise"]
    k = pos.shape[1]
    opt.row_source = lambda s: pos[s]
    opt.noise_source = lambda s: {"z": torch.tensor(noise[s, rank * k:(rank + 1) * k])}
    opt.optimize(maxiter=STEPS, minibatch_size=world * k)
    local_n = len(m._index._train_index) // world
    rows = m._index._train_index[rank * local_n + pos[:STEPS]]
    return {"hist": opt.history[-1], "params": params_of(m), "rows": rows}


def amortized_noise_drawn(inp, rank, world):
    """Minibatch amortized SVI, this rank's rows injected and the noise
    drawn from the model's generator."""
    thb.set_seed(0)
    m = thb.models.AmortizedRegression(seed=0, X=inp["am_X"], Y=inp["am_Y"], d_z=2,
                                       hidden=8, device="cpu")
    opt = ShardedOptimizer(m, "ELBO", mesh=make_mesh(device_type="cpu")).compile(learning_rate=0.01)
    pos = inp["am_pos"][rank]
    opt.row_source = lambda s: pos[s]
    opt.optimize(maxiter=STEPS, minibatch_size=world * pos.shape[1])
    return {"hist": opt.history[-1], "params": params_of(m)}


def amortized_drawn(inp, rank, world):
    """Rows drawn by each rank from its own shard, both modes, and the
    noise drawn: the generator's state before the steps, to replay them."""
    out = {}
    for mode in ("random", "block"):
        thb.set_seed(0)
        m = thb.models.AmortizedRegression(seed=0, X=inp["am_X"], Y=inp["am_Y"], d_z=2,
                                           hidden=8, device="cpu")
        opt = ShardedOptimizer(m, "ELBO", mesh=make_mesh(device_type="cpu")).compile(learning_rate=0.01)
        state = m.generator.get_state()
        opt.optimize(maxiter=STEPS, minibatch_size=2 * world, minibatch_mode=mode)
        out[mode] = {"hist": opt.history[-1], "params": params_of(m), "state": state,
                     "train_index": np.asarray(m._index._train_index)}
    try:
        opt.optimize(maxiter=1, minibatch_size=2 * world + 1)
        out["indivisible"] = "no error"
    except ValueError as err:
        out["indivisible"] = str(err)
    return out


def fleet(inp, rank, world):
    """ShardedBatchedOptimizer over the chain dimension, noise injected."""
    thb.set_seed(0)
    models = [thb.models.GPR(seed=i, X=inp["fleet_X"][i], Y=inp["fleet_Y"][i], device="cpu")
              for i in range(len(inp["fleet_X"]))]
    bo = ShardedBatchedOptimizer(models, "ELBO_gaussian",
                                 mesh=make_mesh(n_data=1, n_chain=world, device_type="cpu"))
    bo.compile(learning_rate=0.01)
    k = len(bo.models)
    noise = inp["fleet_noise"]
    bo.noise_source = lambda s: {"q": torch.tensor(noise[s, rank * k:(rank + 1) * k])}
    bo.optimize(maxiter=STEPS)
    try:
        ShardedBatchedOptimizer(models[:world + 1], "ELBO_gaussian",
                                mesh=make_mesh(n_data=1, n_chain=world, device_type="cpu"))
        uneven = "no error"
    except ValueError as err:
        uneven = str(err)
    return {"hist": bo.history[-1], "params": [params_of(m) for m in bo.all_models],
            "local": k, "uneven": uneven}


def fleet_drawn(inp, rank, world):
    """ShardedBatchedOptimizer with the noise drawn: a full-batch GPR fleet
    and a minibatch amortized fleet with the rows drawn too."""
    thb.set_seed(0)
    gprs = [thb.models.GPR(seed=i, X=inp["fleet_X"][i], Y=inp["fleet_Y"][i], device="cpu")
            for i in range(len(inp["fleet_X"]))]
    mesh = make_mesh(n_data=1, n_chain=world, device_type="cpu")
    bo = ShardedBatchedOptimizer(gprs, "ELBO_gaussian", mesh=mesh).compile(learning_rate=0.01)
    bo.optimize(maxiter=STEPS)
    thb.set_seed(0)
    ams = [thb.models.AmortizedRegression(seed=i, X=inp["am_fleet_X"][i],
                                          Y=inp["am_fleet_Y"][i], d_z=2, hidden=8, device="cpu")
           for i in range(len(inp["am_fleet_X"]))]
    ba = ShardedBatchedOptimizer(ams, "ELBO", mesh=mesh).compile(learning_rate=0.01)
    ba.optimize(maxiter=STEPS, minibatch_size=4)
    return {"gpr": bo.history[-1], "gpr_params": [params_of(m) for m in bo.all_models],
            "amortized": ba.history[-1], "amortized_params": [params_of(m) for m in ba.all_models]}


def samplers(inp, rank, world):
    """Each sampler with the chains (particles) split over chain."""
    mesh = make_mesh(n_data=1, n_chain=world, device_type="cpu")
    init = torch.tensor(inp["chains_init"])
    out = {}
    for name, mod, kw in (("hmc", hmc, dict(num_leapfrog=4)), ("chees", chees, {}),
                          ("nuts", nuts, dict(max_tree_depth=4))):
        res = mod.sample(gauss_lp(), init, 0, num_samples=10, num_warmup=25, mesh=mesh, **kw)
        out[name] = {k: np.asarray(v) for k, v in res._asdict().items()}
    res = smc.sample(gauss_lp(), lik_lp(), torch.tensor(inp["particles"]), 0,
                     num_move_steps=2, num_leapfrog=3, mesh=mesh)
    out["smc"] = {k: np.asarray(v) for k, v in res._asdict().items()}
    return out


def streaming(inp, rank, world):
    """Out-of-core megabatches into a ShardedOptimizer: every rank reads
    the same megabatches (one loader seed) and trains on its shard."""
    from henbun_tpu_torch.io import OutOfCoreLoader, optimize_streaming

    thb.set_seed(0)
    m = LinReg(seed=0, device="cpu")
    opt = ShardedOptimizer(m, "obj", mesh=make_mesh(device_type="cpu")).compile(learning_rate=0.05)
    path = str(inp["stream_path"])
    n, row_floats = int(inp["stream_n"]), int(inp["stream_row_floats"])
    slices = [tuple(s) for s in inp["stream_slices"]]
    with OutOfCoreLoader(path, n, row_floats, batch_rows=512, seed=5) as dl:
        optimize_streaming(opt, dl, slices, maxiter=1500, minibatch_size=64)
    return {"w": m.w.value[:, 0].copy(), "train_size": m._index.train_size}


def sparse_evidence(inp, rank, world):
    """The row-sharded evidence: each case's objective and gradient at the
    JAX package's weights, and 5 Adam steps."""
    out = {}
    for name, family, method, n in EVIDENCE:
        opt = ShardedOptimizer(evidence_model(inp, family, n), method, mesh=make_mesh(device_type="cpu"))
        got = evidence_step(opt)
        got["block"] = opt._row_block
        with float64():
            got["float64"] = evidence_step(ShardedOptimizer(evidence_model(inp, family, n), method,
                                                            mesh=make_mesh(device_type="cpu")))
        m = evidence_model(inp, family, n)
        opt = ShardedOptimizer(m, method, mesh=make_mesh(device_type="cpu")).compile(learning_rate=0.05)
        opt.optimize(maxiter=STEPS)
        got.update(hist=opt.history[-1], params=params_of(m),
                   ep_delta=[r.get("ep_delta") for r in opt.metrics.rows])
        out[name] = got
    return out


def evidence_collectives(inp, rank, world):
    """The row sums' all-reduces a step at 200 and at 400 rows (SparseGPC,
    and SparseGPMulticlass with safe_cholesky's flags), the few-sweep EP's
    ep_delta, SparseGPRobust's unrolled EP in float64 at
    201 rows, and a full-batch objective that has not opted in (it runs
    whole on every rank: no row block, no row collective)."""
    out = {}
    for n in (200, 400):
        got = evidence_step(ShardedOptimizer(evidence_model(inp, "gpc", n), "log_marginal_laplace",
                                             mesh=make_mesh(device_type="cpu")))
        out[n] = got["stats"]
        with cholesky_flags() as flags:
            got = evidence_step(ShardedOptimizer(evidence_model(inp, "multiclass", n),
                                                 "log_marginal_laplace",
                                                 mesh=make_mesh(device_type="cpu")))
        out["multiclass", n] = {"stats": got["stats"], "flags": flags}
    opt = ShardedOptimizer(evidence_model(inp, "gpc", 200, FewSweeps), "ep_few", mesh=make_mesh(device_type="cpu"))
    out["ep_few"] = evidence_step(opt)
    with float64():
        out["robust_ep"] = evidence_step(ShardedOptimizer(
            evidence_model(inp, "robust", 201), "log_marginal_ep", mesh=make_mesh(device_type="cpu")))
    thb.set_seed(0)
    m = MeanModel(seed=0, data=inp["mean_data"], device="cpu")
    opt = ShardedOptimizer(m, "obj", mesh=make_mesh(device_type="cpu")).compile(learning_rate=0.05)
    rows.reset_stats()
    opt.optimize(maxiter=STEPS)
    out["not_opted_in"] = {"block": opt._row_block, "stats": dict(rows.stats),
                           "hist": opt.history[-1]}
    return out


def nan_guard(inp, rank, world):
    """tests/test_parallel.py::test_sharded_nan_guard_rollback."""
    m = Bad(seed=0, device="cpu")
    opt = ShardedOptimizer(m, "bad", mesh=make_mesh(device_type="cpu")).compile(learning_rate=0.01)
    before = params_of(m)
    try:
        opt.optimize(maxiter=10)
        raised = "no error"
    except FloatingPointError as err:
        raised = str(err)
    return {"raised": raised, "before": before, "after": params_of(m)}


def save_restore(inp, rank, world):
    """tests/test_parallel.py::test_sharded_save_restore_bitwise at 64 rows,
    minibatch 8, 10 + 10 steps: every rank continues, and restores rank 0's
    file into a fresh ShardedOptimizer."""
    path = str(inp["state_path"])

    def fresh():
        thb.set_seed(0)
        m = MeanModel(seed=0, data=inp["mean_data"], device="cpu")
        return m, ShardedOptimizer(m, "obj", mesh=make_mesh(device_type="cpu")).compile(learning_rate=0.05)

    m1, o1 = fresh()
    o1.optimize(maxiter=TWIN_STEPS // 2, minibatch_size=8)
    o1.save_state(path)
    o1.optimize(maxiter=TWIN_STEPS // 2, minibatch_size=8)
    m2, o2 = fresh()
    o2.restore_state(path)
    step = o2.global_step
    o2.optimize(maxiter=TWIN_STEPS // 2, minibatch_size=8)
    return {"continued": params_of(m1), "restored": params_of(m2), "step": step}


def natgrad_gpr(inp, rank, world):
    """tests/test_parallel.py::test_sharded_natgrad_gpr at n = 24, 20
    steps: the full-batch GPR ELBO under natural_gradient(0.01,
    rest=Adam(0.02)), the noise drawn from the shared seed."""
    from henbun_tpu_torch import optimizers

    thb.set_seed(0)
    X, Y = thb.models.make_sine_dataset(n=24)
    m = thb.models.GPR(seed=0, X=X, Y=Y, q_shape="fullrank", device="cpu")
    m.q.analytic_kl = True
    opt = ShardedOptimizer(m, "ELBO_gaussian", mesh=make_mesh(device_type="cpu"))
    opt.compile(optimizers.natural_gradient(m, gamma=0.01, rest=thb.adam(0.02)))
    opt.optimize(maxiter=TWIN_STEPS)
    return {"hist": opt.history[-1], "params": params_of(m)}


def svgp(inp, rank, world):
    """tests/test_parallel.py::test_sharded_svgp at n = 128, m = 8,
    minibatch 16 (8 rows a rank), 20 steps, this rank's rows injected and
    the noise drawn."""
    thb.set_seed(0)
    m = thb.models.SVGPRegression(seed=0, X=inp["svgp_X"], Y=inp["svgp_Y"], num_inducing=8,
                                  device="cpu")
    opt = ShardedOptimizer(m, "ELBO", mesh=make_mesh(device_type="cpu")).compile(learning_rate=0.01)
    pos = inp["svgp_pos"][rank]
    opt.row_source = lambda s: pos[s]
    opt.optimize(maxiter=TWIN_STEPS, minibatch_size=world * pos.shape[1])
    local_n = len(m._index._train_index) // world
    return {"hist": opt.history[-1], "params": params_of(m),
            "rows": m._index._train_index[rank * local_n + pos[:TWIN_STEPS]]}


def family_model(inp, family):
    """tests/test_parallel.py's SVGP family `family` at tens of rows,
    m = 8, built from the fixture's data."""
    thb.set_seed(0)
    X = inp["fam_X"]
    if family == "multiclass":
        return thb.models.SVGPMulticlass(seed=1, X=X, Y=inp["fam_labels"], num_classes=CLASSES,
                                         num_inducing=8, device="cpu")
    if family == "count":
        return thb.models.SVGPCount(seed=1, X=X, Y=inp["fam_counts"], num_inducing=8,
                                    device="cpu")
    if family == "hetero":
        return thb.models.HeteroSVGP(seed=0, X=inp["hetero_X"], Y=inp["hetero_Y"],
                                     num_inducing=8, device="cpu")
    return thb.models.MultiOutputSVGP(seed=0, X=inp["mo_X"], Y=inp["mo_Y"], Q=2, num_inducing=8,
                                      device="cpu")


def svgp_families(inp, rank, world):
    """tests/test_parallel.py::test_sharded_multiclass_and_count and
    ::test_sharded_hetero_and_lmc_svgp at tens of rows: each family's
    minibatch objective, Adam 0.02, minibatch 16 (8 rows a rank),
    TWIN_STEPS steps, this rank's rows injected and the noise drawn, in
    float32 and in float64; the collectives of the steps."""
    out = {}
    pos = inp["fam_pos"][rank]
    for family, method in SVGP_FAMILIES:
        runs = []
        for dtype in ("float32", "float64"):
            with float64() if dtype == "float64" else contextlib.nullcontext():
                m = family_model(inp, family)
                opt = ShardedOptimizer(m, method, mesh=make_mesh(device_type="cpu"))
                opt.compile(learning_rate=0.02)
                opt.row_source = lambda s: pos[s]
                reset_collective_stats()
                opt.optimize(maxiter=TWIN_STEPS, minibatch_size=world * FAMILY_ROWS)
            runs.append({"hist": opt.history[-1], "params": params_of(m),
                         "stats": collective_stats()})
        local_n = len(m._index._train_index) // world
        out[family] = dict(runs[0], float64=runs[1],
                           floats=sum(t.numel() for t in opt._trainable.values()),
                           rows=m._index._train_index[rank * local_n + pos[:TWIN_STEPS]])
    return out


def chunk_collectives(inp, rank, world):
    """tests/test_parallel.py::test_sharded_chunk_hlo_collectives: 10
    minibatch steps (64 rows) of the _MeanModel, rows drawn; the
    collectives of the steps."""
    thb.set_seed(0)
    m = MeanModel(seed=0, data=inp["mean_data"], device="cpu")
    opt = ShardedOptimizer(m, "obj", mesh=make_mesh(device_type="cpu")).compile(learning_rate=0.05)
    reset_collective_stats()
    opt.optimize(maxiter=10, minibatch_size=64)
    return {"stats": collective_stats(), "floats": sum(t.numel() for t in opt._trainable.values())}


def smc_collectives(inp, rank, world):
    """tests/test_parallel.py::test_smc_resampling_hlo_collectives: SMC
    with the particles split over chain, at SMC_MOVES moves a stage; the
    collectives of each run and its stages."""
    mesh = make_mesh(n_data=1, n_chain=world, device_type="cpu")
    out = {}
    for moves in SMC_MOVES:
        reset_collective_stats()
        res = smc.sample(gauss_lp(), lik_lp(), torch.tensor(inp["particles"]), 0,
                         num_move_steps=moves, num_leapfrog=3, mesh=mesh)
        out[moves] = {"stats": collective_stats(), "stages": int(res.num_stages)}
    return out


CASES = (mesh_sizes, gpr_fullbatch, amortized, amortized_noise_drawn, amortized_drawn, fleet,
         fleet_drawn, samplers, streaming, sparse_evidence, evidence_collectives, nan_guard,
         save_restore, natgrad_gpr, svgp, svgp_families, chunk_collectives, smc_collectives)


def main(rank, world, directory):
    torch.set_num_threads(1)
    initialize_distributed("file://" + os.path.join(directory, "store"), world, rank,
                           backend="gloo")
    inp = dict(np.load(os.path.join(directory, "inputs.npz"), allow_pickle=False))
    out = {case.__name__: case(inp, rank, world) for case in CASES}
    torch.save(out, os.path.join(directory, "rank%d.pt" % rank))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
