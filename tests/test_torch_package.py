"""henbun_tpu_torch as a package: import hygiene, device placement,
settings, the kernel build's contract, and the training loop's
behaviour (minibatch modes, nan-guard rollback, diagnostics guard) on the
CPU at tiny sizes."""
import ast
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import henbun_tpu_torch as thb
from henbun_tpu_torch.ops import _build

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "henbun_tpu_torch"


def _imported_modules(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize(
    "path",
    sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_no_file_imports_jax_or_the_jax_package(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "optax", "henbun_tpu"), (path, mod)


def test_import_leaves_jax_out_of_sys_modules():
    code = (
        "import sys, henbun_tpu_torch, henbun_tpu_torch.interop; "
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'optax', 'henbun_tpu')]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def _tiny_gpr(**kw):
    X = np.linspace(0, 3, 5, dtype=np.float32)[:, None]
    return thb.models.GPR(X=X, Y=np.sin(X), **kw)


def test_model_without_device_goes_to_cuda_or_raises():
    if torch.cuda.is_available():
        assert _tiny_gpr(seed=0).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _tiny_gpr(seed=0)
    m = _tiny_gpr(seed=0, device="cpu")
    assert m.device == torch.device("cpu")
    assert all(v.device.type == "cpu" for v in m.param_dict().values())


def test_cuda_settings_and_temp_settings_stack():
    s = thb.settings
    assert s.cuda.device == "cuda"
    assert s.cuda.use_kernels is True
    assert s.cuda.matmul_precision == "highest"
    assert isinstance(s.cuda.scan_chunk, int)
    assert s.dtypes.float_type is torch.float32
    cfg = s.get_settings()
    cfg.cuda.scan_chunk = 7
    with s.temp_settings(cfg):
        assert s.cuda.scan_chunk == 7
        inner = s.get_settings()
        inner.cuda.use_kernels = False
        with s.temp_settings(inner):
            assert s.cuda.use_kernels is False and s.cuda.scan_chunk == 7
        assert s.cuda.use_kernels is True
    assert s.cuda.scan_chunk != 7
    _tiny_gpr(seed=0, device="cpu")
    assert torch.get_float32_matmul_precision() == "highest"
    assert torch.backends.cuda.matmul.allow_tf32 is False


def test_kernel_build_contract():
    assert _build.sources() == ["chol128", "newton128", "trisolve128", "widesolve128"]
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert "--use_fast_math" not in _build.NVCC_FLAGS
    assert _build.BUILD_DIR.endswith(os.path.join("build", "henbun_tpu_torch"))
    have_nvcc = shutil.which("nvcc") or os.path.exists(
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    )
    if not have_nvcc:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.nvcc_path()


def test_phase_trace_marks_the_start_and_every_barrier():
    """The traced copies that utils/phase_trace.py builds on the card: one
    clock64 mark at each kernel's start and end and one after each
    __syncthreads, for every kernel source."""
    from henbun_tpu_torch.utils import phase_trace

    for name in ("chol128", "trisolve128", "newton128", "widesolve128"):
        source = phase_trace.expanded_source(name)
        assert '#include "' not in source  # every csrc header is written in place
        barriers = source.count("__syncthreads();")
        kernels = len(phase_trace._kernel_bodies(source))
        traced = phase_trace.traced_source(name)
        assert barriers >= 3 and kernels >= 1
        assert traced.count("MARK();") == barriers + 2 * kernels
        assert traced.count("g_trace[blockIdx.x") == 1
        assert traced.count("g_mark = 0;") == kernels


def test_kernel_build_key_covers_the_headers(tmp_path):
    """A library's name hashes its source and every csrc header: editing a
    header the sources include gives a new name, so no stale build is
    reused."""
    (tmp_path / "k.cu").write_text('#include "h.cuh"\nint x;\n')
    (tmp_path / "h.cuh").write_text("#pragma once\n")
    first = _build._target("k", csrc=str(tmp_path), build_dir=str(tmp_path))[1]
    assert first == _build._target("k", csrc=str(tmp_path), build_dir=str(tmp_path))[1]
    (tmp_path / "h.cuh").write_text("#pragma once\nconstexpr int kEdited = 1;\n")
    second = _build._target("k", csrc=str(tmp_path), build_dir=str(tmp_path))[1]
    assert second != first and os.path.basename(second).startswith("k-")
    assert _build.headers(str(tmp_path)) == ["h.cuh"]
    assert _build.headers() == ["panel_chol.cuh"]


def test_wide_solve_tile_width_divides_m_and_fills_the_grid():
    """K6's tile width (ops/cuda_wide.tile_cols) divides every m the kernel
    takes, and the grid never has fewer blocks than one a 128-column tile;
    each of the three widths is chosen somewhere."""
    from henbun_tpu_torch.ops import cuda_wide

    widths = set()
    for m in range(cuda_wide.TILE, cuda_wide.MAX_M + 1, cuda_wide.TILE):
        cols = cuda_wide.tile_cols(m)
        widths.add(cols)
        assert cols in cuda_wide.COLS and m % cols == 0
        assert m // cols >= m // cuda_wide.TILE
    assert widths == set(cuda_wide.COLS)
    assert [cuda_wide.tile_cols(m) for m in (128, 256, 3968, 8192)] == [16, 16, 32, 64]


def _profiled_names(fn):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, {e.name for e in prof.events()}


def test_name_scoped_keeps_values_and_gradients_and_names_the_trace():
    """scoping.NameScoped (jax.named_scope's counterpart): the wrapped
    function's result and gradient are unchanged, its name survives, and
    the scope is a range in a CPU torch.profiler trace."""
    from henbun_tpu_torch.scoping import NameScoped

    def f(x):
        return torch.sum(x * x + 2.0 * x)

    g = NameScoped("my.scope")(f)
    assert g.__name__ == "f"
    x = torch.tensor([1.0, -3.0, 0.5], requires_grad=True)
    (out, names) = _profiled_names(lambda: g(x))
    assert out.item() == f(x).item()
    assert torch.equal(torch.autograd.grad(out, x)[0], torch.autograd.grad(f(x), x)[0])
    assert "my.scope" in names


def test_scoped_keys_wrap_in_a_profiled_evaluation():
    """A kernel's scoped keys (K, Kdiag, Cholesky) compute as before
    inside an evaluation, and under the profiler each call is a range
    named by its long_name."""
    m = thb.Model(seed=0, device="cpu")
    m.kern = thb.gp.kernels.UnitRBF()
    m.initialize()
    X = torch.linspace(0, 1, 5)[:, None]
    K, names = _profiled_names(lambda: m.run(lambda mm: mm.kern.K(X)))
    assert torch.allclose(torch.diagonal(K), torch.ones(5), atol=1e-5)
    assert "model.kern.K" in names
    assert torch.equal(K, m.run(lambda mm: mm.kern.K(X)))


def test_params_from_jax_stacked_and_set_param_dict():
    stacked = {"k_var": np.arange(3, dtype=np.float32)[:, None], "var": np.ones((3, 1), np.float32)}
    per_model = thb.interop.params_from_jax(stacked, stacked=True)
    assert len(per_model) == 3
    m = _tiny_gpr(seed=0, device="cpu")
    m.set_param_dict(per_model[2])
    assert m.param_dict()["k_var"].item() == 2.0


class MBMean(thb.Model):
    def setUp(self, data):
        self.x = thb.MinibatchData(data)
        self.p = thb.Variable([2])

    @thb.AutoOptimize()
    def obj(self):
        return -torch.sum(torch.square(self.x - self.p))


@pytest.mark.parametrize("mode", ["random", "block"])
@pytest.mark.parametrize("fleet", [False, True])
def test_minibatch_modes_converge(mode, fleet):
    rng = np.random.default_rng(1)
    targets = np.array([[1.0, -2.0], [0.5, 0.5]], np.float32)
    ms = [
        MBMean(seed=i, device="cpu",
               data=(rng.normal(size=(40, 2)) * 0.1 + targets[i]).astype(np.float32))
        for i in range(2 if fleet else 1)
    ]
    opt = (thb.BatchedOptimizer(ms, "obj") if fleet else ms[0].obj())
    opt.compile(learning_rate=0.05)
    opt.optimize(maxiter=300, minibatch_size=8, minibatch_mode=mode)
    for m, t in zip(ms, targets):
        np.testing.assert_allclose(m.p.value, t, atol=0.1)
    assert np.isfinite(opt.run(minibatch_size=4, training=False))


class Spiky(thb.Model):
    """NaN objective while the counter says so (a stand-in for a divergent
    stochastic step)."""

    def setUp(self):
        self.p = thb.Variable([1])
        self.bad_calls = set()
        self.calls = 0

    @thb.AutoOptimize()
    def obj(self):
        self.calls += 1
        v = -torch.sum(torch.square(self.p - 1.0))
        return v * float("nan") if self.calls in self.bad_calls else v


def test_nan_guard_rolls_back_and_retries():
    m = Spiky(seed=0, device="cpu")
    opt = m.obj().compile(learning_rate=0.1)  # compile evaluates once
    with thb.settings.temp_settings(_chunk(5)):
        m.bad_calls = {4}                         # step 3 of the first chunk
        opt.optimize(maxiter=5)
        assert np.isfinite(opt.history[-1]).all() and m.calls == 11
        before = m.p.value.copy()
        m.bad_calls = {12, 17}                    # fails, and fails again
        with pytest.raises(FloatingPointError, match="twice in a row"):
            opt.optimize(maxiter=5)
        np.testing.assert_array_equal(m.p.value, before)


def _chunk(n):
    cfg = thb.settings.get_settings()
    cfg.cuda.scan_chunk = n
    return cfg


class Reporting(thb.Model):
    def setUp(self):
        self.p = thb.Variable([1])
        self.level = 0.0

    @thb.AutoOptimize()
    def obj(self):
        from henbun_tpu_torch.core import context

        context.current().report_diagnostic(
            "delta", torch.tensor(self.level), guard_tol=0.5, hint=" try more sweeps"
        )
        return -torch.sum(torch.square(self.p))


def test_diagnostics_are_recorded_and_guarded():
    m = Reporting(seed=0, device="cpu")
    opt = m.obj().compile(learning_rate=0.1)
    opt.optimize(maxiter=3)
    assert opt.metrics.rows[-1]["delta"] == 0.0
    m.level = 1.0
    before = m.p.value.copy()
    with pytest.raises(FloatingPointError, match="try more sweeps"):
        opt.optimize(maxiter=3)
    np.testing.assert_array_equal(m.p.value, before)


def test_profiling_writes_a_trace_only_when_enabled(tmp_path):
    opt = _tiny_gpr(seed=0, device="cpu").ELBO_gaussian().compile()
    opt.optimize(maxiter=2)
    assert not list(tmp_path.iterdir())
    cfg = thb.settings.get_settings()
    cfg.profiling.dump_timeline = True
    cfg.profiling.profile_dir = str(tmp_path)
    with thb.settings.temp_settings(cfg):
        opt.optimize(maxiter=2)
    traces = list(tmp_path.glob("optimize-*.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0
    assert [r["step"] for r in opt.metrics.rows] == [2, 4]
