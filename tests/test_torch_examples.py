"""The port's examples (``henbun_tpu_torch/examples``) run end to end on
the CPU at tiny arguments, as tests/test_examples.py runs the JAX
package's; each twin prints the JAX example's labels in the same order,
and the main path's deterministic lines agree with the JAX example's."""
import ast
import contextlib
import importlib
import importlib.util
import io
import pathlib

import numpy as np
import pytest
import torch

from chip_smoke import example_numbers
from henbun_tpu_torch.examples import serving_export

ROOT = pathlib.Path(__file__).parent.parent
JAX_EXAMPLES = ROOT / "examples"
TWINS = ROOT / "henbun_tpu_torch" / "examples"

# tests/test_examples.py's TINY_ARGV. Where the port's eager CPU run needs
# less, only the step counts are cut (tests/test_examples.py's value in the
# comment); every width stays.
TINY_ARGV = {
    "gaussian_process": ["--iters", "400"],
    "expert_gpr": ["--init-iters", "50", "--rounds", "1", "--iters", "30",
                   "--n", "60"],                       # 150, 2 rounds, 100
    "linear_models": ["--map-iters", "300", "--vi-iters", "500"],
    "amortized_svi": ["--n", "4096", "--iters", "50", "--minibatch", "256"],  # 200
    "hmc_bnn": ["--chains", "8", "--samples", "20", "--warmup", "20"],       # 50, 50
    "smc_tomography": ["--grid", "4", "--particles", "512"],
    "gp_classification": ["--n-exact", "40", "--n-svgp", "2048",
                          "--iters", "20"],            # 60
    "svgp_natgrad": ["--n", "2048", "--iters", "50"],  # 150
    "fleet": ["--models", "8", "--n", "24", "--iters", "50"],  # 200
    "heteroscedastic": ["--iters", "100", "--n", "48"],  # 400
    "multioutput": ["--iters", "100", "--n", "40"],      # 500
    "deep_gp": ["--iters", "100", "--n", "120", "--minibatch", "64"],  # 600
    "gplvm": ["--iters", "200", "--n", "300", "--minibatch", "64"],    # 800
    "svgp_likelihoods": ["--n", "2000", "--iters", "100",
                         "--minibatch", "256"],          # 800
    "bayes_hypers_sparse": ["--n", "1500", "--m", "12", "--samples", "20",
                            "--chains", "4"],            # 60
}
NEW_TWINS = sorted(TINY_ARGV)


def _print_labels(path):
    """The string constants of each print() call of a file, in source
    order."""
    calls = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "print":
            consts = tuple(c.value for a in node.args for c in ast.walk(a)
                           if isinstance(c, ast.Constant) and isinstance(c.value, str))
            calls.append((node.lineno, consts))
    return [c for _, c in sorted(calls)]


def _main_output(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


def _jax_output(name):
    spec = importlib.util.spec_from_file_location(name, JAX_EXAMPLES / (name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return _main_output(mod.main, TINY_ARGV[name])


@pytest.fixture(scope="module")
def twin_output():
    """name -> the twin's stdout at its tiny argv on the CPU, each twin run
    once for the module; one torch thread (the twins' steps are small
    operations, which more threads only slow down next to other workers)
    and denormals flushed to zero, as XLA's CPU backend runs the JAX
    examples (with them, the products of a fit whose probabilities
    saturate, svgp_likelihoods' softmax Laplace, run up to 6x slower)."""
    cache, threads = {}, torch.get_num_threads()

    def run(name):
        if name not in cache:
            mod = importlib.import_module("henbun_tpu_torch.examples." + name)
            torch.set_num_threads(1)
            torch.set_flush_denormal(True)
            try:
                cache[name] = _main_output(mod.main, TINY_ARGV[name] + ["--device", "cpu"])
            finally:
                torch.set_flush_denormal(False)
                torch.set_num_threads(threads)
        return cache[name]

    return run


def _line(text, label):
    """The numbers after `label` on the one line that starts with it."""
    found = [example_numbers(ln[len(label):]) for ln in text.splitlines() if ln.startswith(label)]
    assert len(found) == 1, (label, text)
    return found[0]


def test_serving_export_runs_at_tiny_arguments(capsys):
    draws = serving_export.main(["--iters", "30", "--n", "24", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "saved artifact:" in out and out.count("request n=") == 3
    assert draws.shape == (32, 50, 1) and np.isfinite(draws).all()


def test_every_example_has_a_twin():
    jax_stems = {p.stem for p in JAX_EXAMPLES.glob("*.py")}
    twin_stems = {p.stem for p in TWINS.glob("*.py")} - {"__init__"}
    assert jax_stems == twin_stems
    assert set(NEW_TWINS) == jax_stems - {"serving_export"}


@pytest.mark.parametrize("name", NEW_TWINS)
def test_example_twin_runs(name, twin_output):
    """The twin's main() at tiny arguments on the CPU: every printed number
    finite; its print() calls carry the JAX example's labels in the same
    order, and each label's leading text is printed, in that order."""
    labels = _print_labels(JAX_EXAMPLES / (name + ".py"))
    assert _print_labels(TWINS / (name + ".py")) == labels
    out = twin_output(name)
    assert np.isfinite(example_numbers(out)).all(), out
    pos = 0
    for consts in labels:
        lead = consts[0].split("%")[0].strip() if consts else ""
        if lead:
            at = out.find(lead, pos)
            assert at >= 0, (lead, out)
            pos = at + len(lead)


def test_main_path_twin_matches_the_jax_example(twin_output):
    """examples/gaussian_process.py and its twin at the same tiny argv
    (--iters 400: 800 natgrad and 600 Laplace steps, the examples' floors):
    the deterministic lines within rtol 1e-3. Measured gap on this CPU:
    quadrature+natgrad ELBO 8.0e-8, Laplace evidence 1.6e-7, Laplace RMSE
    3.5e-6. And linear_models' MAP line (300 full-batch Adam steps): equal
    as printed (a=1.008 b=1.951 from both)."""
    for name, labels in (
        ("gaussian_process", ("robust ELBO (quadrature+natgrad):", "robust Laplace evidence:",
                              "robust Laplace posterior-mean RMSE vs sin(x):")),
        ("linear_models", ("MAP:",)),
    ):
        jax_out, port_out = _jax_output(name), twin_output(name)
        for label in labels:
            want, got = _line(jax_out, label), _line(port_out, label)
            assert len(got) == len(want) > 0
            np.testing.assert_allclose(got, want, rtol=1e-3, err_msg=label)
