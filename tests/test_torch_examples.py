"""The port's examples (``henbun_tpu_torch/examples``) run end to end on
the CPU at tiny arguments, as tests/test_examples.py runs the JAX
package's."""
import numpy as np

from henbun_tpu_torch.examples import serving_export


def test_serving_export_runs_at_tiny_arguments(capsys):
    draws = serving_export.main(["--iters", "30", "--n", "24", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "saved artifact:" in out and out.count("request n=") == 3
    assert draws.shape == (32, 50, 1) and np.isfinite(draws).all()
