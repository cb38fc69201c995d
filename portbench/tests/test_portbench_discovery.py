"""The harness finds configurations, traffic, cells and per-layer metrics
by their file names alone, and BENCHMARK.json agrees with the files."""
import json
import os

from conftest import ROOT, write_cell

from portbench import spec


def test_every_cell_names_files_that_exist():
    for name in spec.names("workloads"):
        cell = spec.Cell(name)
        assert cell.traffic["driver"] in ("fit", "serve")
        assert set(cell.limits)
        assert cell.driver.Driver and cell.reference.objective


def test_a_new_cell_is_found_as_a_new_file(tiny_root):
    before = spec.names("workloads")
    write_cell(str(tiny_root), "gpr_n40.fleet16", "gpr_n40",
               {"driver": "fit", "models": 16, "window_steps_per_s": 100}, {"loss_gap": 1.0})
    after = spec.names("workloads")
    assert sorted(set(after) - set(before)) == ["gpr_n40.fleet16"]
    assert spec.Cell("gpr_n40.fleet16").traffic["models"] == 16


def test_a_new_metric_is_found_as_a_new_file(tiny_root):
    with open(os.path.join(str(tiny_root), "metrics", "dummy.fit.py"), "w") as f:
        f.write('MOVES = "fit_steps_per_s"\nUNIT = "ops/step"\n\n\n'
                'def read(trace):\n    return 1.0\n')
    readers = spec.metric_readers()
    assert "dummy.fit" in readers and readers["dummy.fit"].read({}) == 1.0


def test_benchmark_json_matches_the_files():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    assert bench["command"][:2] == ["python3", "portbench/run.py"]
    cells = {w["name"]: w for w in bench["workloads"]}
    # a cell's files may wait outside BENCHMARK.json (PERF.md says which)
    assert set(cells) <= set(spec.names("workloads"))
    for name, w in cells.items():
        cell = spec.Cell(name)
        assert (w["config"], w["traffic"], w["chips"]) == (
            cell.workload["config"], cell.workload["traffic"], cell.workload["chips"])
        assert w["why"] == cell.workload["why"]
    for c in bench["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]
    readers = spec.metric_readers()
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["name"] in readers, m["name"]
        assert readers[m["name"]].MOVES == m["moves"] and m["moves"] in e2e
        assert readers[m["name"]].UNIT == m["unit"]
