"""The harness finds everything by name from BENCHMARK.json, keeps to the
benchmark's contract, and prints its last line in the agreed shape."""

import json
import math
import os
import re

import pytest
import torch

from conftest import bench_with_later
from portbench import run, windows

ROOT = run.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"]
    assert bench["command"] == ["python3", "portbench/run.py"]
    assert 1 <= bench["run_seconds"] <= 51


def test_names_units_and_bounds(bench):
    names = [x["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for x in bench[key]]
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert re.match(r"^[A-Za-z0-9_/%.\-]{1,16}$", m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e


def test_every_cell_reports_setup_another_metric_and_a_layer(bench):
    for w in bench["workloads"]:
        cell = run.Cell(w["name"], bench)
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in names


def test_finds_configs_mixes_limits_and_metrics_by_name(bench):
    for c in bench["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert c["file"] == f"portbench/configs/{c['name']}.json"
    later = bench_with_later()
    for w in later["workloads"]:
        cell = run.Cell(w["name"], later)
        assert callable(run.driver_class(cell))
        assert cell.limits and all(v > 0 for v in cell.limits.values())
        assert w["chips"] == 1
        for m in cell.end_to_end:
            assert callable(run.end_to_end(m["name"]))
    for m in later["per_layer"]:
        assert callable(run.reader(m["name"]))


def test_a_reader_that_finds_nothing_returns_nothing():
    empty = run.Reading(None, windows.Window())
    for m in bench_with_later()["per_layer"]:
        assert run.reader(m["name"])(empty) is None


def test_precision_from_the_configuration(tiny_cell):
    """The backend's TF32 switches follow the configuration, and a
    precision the reference does not compute is refused before a run."""
    cell = tiny_cell("sparse_qm9.train_resident")
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        run.set_precision(cell.config)
        assert torch.backends.cuda.matmul.allow_tf32 is False
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    cell.config["tf32"] = True
    with pytest.raises(ValueError, match="precision"):
        windows.Run(cell.config, cell.traffic, 1, torch.device("cpu"),
                    windows.log_dir())


def test_last_line_shape(tiny_cell):
    cell = tiny_cell("sparse_qm9.score_batch")
    for trace in (False, True):
        result = run.run_cell(cell, 2**31 + 11, 0.5, trace,
                              torch.device("cpu"), started=0.0)
        line = json.loads(json.dumps(result))
        assert list(line)[-1] == "checks"
        assert {"correct", "attempted", "failed", "metrics",
                "device"} <= set(line)
        assert line["correct"] is True
        assert set(line["device"]) >= {"platform", "kind", "count",
                                       "memory_peak_bytes"}
        for c in line["checks"].values():
            assert set(c) == {"value", "limit"}
            assert math.isfinite(c["value"])
        if trace:
            assert {"busy_s", "window_s"} <= set(line["device"])
            assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        else:
            assert set(line["metrics"]) == {"setup_s", "score_graphs_per_s",
                                            "score_p95_ms"}
            for m in line["metrics"].values():
                assert m["value"] > 0


def test_no_card_no_result(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "dense_qm9.train_resident", "--seed", "1",
                     "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""
