"""Shared fixtures of the benchmark's tests: the repository on the path,
the `cuda` marker, and cells cut to a size a CPU test holds (the widths
too: these runs check the harness, not the sizes): the cells of
BENCHMARK.json, and the mixes the harness keeps for later cells (`LATER`,
entries as BENCHMARK.json would hold them; their drivers, mixes, limits
and metric files are in the benchmark, and PERF.md says why they are not
cells yet)."""

import copy
import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


LATER = json.loads(r"""
{
 "workloads": [
  {
   "name": "sparse_qm9.train_stream",
   "config": "sparse_qm9",
   "traffic": "train_stream",
   "chips": 1,
   "why": "the same epochs as Runner.train streams them: shuffle, native packer in the prefetch thread, pageable copy, replayed step; host-paced"
  },
  {
   "name": "sparse_qm9.score_batch",
   "config": "sparse_qm9",
   "traffic": "score_batch",
   "chips": 1,
   "why": "screening: 1 closed-loop client, 2,000 molecules a request at a 20k-node envelope: caller-thread entry checks, packer, forward replay; backward bypassed"
  }
 ],
 "end_to_end": [
  {
   "name": "train_graphs_per_s.stream",
   "unit": "graphs/s",
   "better": "higher",
   "bound": 0.25,
   "source": "host_clock",
   "workloads": [
    "sparse_qm9.train_stream"
   ]
  },
  {
   "name": "score_graphs_per_s",
   "unit": "graphs/s",
   "better": "higher",
   "bound": 0.25,
   "source": "host_clock",
   "workloads": [
    "sparse_qm9.score_batch"
   ]
  },
  {
   "name": "score_p95_ms",
   "unit": "ms",
   "better": "lower",
   "bound": 0.25,
   "source": "host_clock",
   "workloads": [
    "sparse_qm9.score_batch"
   ]
  }
 ],
 "per_layer": [
  {
   "name": "device_idle.stream",
   "unit": "%",
   "better": "lower",
   "source": "device_trace",
   "layer": "device",
   "moves": "train_graphs_per_s.stream",
   "workloads": [
    "sparse_qm9.train_stream"
   ]
  },
  {
   "name": "device_idle.score",
   "unit": "%",
   "better": "lower",
   "source": "device_trace",
   "layer": "device",
   "moves": "score_graphs_per_s",
   "workloads": [
    "sparse_qm9.score_batch"
   ]
  },
  {
   "name": "mfu.stream",
   "unit": "%",
   "better": "higher",
   "source": "device_trace",
   "layer": "model step",
   "moves": "train_graphs_per_s.stream",
   "workloads": [
    "sparse_qm9.train_stream"
   ]
  },
  {
   "name": "mfu.score",
   "unit": "%",
   "better": "higher",
   "source": "device_trace",
   "layer": "model step",
   "moves": "score_graphs_per_s",
   "workloads": [
    "sparse_qm9.score_batch"
   ]
  },
  {
   "name": "agg_roofline.stream",
   "unit": "%",
   "better": "higher",
   "source": "device_trace",
   "layer": "kernels B1/B2",
   "moves": "train_graphs_per_s.stream",
   "workloads": [
    "sparse_qm9.train_stream"
   ]
  },
  {
   "name": "agg_roofline.score",
   "unit": "%",
   "better": "higher",
   "source": "device_trace",
   "layer": "kernels B1/B2",
   "moves": "score_graphs_per_s",
   "workloads": [
    "sparse_qm9.score_batch"
   ]
  }
 ]
}
""")


def bench_with_later() -> dict:
    """BENCHMARK.json with the entries of `LATER` added."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for key, entries in LATER.items():
        bench[key] = bench[key] + entries
    return bench


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU; the test skips itself where "
        "torch.cuda.is_available() is false")


def tiny(cell):
    """`cell` (a run.Cell) at a CPU test's size."""
    cell.config = copy.deepcopy(cell.config)
    cell.config["corpus"] = {"train": 700, "valid": 100}
    cell.config["model"]["hidden_size"] = 16
    cell.config["model"]["batch_size"] = (
        2000 if cell.config["variant"] == "sparse" else 16)
    if cell.traffic["entry"] == "score":
        cell.traffic = dict(cell.traffic, request_graphs=150,
                            max_nodes=1000, max_graphs=128)
    return cell


@pytest.fixture
def tiny_cell():
    from portbench import run

    def make(name):
        return tiny(run.Cell(name, bench_with_later()))
    return make
