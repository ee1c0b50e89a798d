#!/usr/bin/env python3
"""Host cost of the kernels' entry points on one GPU, for one tree of the
port: run it on two trees in one chip call to compare them.

    python3 tools/torch_op_host_cost.py [--root DIR] [--repeats 5]

`--root` names the checkout whose `ggnn_tpu_torch` is imported (this one
by default; another tree, such as an earlier commit unpacked with `git
archive` into a directory that .gitignore lists, to compare). The script
uses only entry points every tree of the port has, and reports:

  * b1_host_us: host microseconds a call of `ell_spmm.gather_segment_sum`
    (B1) at the serving envelope's lane (N 2048, T 4, H 100) takes in a
    loop of 2,000 calls, synchronised once at the end: the host is the
    bound there (B1 takes about 7 us on the card), so this is the
    Python, dispatch and launch cost of one call;
  * dispatch: in a tree whose entry points are `torch.library` ops, the
    same call through the op and straight through its CUDA launch
    (`_check` and `_launch`, what the wrapper ran before the ops), in
    alternating blocks of 500 calls, 20 blocks each: the medians, whose
    difference is the dispatcher's cost a call within one process;
  * serving: the default sparse model (hidden 100, random weights from
    torch.Generator seed 0) at the default envelope: graphs/s of a
    3,000-graph request and the 1-graph latency (medians of `--repeats`
    and of 20, host clock, synchronised);
  * training: one `Runner.train_step` of the default sparse model and of
    configs/sparse_attention.json on the first 20,000-node batch of
    configs/sparse_tpu.json's packing of synthetic_molecules(2400,
    seed=22): the median wall ms of 50 synchronised steps after 3
    warm-up steps, and the kernels a step (torch.profiler over 3 steps).

The last line of standard output is one JSON object with every number,
the tree it measured and the card's name and power limit. Without CUDA
the script fails.
"""

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _args():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--root", default=REPO,
                   help="checkout whose ggnn_tpu_torch is measured")
    p.add_argument("--repeats", type=int, default=5)
    return p.parse_args()


def _config(name=None, **overrides):
    from ggnn_tpu_torch.training.config import resolve_config
    keys = {}
    for config_file in ("sparse_tpu.json",) + ((name,) if name else ()):
        with open(os.path.join(REPO, "configs", config_file)) as f:
            keys.update(json.load(f))
    keys.update(overrides)
    return resolve_config("sparse", config_json=json.dumps(keys))


def b1_inputs():
    import torch

    from ggnn_tpu_torch.data import packing
    from ggnn_tpu_torch.data.synthetic import synthetic_molecules
    from ggnn_tpu_torch.ops.segment import segment_offsets

    caps = packing.PackCapacities(nodes=2048, edges_per_type=16384,
                                  graphs=256, edges_all=16384)
    proc = packing.preprocess_sparse(synthetic_molecules(300, seed=21), 4,
                                     True, [0], {}, False)
    batch = next(packing.pack_sparse_batches(proc, 4, caps.nodes + 1, caps,
                                             100, 5, False, None))
    dev = torch.device("cuda")
    src = torch.from_numpy(batch.edge_sources_all).to(dev)
    seg = torch.from_numpy(batch.edge_targets_all.astype("int64") * 4
                           + batch.edge_types_all).to(dev)
    offsets = segment_offsets(seg, 2048 * 4)
    return torch.randn(2048, 100, device=dev), src, offsets, 2048 * 4


def _host_us(fn, calls):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def b1_host_us(args, calls=2000):
    from ggnn_tpu_torch.ops.kernels import ell_spmm

    def call():
        ell_spmm.gather_segment_sum(*args)

    _host_us(call, 50)
    return _host_us(call, calls)


def dispatch_us(args, blocks=20, calls=500):
    """(op, direct) median host us a call, or None where the tree's
    entry points are not ops."""
    from ggnn_tpu_torch.ops.kernels import ell_spmm

    if not hasattr(ell_spmm, "_library"):
        return None

    def op():
        ell_spmm.gather_segment_sum(*args)

    def direct():
        ell_spmm._check(*args)
        ell_spmm._launch("gather_segment_sum_f32", *args)

    times = {"op_us": [], "direct_us": []}
    for _ in range(blocks):
        for name, fn in (("op_us", op), ("direct_us", direct)):
            times[name].append(_host_us(fn, calls))
    return {name: statistics.median(t) for name, t in times.items()}


def serving(repeats):
    import torch

    from ggnn_tpu_torch.data.loader import DatasetMeta
    from ggnn_tpu_torch.data.synthetic import synthetic_molecules
    from ggnn_tpu_torch.models.base import ModelParams, init_output_heads
    from ggnn_tpu_torch.models.sparse_ggnn import SparseGGNN
    from ggnn_tpu_torch.serving import Predictor
    from ggnn_tpu_torch.training.config import default_params_for

    config = default_params_for("sparse")
    gen = torch.Generator().manual_seed(0)
    params = ModelParams(SparseGGNN(config, 4, gen),
                         init_output_heads(gen, 100, config["task_ids"]))
    predictor = Predictor("sparse", config, DatasetMeta(2048, 4, 100),
                          params)
    large = synthetic_molecules(3000, seed=32)
    small = synthetic_molecules(1, seed=30)

    def timed(request, n):
        times = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            predictor(request)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return statistics.median(times)

    timed(large, 1)
    timed(small, 5)
    return {"graphs_per_s_3000": 3000 / timed(large, repeats),
            "latency_1_graph_ms": timed(small, 20) * 1e3}


def train_step(name, corpus, steps=50):
    import torch
    from torch.autograd import DeviceType

    from ggnn_tpu_torch.training.runner import Runner

    config = _config(name, num_epochs=1)
    with tempfile.TemporaryDirectory() as log_dir:
        runner = Runner("sparse", config, train_data=corpus[0],
                        valid_data=corpus[1], log_dir=log_dir, quiet=True)
    batch = next(b for b in runner.adapter.batches(runner.train_processed,
                                                   False)
                 if int(b.num_nodes) >= 19000).to(runner.device)
    for _ in range(3):
        runner.train_step(batch)
    times = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner.train_step(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(3):
            runner.train_step(batch)
        torch.cuda.synchronize()
    kernels = sum(e.count for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA)
    return {"step_wall_ms": statistics.median(times) * 1e3,
            "kernels_a_step": kernels / 3}


def main() -> int:
    args = _args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("torch_op_host_cost: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    import ggnn_tpu_torch
    from ggnn_tpu_torch.data.synthetic import synthetic_molecules
    from ggnn_tpu_torch.ops.kernels import _build
    from ggnn_tpu_torch.utils.timing import gpu_name_and_power

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all(("ell_spmm", "gather_floor", "edge_dot"))
    b1 = b1_inputs()
    corpus = (synthetic_molecules(2400, seed=22),
              synthetic_molecules(50, seed=23))
    result = {
        "tree": os.path.abspath(args.root),
        "package": os.path.dirname(ggnn_tpu_torch.__file__),
        "b1_host_us": b1_host_us(b1),
        "dispatch": dispatch_us(b1),
        "serving": serving(args.repeats),
        "train_step": {"sparse": train_step(None, corpus),
                       "sparse_attention": train_step(
                           "sparse_attention.json", corpus)},
        "device": gpu_name_and_power(),
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
