#!/usr/bin/env python3
"""Where a serving request's time goes in the PyTorch port, on one GPU.

    python3 tools/torch_serving_profile.py [--seed 0] [--repeats 20]

Serves the default sparse model (hidden 100, layer_timesteps
[2,2,1,2,1], random weights from torch.Generator seed 0) at the default
envelope (max_nodes 2048, max_graphs 256) and reports, for a 1-graph
and a 3,000-graph request from `synthetic_molecules(seed)`:

  * end_to_end_ms: `Predictor.__call__`, host clock, no extra syncs (its
    forward a replay of the CUDA graph of the batch's shape);
  * spans of the same request run eagerly (host clock, each closed by
    `torch.cuda.synchronize()`): pack (numpy packer), h2d
    (`GraphBatch.to`), forward (propagation and readout on the card,
    op by op), d2h (`.cpu().numpy()` of the answer);
  * the difference between the span sum and end_to_end_ms: what the
    synchronisations and the eager forward's launches cost.

Each timing is the median over `--repeats` runs; end_to_end_ms also
gives the fastest and slowest run. The script then profiles five
forwards of one envelope batch already on the card with `torch.profiler`
and reports device time by kernel, the device's busy share of the wall
time of five unprofiled forwards, and the gather_segment_sum launches per
forward. The last line of standard output is one JSON object with every
number. Without CUDA the script fails.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402

from ggnn_tpu_torch.data.loader import DatasetMeta  # noqa: E402
from ggnn_tpu_torch.data.synthetic import synthetic_molecules  # noqa: E402
from ggnn_tpu_torch.models.base import (ModelParams,  # noqa: E402
                                        init_output_heads)
from ggnn_tpu_torch.models.sparse_ggnn import SparseGGNN  # noqa: E402
from ggnn_tpu_torch.ops.kernels import ell_spmm  # noqa: E402
from ggnn_tpu_torch.serving import Predictor  # noqa: E402
from ggnn_tpu_torch.training.config import default_params_for  # noqa: E402

EDGE_TYPES = 4


def _predictor() -> Predictor:
    config = default_params_for("sparse")
    gen = torch.Generator().manual_seed(0)
    params = ModelParams(SparseGGNN(config, EDGE_TYPES, gen),
                         init_output_heads(gen, config["hidden_size"],
                                           config["task_ids"]))
    meta = DatasetMeta(max_num_vertices=2048, num_edge_types=EDGE_TYPES,
                       annotation_size=config["hidden_size"])
    return Predictor("sparse", config, meta, params)


def _packed(predictor, request):
    if len(request) == 1:
        return [predictor._pack_single_sparse(request[0], 5)]
    return list(predictor._batches(request, 5))


def _spans(predictor, request) -> dict:
    """Host-clock spans of one request, each closed by a synchronise."""
    model = predictor.params.graph
    t0 = time.perf_counter()
    batches = _packed(predictor, request)
    t1 = time.perf_counter()
    spans = {"pack": t1 - t0, "h2d": 0.0, "forward": 0.0, "d2h": 0.0}
    for batch in batches:
        t0 = time.perf_counter()
        on_device = batch.to(predictor.device)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with torch.inference_mode():
            out = model.readout(predictor.params.heads, predictor.task_ids,
                                model(on_device), on_device)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        out.cpu().numpy()
        t3 = time.perf_counter()
        spans["h2d"] += t1 - t0
        spans["forward"] += t2 - t1
        spans["d2h"] += t3 - t2
    spans["batches"] = len(batches)
    return spans


def _request_profile(predictor, request, repeats) -> dict:
    predictor(request)                                  # warm-up
    end_to_end = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        predictor(request)
        end_to_end.append(time.perf_counter() - t0)
    runs = [_spans(predictor, request) for _ in range(repeats)]
    out = {"graphs": len(request), "batches": runs[0]["batches"],
           "repeats": repeats,
           "end_to_end_ms": statistics.median(end_to_end) * 1e3,
           "end_to_end_min_ms": min(end_to_end) * 1e3,
           "end_to_end_max_ms": max(end_to_end) * 1e3}
    for name in ("pack", "h2d", "forward", "d2h"):
        out[f"{name}_ms"] = statistics.median(r[name] for r in runs) * 1e3
    out["span_sum_ms"] = sum(out[f"{n}_ms"]
                             for n in ("pack", "h2d", "forward", "d2h"))
    out["graphs_per_s"] = len(request) / (out["end_to_end_ms"] / 1e3)
    return out


def _device_profile(predictor, request, forwards=5) -> dict:
    """torch.profiler over `forwards` forwards of one envelope batch
    already on the card."""
    model = predictor.params.graph
    batch = _packed(predictor, request)[0].to(predictor.device)

    def forward():
        with torch.inference_mode():
            return model.readout(predictor.params.heads, predictor.task_ids,
                                 model(batch), batch)

    for _ in range(3):
        forward()
    torch.cuda.synchronize()
    # Wall time without the profiler, whose own cost would count as idle.
    t0 = time.perf_counter()
    for _ in range(forwards):
        forward()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ell_spmm.launches
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(forwards):
            forward()
        torch.cuda.synchronize()
    launches = ell_spmm.launches - launches
    # Device-side events only: a CPU operator's self device time repeats
    # the time of the kernels it launched.
    kernels = [(e.key, e.self_device_time_total, e.count)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    kernels.sort(key=lambda k: -k[1])
    busy_us = sum(k[1] for k in kernels)
    return {
        "forwards": forwards,
        "wall_ms_per_forward": wall * 1e3 / forwards,
        "device_busy_ms_per_forward": busy_us / 1e3 / forwards,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall,
        "gather_segment_sum_launches_per_forward": launches / forwards,
        "kernels_per_forward": sum(k[2] for k in kernels) / forwards,
        "top_kernels": [{"name": k[0][:80], "ms_per_forward": k[1] / 1e3
                         / forwards, "calls_per_forward": k[2] / forwards}
                        for k in kernels[:12]],
    }


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--repeats", type=int, default=20)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_serving_profile: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    predictor = _predictor()
    requests = {n: synthetic_molecules(n, seed=args.seed + i)
                for i, n in enumerate((1, 3000))}
    result = {"card": card, "seed": args.seed, "requests": {}}
    for n, request in requests.items():
        result["requests"][str(n)] = _request_profile(predictor, request,
                                                      args.repeats)
        print(f"{n}-graph request: "
              f"{json.dumps(result['requests'][str(n)])}", flush=True)
    result["device_profile"] = _device_profile(predictor, requests[3000])
    print(f"device profile: {json.dumps(result['device_profile'])}",
          flush=True)
    print(card)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
