#!/usr/bin/env python3
"""Drive the PyTorch port (ggnn_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each raising (and so exiting non-zero) on any failure:

  1. setup — TF32 off for matmuls and cuDNN; build the CUDA kernels from
     ggnn_tpu_torch/csrc into build/kernels/, one nvcc for each source,
     all started together, and report the build times;
  2. kernels — every kernel of the serving and training paths against
     its plain PyTorch version on the card, at the shapes those paths
     give it, at a full-width lane with skewed in-degrees (N 20,000, T 4,
     H 100, 160,000 edges, Zipf 1.1 targets; B2 on its transpose) and at
     edge cases (rtol = atol = 1e-5: f32 sums in another order; the hub
     and skewed cases sum multiples of 1/8 and must match exactly), with
     its device time (CUDA events around each call, median of 50 after
     warm-up, see `time_ms`), its byte bound, the plain version's time
     and, as a yardstick the port never calls, `torch.sparse.mm` of the
     CSR count matrix (B1) or of its transpose (B2) (time_ms is
     `ggnn_tpu_torch/utils/timing.py`'s, shared with the probe); the
     edges past which B1/B2 cut a segment and the registers of its
     float4 and scalar instances;
  3. probe — the gather-floor probe's entry point
     (`ggnn_tpu_torch.probes.gather_floor.run`) on the card: kernel B3
     (`gather_rows`) at unroll 1, 4 and 8 at the JAX probe's shape
     (`make_inputs(0)`: NB 2048, KE 96, H 128, NP 8192) and at the
     20k-node training lane's own source order (its first 422 x 96 real
     sources over a randn(20000, 100) table), each equal to its plain
     version (tolerance 0: a gather copies bits), with plain and with
     streaming stores, with its time, byte bound, the plain version's,
     `torch.index_select`'s and an output-sized `zero_`'s times and the
     registers of each kernel instance; and `zero_` of B1's output at the
     20k-node batch, with B1's time there as a multiple of it;
  4. serving — a default sparse model (hidden 100, layer_timesteps
     [2,2,1,2,1], random weights from torch.Generator seed 0) written as
     a pickle checkpoint and loaded by `Predictor.from_checkpoint` with
     the default device and envelope; a 1-graph, a 300-graph and a
     3,000-graph request, with the kernels' launch counters read around
     them (8 B1 launches per forward, no B2, no B3), each answer held
     against the same checkpoint served on the CPU (rtol = atol = 1e-4:
     8 GRU steps with f32 products in another order), graphs/s of the
     large request and the 1-graph latency;
  5. training — `Runner("sparse", cfg)` with the default sparse config
     plus configs/sparse_tpu.json (20,000-node batches, edge-weight
     dropout 0.8) on the default device, 3 epochs of
     synthetic_molecules(6000, seed=40), validated on
     synthetic_molecules(600, seed=41): the kernels' counters set to 0
     before `train()` and read after it (8 B1 launches per train step
     and per validation batch, 7 B2 launches per train step, no B3),
     every loss finite, the last validation loss below that of the
     initial weights; per epoch the losses, MAE, error_ratio, graphs/s
     and the median synchronised train-step time;
  6. card against CPU — one train step on one 20k-node batch, every keep
     probability 1.0, from the same initial weights on the card and on
     the CPU: loss at rtol 1e-5, every parameter's gradient at a
     relative L2 error <= 1e-4 (f32 sums in another order over 8 GRU
     steps);
  7. profile — `torch.profiler` over train steps on a 20k-node batch:
     wall ms, device-busy ms, the device's idle share, the kernel count
     and the top device operations.

The last three lines of standard output are the card's name and power
limit (nvidia-smi), one JSON object with the kernels' numbers, and
{"ok": true, "device": {...}}. Without CUDA, or outside a checkout of
the repository, the script fails and prints no result.
"""

import json
import os
import statistics
import sys
import time

import numpy as np
import torch

from ggnn_tpu_torch.utils.timing import gpu_name_and_power, time_ms

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12          # f32 outside the tensor cores, same source
TOL_KERNEL = 1e-5
TOL_SERVING = 1e-4
TOL_STEP_LOSS = 1e-5       # card vs CPU train step: loss, rtol
TOL_STEP_GRAD = 1e-4       # ... and each gradient, relative L2 error
HIDDEN = 100
EDGE_TYPES = 4
SKEWED_NODES = 20000
SKEWED_EDGES = 160000


def log(msg: str) -> None:
    print(msg, flush=True)


# ------------------------------------------------------------ kernels

def csr_count_matrix(src, offsets, num_segments, num_nodes):
    """[S, N] CSR matrix with one 1.0 per edge (the library yardstick)."""
    nnz = int(offsets[-1].item())
    return torch.sparse_csr_tensor(
        offsets.long(), src[:nnz].long(),
        torch.ones(nnz, dtype=torch.float32, device=src.device),
        size=(num_segments, num_nodes))


def measure(kernel, plain, library, bytes_moved, ops):
    """Times of a kernel call, its plain version and the library call
    (see `time_ms`), and the call's bound from the bytes it must move and
    the operations it must do."""
    ms, host_ms = time_ms(kernel)
    plain_ms, plain_host_ms = time_ms(plain)
    library_ms, library_host_ms = time_ms(library)
    byte_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    op_ms = ops / F32_OPS_PER_S * 1e3
    return {
        "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "host_ms": host_ms, "plain_host_ms": plain_host_ms,
        "library_host_ms": library_host_ms,
        "bound_ms": max(byte_ms, op_ms),
        "bound_by": "bytes" if byte_ms >= op_ms else "operations",
        "bytes": bytes_moved,
    }


def timing_text(rec) -> str:
    return (f"device ms={rec['ms']:.6f} bound_us={rec['bound_ms'] * 1e3:.3f}"
            f" ({rec['bound_by']}) plain_ms={rec['plain_ms']:.6f} "
            f"library_ms={rec['library_ms']:.6f} | host ms per call: kernel "
            f"{rec['host_ms']:.6f} plain {rec['plain_host_ms']:.6f} library "
            f"{rec['library_host_ms']:.6f} | "
            f"max_abs_err={rec['max_abs_err']:.3e}")


def check_kernel(ell_spmm, name, label, x, idx, offsets, num_segments,
                 exact=False):
    """A sorted-segment kernel, B1 (`gather_segment_sum`) or B2
    (`segment_scatter_sum`), against its plain version on the card at one
    shape; returns the shape's record. out[s] sums the rows x[idx[e]]
    over the edges e of segment s. The bound counts the rows of x that
    some edge reads (each once), the segments' indices and offsets once
    and the output written once. `exact` demands equality (inputs whose
    partial sums are exact in f32)."""
    kernel = getattr(ell_spmm, name)
    plain = getattr(ell_spmm, name + "_reference")
    got = kernel(x, idx, offsets, num_segments)
    want = plain(x, idx, offsets, num_segments)
    torch.cuda.synchronize()
    err = float((got - want).abs().max().item()) if got.numel() else 0.0
    tol = 0.0 if exact else TOL_KERNEL
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    rows, h_dim = x.shape
    begin, end = int(offsets[0].item()), int(offsets[-1].item())
    used = end - begin
    rows_read = int(torch.unique(idx[begin:end]).numel())
    matrix = csr_count_matrix(idx, offsets, num_segments, rows)
    lib_out = torch.sparse.mm(matrix, x)
    torch.testing.assert_close(lib_out, want, rtol=TOL_KERNEL,
                               atol=TOL_KERNEL)
    rec = {
        "shape": label, "rows_of_input": rows, "H": h_dim,
        "S": num_segments, "E": int(idx.shape[0]), "edges_used": used,
        "rows_read": rows_read, "max_abs_err": err,
        **measure(
            lambda: kernel(x, idx, offsets, num_segments),
            lambda: plain(x, idx, offsets, num_segments),
            lambda: torch.sparse.mm(matrix, x),
            bytes_moved=4 * (rows_read * h_dim + used + (num_segments + 1)
                             + num_segments * h_dim),
            ops=used * h_dim),
    }
    log(f"kernel {name} [{label}] rows(input)={rows} H={h_dim} "
        f"S={num_segments} E={rec['E']} used={used} rows_read={rows_read}: "
        f"{timing_text(rec)}")
    return rec


def lane_batches():
    """[(label, batch, T)] of the two combined-lane shapes both kernels
    are measured at: the serving envelope (a batch packed exactly as
    Predictor packs a multi-graph request at max_nodes=2048,
    max_graphs=256) and the 20,000-node budget of
    configs/sparse_tpu.json (capacities planned by the port's packer over
    a synthetic corpus), the training path's batch."""
    from ggnn_tpu_torch.data import packing
    from ggnn_tpu_torch.data.loader import infer_metadata
    from ggnn_tpu_torch.data.synthetic import synthetic_molecules

    caps = packing.PackCapacities(nodes=2048, edges_per_type=16384,
                                  graphs=256, edges_all=16384)
    proc = packing.preprocess_sparse(synthetic_molecules(300, seed=21),
                                     EDGE_TYPES, True, [0], {}, False)
    envelope = next(packing.pack_sparse_batches(
        proc, EDGE_TYPES, caps.nodes + 1, caps, HIDDEN, 5, False, None))
    corpus = synthetic_molecules(2400, seed=22)
    meta = infer_metadata([corpus], True)
    proc = packing.preprocess_sparse(corpus, meta.num_edge_types, True, [0],
                                     {}, False)
    caps20k = packing.plan_capacities(proc, meta.num_edge_types, 20000)
    log(f"20k-node plan: {caps20k}")
    budget = next(packing.pack_sparse_batches(
        proc, meta.num_edge_types, 20000, caps20k, HIDDEN,
        meta.annotation_size, False, None))
    return [("serving envelope", envelope, EDGE_TYPES),
            ("20k-node budget", budget, meta.num_edge_types)]


def small_ell_layout(dev):
    """(NP, {name: [T, NB, KE] int32 on the card}) of a small blocked-ELL
    layout from data/ell.py: 3,000 random edges of each of 4 types over
    1,000 nodes, blocks of 64."""
    from ggnn_tpu_torch.data.ell import build_ell_layout

    rng = np.random.default_rng(25)
    src = rng.integers(0, 1000, (EDGE_TYPES, 3000)).astype(np.int32)
    tgt = rng.integers(0, 1000, (EDGE_TYPES, 3000)).astype(np.int32)
    layout = build_ell_layout(src, tgt, np.ones_like(src, np.float32), 1000,
                              64)
    return layout.fwd_src.shape[1] * 64, {
        name: torch.from_numpy(getattr(layout, name)).to(dev)
        for name in ("fwd_src", "fwd_tgt", "bwd_tgt", "bwd_src")}


def hub_case(dev, gen, seed, num_segments, num_rows, hub):
    """(x, idx, offsets) of a hub check: `num_segments` segments, 300 of
    them with 1-8 edges and segment `hub` with 5,000, the rest empty,
    gathering from `num_rows` rows. The hub sums 5,000 rows, whose f32
    rounding differs by order well past 1e-5, so x holds multiples of
    1/8 in [-2, 2]: every partial sum is exact in f32 and a kernel must
    equal its plain version."""
    rng = np.random.default_rng(seed)
    counts = np.zeros(num_segments, np.int64)
    counts[rng.choice(num_segments, 300, replace=False)] = rng.integers(
        1, 9, 300)
    counts[hub] = 5000
    offsets = torch.from_numpy(np.concatenate(
        [[0], np.cumsum(counts)]).astype(np.int32)).to(dev)
    idx = torch.from_numpy(rng.integers(0, num_rows, int(counts.sum()))
                           .astype(np.int32)).to(dev)
    return eighths(gen, dev, num_rows), idx, offsets


def skewed_lane(dev):
    """(src, types, targets) int32 on the card of a full-width lane with
    skewed in-degrees: N = 20,000 nodes, T = 4, H = 100 and 160,000
    edges (the edge count the JAX kernel's docstring measured at,
    ggnn_tpu/ops/pallas/ell_spmm.py:26). Targets are drawn with
    probability proportional to 1/(rank+1)^1.1 over a random ranking of
    the nodes, so the top node has thousands of in-edges; sources and
    types are uniform; the lane is sorted by (target, type), as the
    packers sort it."""
    rng = np.random.default_rng(27)
    weights = 1.0 / np.arange(1, SKEWED_NODES + 1) ** 1.1
    node_of_rank = rng.permutation(SKEWED_NODES)
    tgt = node_of_rank[rng.choice(SKEWED_NODES, SKEWED_EDGES,
                                  p=weights / weights.sum())]
    src = rng.integers(0, SKEWED_NODES, SKEWED_EDGES)
    types = rng.integers(0, EDGE_TYPES, SKEWED_EDGES)
    order = np.lexsort((types, tgt))
    return tuple(torch.from_numpy(a[order].astype(np.int32)).to(dev)
                 for a in (src, types, tgt))


def eighths(gen, dev, rows):
    """[rows, HIDDEN] multiples of 1/8 in [-2, 2]: every partial sum of
    a few thousand rows is exact in f32, so a kernel must equal its plain
    version whatever its order of summation."""
    return torch.randint(-16, 17, (rows, HIDDEN), generator=gen,
                         device=dev).float() / 8


def kernel_phase(dev, gen, batches, ell, skewed):
    """B1 at the serving envelope and the 20k-node budget, a hub, the
    skewed lane, H = 37 (the scalar path; float4 needs H % 4 == 0), and
    its ELL entry point."""
    from ggnn_tpu_torch.ops.kernels import ell_spmm
    from ggnn_tpu_torch.ops.messages import combined_lane_offsets

    def rand_h(n, h_dim=HIDDEN):
        return torch.randn(n, h_dim, generator=gen, device=dev)

    def check(*args, **kwargs):
        return check_kernel(ell_spmm, "gather_segment_sum", *args, **kwargs)

    records = []
    for label, batch, t_dim in batches:
        n_cap = batch.node_capacity
        b = batch.to(dev)
        offsets = combined_lane_offsets(b.edge_targets_all,
                                        b.edge_types_all, t_dim, n_cap)
        records.append(check(label, rand_h(n_cap), b.edge_sources_all,
                             offsets, n_cap * t_dim))
    records.append(check("hub + empty segments",
                         *hub_case(dev, gen, 23, 4096, 6000, 1234), 4096,
                         exact=True))
    src, types, tgt = skewed
    num_segments = SKEWED_NODES * EDGE_TYPES
    records.append(check(
        "skewed in-degree", eighths(gen, dev, SKEWED_NODES), src,
        combined_lane_offsets(tgt, types, EDGE_TYPES, SKEWED_NODES),
        num_segments, exact=True))
    rng = np.random.default_rng(26)
    counts = rng.integers(0, 6, 6000)
    offsets = torch.from_numpy(np.concatenate(
        [[0], np.cumsum(counts)]).astype(np.int32)).to(dev)
    src = torch.from_numpy(rng.integers(0, 3000, int(counts.sum()))
                           .astype(np.int32)).to(dev)
    records.append(check("H=37", rand_h(3000, 37), src, offsets, 6000))

    np_total, layout = ell
    h = rand_h(np_total)
    fwd = (layout["fwd_src"], layout["fwd_tgt"])
    got = ell_spmm.ell_aggregate_by_type(h, *fwd)
    want = ell_spmm.ell_aggregate_by_type_reference(h, *fwd)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=TOL_KERNEL, atol=TOL_KERNEL)
    ell_err = float((got - want).abs().max().item())
    log(f"kernel ell_aggregate_by_type [T={EDGE_TYPES} NP={np_total} "
        f"KE={fwd[0].shape[2]}]: max_abs_err={ell_err:.3e}")
    return records, ell_err


def backward_kernel_phase(dev, gen, batches, ell, skewed):
    """B2 at the backward of the serving envelope and of the 20k-node
    budget (the training path's shape), a hub source, the skewed lane's
    transpose, and its ELL entry point."""
    from ggnn_tpu_torch.ops.kernels import ell_spmm
    from ggnn_tpu_torch.ops.messages import combined_lane_transpose

    def check(*args, **kwargs):
        return check_kernel(ell_spmm, "segment_scatter_sum", *args,
                            **kwargs)

    records = []
    for label, batch, t_dim in batches:
        n_cap = batch.node_capacity
        b = batch.to(dev)
        bgather, boff = combined_lane_transpose(
            b.edge_sources_all, b.edge_types_all, b.edge_targets_all,
            t_dim, n_cap)
        g = torch.randn(n_cap * t_dim, HIDDEN, generator=gen, device=dev)
        records.append(check(f"backward of the {label}", g, bgather, boff,
                             n_cap))
    records.append(check("hub + empty rows",
                         *hub_case(dev, gen, 24, 4096, 4096 * EDGE_TYPES,
                                   2345), 4096, exact=True))
    src, types, tgt = skewed
    bgather, boff = combined_lane_transpose(src, types, tgt, EDGE_TYPES,
                                            SKEWED_NODES)
    records.append(check(
        "backward of the skewed in-degree",
        eighths(gen, dev, SKEWED_NODES * EDGE_TYPES), bgather, boff,
        SKEWED_NODES, exact=True))

    # The ELL entry point on the layout of B1's ELL case.
    np_total, layout = ell
    g = torch.randn(EDGE_TYPES, np_total, HIDDEN, generator=gen, device=dev)
    bwd = (layout["bwd_tgt"], layout["bwd_src"])
    got = ell_spmm.ell_scatter_sum(g, *bwd)
    want = ell_spmm.ell_scatter_sum_reference(g, *bwd)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=TOL_KERNEL, atol=TOL_KERNEL)
    ell_err = float((got - want).abs().max().item())
    log(f"kernel ell_scatter_sum [T={EDGE_TYPES} NP={np_total} "
        f"KE={bwd[0].shape[2]}]: max_abs_err={ell_err:.3e}")
    return records, ell_err


# ------------------------------------------------------------ probe

def probe_phase(dev, batches):
    """The gather-floor probe's entry point on the card at the JAX
    probe's shape and at the 20k-node training lane's own source order,
    with plain and with streaming stores, B3's counter set to 0 just
    before and read just after; and, beside it, the time of writing
    B1's output at that batch alone."""
    from ggnn_tpu_torch.ops.kernels import gather_floor
    from ggnn_tpu_torch.probes import gather_floor as probe

    _, batch, t_dim = batches[1]
    n_cap = batch.node_capacity
    targets = batch.edge_targets_all
    real = int((targets < n_cap).sum())
    if not (targets[:real] < n_cap).all():
        raise RuntimeError("the 20k-node lane's pads are not at its end")
    lane_src = batch.edge_sources_all[:real // probe.KE * probe.KE]
    lane_h = np.random.RandomState(1).randn(n_cap, HIDDEN).astype(
        np.float32)
    lane = (lane_h, lane_src.reshape(-1, probe.KE))
    gather_floor.launches = 0
    shapes = {"probe shape": probe.run(dev),
              "probe shape, streaming stores": probe.run(dev,
                                                         streaming=True),
              "20k-node lane sources": probe.run(dev, *lane),
              "20k-node lane sources, streaming stores": probe.run(
                  dev, *lane, streaming=True)}
    torch.cuda.synchronize()
    launches = gather_floor.launches
    for label, records in shapes.items():
        for rec in records:
            log(f"probe gather_rows [{label}] {probe.record_text(rec)}")
    registers = {
        f"{'float4' if vec else 'scalar'} unroll {u}"
        f"{' streaming' if stream else ''}":
        gather_floor.registers(u, vec, stream, dev)
        for vec in (True, False) for stream in (False, True)
        for u in gather_floor.UNROLLS}
    log(f"probe: gather_rows registers per thread {registers}; {launches} "
        f"launches in the probe's run ({real} real edges in the 20k-node "
        f"lane, N = {n_cap})")
    if launches == 0:
        raise RuntimeError("the probe did not launch gather_rows")
    # What writing B1's output at this batch alone costs: [N*T, H] f32.
    b1_out = torch.empty(n_cap * t_dim, HIDDEN, device=dev)
    b1_zero_ms = time_ms(b1_out.zero_)[0]
    log(f"probe: zero_ of B1's [{n_cap * t_dim}, {HIDDEN}] output at the "
        f"20k-node batch {b1_zero_ms * 1e3:.3f} us")
    return {"shapes": shapes, "registers": registers, "launches": launches,
            "b1_output_zero_ms": b1_zero_ms}


# ------------------------------------------------------------ serving

def serving_phase(ckpt_dir):
    from ggnn_tpu_torch.data.synthetic import synthetic_molecules
    from ggnn_tpu_torch.models.base import ModelParams, init_output_heads
    from ggnn_tpu_torch.models.sparse_ggnn import SparseGGNN
    from ggnn_tpu_torch.ops.kernels import ell_spmm
    from ggnn_tpu_torch.serving import Predictor
    from ggnn_tpu_torch.training.checkpoint import save_checkpoint
    from ggnn_tpu_torch.training.config import default_params_for

    config = default_params_for("sparse")
    assert config["hidden_size"] == HIDDEN
    steps = sum(config["layer_timesteps"])
    gen = torch.Generator().manual_seed(0)
    params = ModelParams(
        graph=SparseGGNN(config, EDGE_TYPES, gen),
        heads=init_output_heads(gen, config["hidden_size"],
                                config["task_ids"]))
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, "sparse_random_seed0.pickle")
    save_checkpoint(path, config, params, 0, 0)

    predictor = Predictor.from_checkpoint(path, "sparse")
    if predictor.device.type != "cuda":
        raise RuntimeError(f"default device is {predictor.device}")
    cpu_predictor = Predictor.from_checkpoint(path, "sparse", device="cpu")
    requests = {n: synthetic_molecules(n, seed=30 + i)
                for i, n in enumerate((1, 300, 3000))}

    forward_calls = 0
    forward = predictor._forward

    def counted_forward(batch):
        nonlocal forward_calls
        forward_calls += 1
        return forward(batch)

    predictor._forward = counted_forward
    ell_spmm.launches = 0
    ell_spmm.scatter_launches = 0
    answers = {n: predictor(req) for n, req in requests.items()}
    torch.cuda.synchronize()
    launches, scatter_launches = ell_spmm.launches, ell_spmm.scatter_launches
    predictor._forward = forward
    log(f"serving: {forward_calls} forward calls, {launches} B1 launches "
        f"({steps} per forward expected), {scatter_launches} B2 launches "
        "(0 expected: serving builds no transpose layout)")
    if launches != steps * forward_calls or launches == 0:
        raise RuntimeError(
            f"kernel launches {launches} != {steps} x {forward_calls} "
            "forward calls: the serving path did not run the kernel")
    if scatter_launches != 0:
        raise RuntimeError(f"serving launched B2 {scatter_launches} times")

    max_err = 0.0
    for n, req in requests.items():
        got = answers[n]
        if got.shape != (1, n) or not np.isfinite(got).all():
            raise RuntimeError(f"{n}-graph answer has shape {got.shape} "
                               "or non-finite values")
        want = cpu_predictor(req)
        err = float(np.abs(got - want).max())
        max_err = max(max_err, err)
        np.testing.assert_allclose(got, want, rtol=TOL_SERVING,
                                   atol=TOL_SERVING)
        log(f"serving {n}-graph request: matches CPU port "
            f"(max_abs_err={err:.3e})")

    big = requests[3000]
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        predictor(big)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    lat = []
    for _ in range(25):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        predictor(requests[1])
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
    result = {
        "forward_calls": forward_calls, "launches": launches,
        "scatter_launches": scatter_launches,
        "graphs_per_s_3000": 3000 / statistics.median(times),
        "latency_1_graph_ms": statistics.median(lat[5:]) * 1e3,
        "max_abs_err_vs_cpu": max_err,
    }
    log(f"serving: {result['graphs_per_s_3000']:.1f} graphs/s on the "
        f"3000-graph request (median of 3, host clock, synchronised); "
        f"1-graph latency {result['latency_1_graph_ms']:.3f} ms "
        "(median of 20)")
    return result


# ------------------------------------------------------------ training

def training_config(overrides=None):
    from ggnn_tpu_torch.training.config import resolve_config
    config = resolve_config(
        "sparse", os.path.join(REPO, "configs", "sparse_tpu.json"),
        json.dumps(overrides or {}))
    assert config["hidden_size"] == HIDDEN
    assert config["batch_size"] == 20000
    return config


def training_phase(log_dir):
    """3 epochs of the default sparse config at the 20k-node budget
    through `Runner.train()` on the default device."""
    from ggnn_tpu_torch.data.synthetic import synthetic_molecules
    from ggnn_tpu_torch.ops.kernels import ell_spmm
    from ggnn_tpu_torch.training.runner import Runner

    config = training_config({"num_epochs": 3})
    assert config["edge_weight_dropout_keep_prob"] == 0.8
    steps = sum(config["layer_timesteps"])
    t0 = time.perf_counter()
    runner = Runner("sparse", config,
                    train_data=synthetic_molecules(6000, seed=40),
                    valid_data=synthetic_molecules(600, seed=41),
                    log_dir=log_dir, quiet=True)
    setup_s = time.perf_counter() - t0
    if runner.device.type != "cuda":
        raise RuntimeError(f"default device is {runner.device}")
    init_loss, init_accs, _, _, _ = runner.run_epoch(
        "initial validation", runner.valid_processed, False)
    log(f"training: Runner set-up {setup_s:.2f} s (preprocess + plan of "
        f"6,600 graphs, caps {runner.adapter.caps}); validation loss of "
        f"the initial weights {init_loss:.6f} (MAE {init_accs[0]:.6f})")

    # Synchronised step times, per epoch.
    step_times, epoch_marks = [], []
    train_step, run_epoch = runner.train_step, runner.run_epoch

    def timed_step(batch):
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = train_step(batch)
        torch.cuda.synchronize()
        step_times.append(time.perf_counter() - start)
        return out

    def marked_epoch(name, processed, is_training):
        if is_training:
            epoch_marks.append(len(step_times))
        return run_epoch(name, processed, is_training)

    runner.train_step, runner.run_epoch = timed_step, marked_epoch
    ell_spmm.launches = 0
    ell_spmm.scatter_launches = 0
    t0 = time.perf_counter()
    history = runner.train()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    b1, b2 = ell_spmm.launches, ell_spmm.scatter_launches
    runner.train_step, runner.run_epoch = train_step, run_epoch

    train_steps, valid_batches = runner.train_step_id, runner.valid_step_id
    want_b1 = steps * (train_steps + valid_batches)
    want_b2 = (steps - 1) * train_steps
    log(f"training: {len(history)} epochs, {train_steps} train steps, "
        f"{valid_batches} validation batches in {train_s:.2f} s; launches "
        f"B1 {b1} (expected {steps} x ({train_steps} + {valid_batches}) = "
        f"{want_b1}), B2 {b2} (expected {steps - 1} x {train_steps} = "
        f"{want_b2})")
    if b1 != want_b1 or b2 != want_b2 or b1 == 0 or b2 == 0:
        raise RuntimeError("the training path did not launch the kernels "
                           "the expected number of times")
    epoch_marks.append(len(step_times))
    epochs = []
    for i, entry in enumerate(history):
        tr, va = entry["train_results"], entry["valid_results"]
        times = step_times[epoch_marks[i]:epoch_marks[i + 1]]
        rec = {"epoch": entry["epoch"], "train_loss": tr[0],
               "train_mae": tr[1][0], "train_error_ratio": tr[2][0],
               "train_graphs_per_s": tr[3], "valid_loss": va[0],
               "valid_mae": va[1][0], "valid_error_ratio": va[2][0],
               "valid_graphs_per_s": va[3], "train_steps": len(times),
               "median_train_step_ms": statistics.median(times) * 1e3}
        epochs.append(rec)
        log(f"training epoch {rec['epoch']}: train loss {tr[0]:.6f} MAE "
            f"{tr[1][0]:.6f} error_ratio {tr[2][0]:.4f} "
            f"{tr[3]:.1f} graphs/s | valid loss {va[0]:.6f} MAE "
            f"{va[1][0]:.6f} error_ratio {va[2][0]:.4f} {va[3]:.1f} "
            f"graphs/s | median train step {rec['median_train_step_ms']:.3f}"
            f" ms (synchronised, {len(times)} steps)")
        values = [tr[0], va[0], *tr[1], *va[1]]
        if not np.isfinite(values).all():
            raise RuntimeError(f"epoch {rec['epoch']}: non-finite loss")
    if not epochs[-1]["valid_loss"] < init_loss:
        raise RuntimeError(
            f"validation loss after training {epochs[-1]['valid_loss']} is "
            f"not below the initial {init_loss}")
    # The numpy packer alone over one epoch's training split (the Runner
    # runs it in a prefetch thread beside the steps).
    t0 = time.perf_counter()
    packed = sum(1 for _ in runner.adapter.batches(
        runner.train_processed, True, np.random.RandomState(0)))
    pack_s = time.perf_counter() - t0
    epoch_s = len(runner.train_processed) / statistics.median(
        e["train_graphs_per_s"] for e in epochs)
    log(f"training: the numpy packer alone packs one epoch ({packed} "
        f"batches) in {pack_s:.3f} s, {pack_s / epoch_s:.1%} of the "
        f"median train epoch's {epoch_s:.3f} s")
    result = {"launches_b1": b1, "launches_b2": b2,
              "pack_seconds_per_epoch": pack_s,
              "train_epoch_seconds_median": epoch_s,
              "train_steps": train_steps, "valid_batches": valid_batches,
              "initial_valid_loss": init_loss, "train_seconds": train_s,
              "setup_seconds": setup_s, "epochs": epochs}
    return runner, result


def card_vs_cpu_phase(log_dir):
    """One train step, keep probabilities 1.0, on the card and on the
    CPU from the same initial weights (both Runners draw them from a CPU
    generator seeded with random_seed)."""
    from ggnn_tpu_torch.data.synthetic import synthetic_molecules
    from ggnn_tpu_torch.training.runner import Runner

    config = training_config({
        "num_epochs": 1, "edge_weight_dropout_keep_prob": 1.0,
        "graph_state_dropout_keep_prob": 1.0,
        "out_layer_dropout_keep_prob": 1.0})
    train = synthetic_molecules(1300, seed=42)
    valid = synthetic_molecules(50, seed=43)
    runners = {dev: Runner("sparse", dict(config), train_data=train,
                           valid_data=valid,
                           log_dir=os.path.join(log_dir, dev), quiet=True,
                           device=dev)
               for dev in ("cuda", "cpu")}
    batch = next(iter(runners["cpu"].adapter.batches(
        runners["cpu"].train_processed, False)))
    if int(batch.num_nodes) < 19000:
        raise RuntimeError(f"batch has {int(batch.num_nodes)} nodes, not "
                           "a 20k-node batch")
    out = {}
    for dev, runner in runners.items():
        t0 = time.perf_counter()
        out[dev] = runner.loss_and_grads(batch.to(dev))
        if dev == "cuda":
            torch.cuda.synchronize()
        log(f"card vs CPU: {dev} step (first call) "
            f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    loss_gpu, _, grads_gpu = out["cuda"]
    loss_cpu, _, grads_cpu = out["cpu"]
    loss_err = abs(float(loss_gpu) - float(loss_cpu)) / abs(float(loss_cpu))
    worst, worst_name = 0.0, ""
    for name, g_cpu in grads_cpu.items():
        g_gpu = grads_gpu[name].cpu()
        rel = float((g_gpu - g_cpu).norm() / g_cpu.norm().clamp_min(1e-30))
        if rel > worst:
            worst, worst_name = rel, name
    log(f"card vs CPU, one train step on {int(batch.num_nodes)} nodes "
        f"({int(batch.num_graphs)} graphs): loss {float(loss_gpu):.8f} vs "
        f"{float(loss_cpu):.8f} (relative error {loss_err:.3e}, limit "
        f"{TOL_STEP_LOSS}); worst gradient relative L2 error {worst:.3e} "
        f"({worst_name}, limit {TOL_STEP_GRAD}) over {len(grads_cpu)} "
        "parameters")
    if not loss_err <= TOL_STEP_LOSS or not worst <= TOL_STEP_GRAD:
        raise RuntimeError("the card's train step disagrees with the CPU's")
    return {"loss_relative_error": loss_err,
            "worst_grad_relative_l2": worst, "worst_grad": worst_name}


def profile_phase(runner, steps=5):
    """torch.profiler over `steps` train steps on one 20k-node training
    batch already on the card (dropout on)."""
    from torch.autograd import DeviceType

    batch = next(iter(runner.adapter.batches(runner.train_processed,
                                             False))).to(runner.device)
    for _ in range(3):
        runner.train_step(batch)
    torch.cuda.synchronize()
    # Wall time without the profiler, whose own cost would count as idle.
    t0 = time.perf_counter()
    for _ in range(steps):
        runner.train_step(batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(steps):
            runner.train_step(batch)
        torch.cuda.synchronize()
    # Device-side events only: a CPU operator's self device time repeats
    # the time of the kernels it launched.
    kernels = [(e.key, e.self_device_time_total, e.count)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    kernels.sort(key=lambda k: -k[1])
    busy_us = sum(k[1] for k in kernels)
    result = {
        "nodes": int(batch.num_nodes), "steps": steps,
        "wall_ms_per_step": wall * 1e3 / steps,
        "device_busy_ms_per_step": busy_us / 1e3 / steps,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall,
        "kernels_per_step": sum(k[2] for k in kernels) / steps,
        "top_device_ops": [
            {"name": k[0][:80], "ms_per_step": k[1] / 1e3 / steps,
             "calls_per_step": k[2] / steps} for k in kernels[:12]],
    }
    log(f"profile of a train step ({result['nodes']} nodes): wall "
        f"{result['wall_ms_per_step']:.3f} ms, device busy "
        f"{result['device_busy_ms_per_step']:.3f} ms, idle share "
        f"{result['device_idle_share']:.3f}, "
        f"{result['kernels_per_step']:.0f} kernels per step")
    for k in result["top_device_ops"]:
        log(f"  {k['ms_per_step']:.4f} ms/step, {k['calls_per_step']:.0f} "
            f"calls: {k['name']}")
    return result


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    from ggnn_tpu_torch.ops.kernels import _build, ell_spmm, gather_floor

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    log("tf32: matmul.allow_tf32=False cudnn.allow_tf32=False")

    sources = ("ell_spmm", "gather_floor")
    start = time.perf_counter()
    _build.build_all(sources)
    log(f"build {', '.join(n + '.cu' for n in sources)} (one nvcc each, "
        f"in parallel): {time.perf_counter() - start:.2f} s")
    for name in sources:
        seconds, output = _build.build_info.get(name, (0.0, "prebuilt"))
        log(f"{name}.cu: nvcc {seconds:.2f} s\n{output.strip()}")

    gen = torch.Generator(device=dev).manual_seed(0)
    batches = lane_batches()
    ell = small_ell_layout(dev)
    skewed = skewed_lane(dev)
    records, ell_err = kernel_phase(dev, gen, batches, ell, skewed)
    b2_records, b2_ell_err = backward_kernel_phase(dev, gen, batches, ell,
                                                   skewed)
    registers = {"float4": ell_spmm.registers(True, dev),
                 "scalar": ell_spmm.registers(False, dev)}
    log(f"ell_spmm: segments of more than {ell_spmm.split_edges()} edges "
        f"cut; registers a thread {registers} (B1 and B2 share both "
        "instances)")
    probe = probe_phase(dev, batches)
    log(f"B1 at the 20k-node budget: {records[1]['ms'] * 1e3:.3f} us, "
        f"{records[1]['ms'] / probe['b1_output_zero_ms']:.3f} x the zero_ "
        "of its output")
    work_dir = os.path.join(REPO, "build", "chip_smoke")
    # B3's counter around the serving and training paths, which must not
    # launch it.
    gather_floor.launches = 0
    serving = serving_phase(work_dir)
    b3_serving = gather_floor.launches
    gather_floor.launches = 0
    runner, training = training_phase(os.path.join(work_dir, "train"))
    b3_training = gather_floor.launches
    log(f"B3 launches: serving {b3_serving}, training {b3_training} "
        "(0 expected)")
    if b3_serving or b3_training:
        raise RuntimeError("the serving or training path launched B3")
    card_vs_cpu = card_vs_cpu_phase(os.path.join(work_dir, "step"))
    profile = profile_phase(runner)

    # Each kernel's `launches` sums the main paths' runs (the probe,
    # serving and training), each counted from 0 just before its run.
    main_shape = records[0]
    b2_shape = b2_records[1]          # the training path's 20k-node shape
    # The JAX probe's shape at unroll 8.
    b3_shape = [r for r in probe["shapes"]["probe shape"]
                if r["unroll"] == 8][0]
    kernels = [{
        "name": "gather_segment_sum",
        "route": "cuda",
        "source": "ggnn_tpu_torch/csrc/ell_spmm.cu",
        "replaces": "ggnn_tpu/ops/pallas/ell_spmm.py:51",
        "launches": serving["launches"] + training["launches_b1"],
        "launches_by_path": {"serving": serving["launches"],
                             "training": training["launches_b1"]},
        "max_abs_err": max([r["max_abs_err"] for r in records] + [ell_err]),
        "ms": main_shape["ms"],
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "library_ms": main_shape["library_ms"],
        "registers": registers,
    }, {
        "name": "segment_scatter_sum",
        "route": "cuda",
        "source": "ggnn_tpu_torch/csrc/ell_spmm.cu",
        "replaces": "ggnn_tpu/ops/pallas/ell_spmm.py:101",
        "launches": serving["scatter_launches"] + training["launches_b2"],
        "launches_by_path": {"serving": serving["scatter_launches"],
                             "training": training["launches_b2"]},
        "max_abs_err": max([r["max_abs_err"] for r in b2_records]
                           + [b2_ell_err]),
        "ms": b2_shape["ms"],
        "plain_ms": b2_shape["plain_ms"],
        "bound_ms": b2_shape["bound_ms"],
        "bound_by": b2_shape["bound_by"],
        "library_ms": b2_shape["library_ms"],
        "registers": registers,
    }, {
        "name": "gather_rows",
        "route": "cuda",
        "source": "ggnn_tpu_torch/csrc/gather_floor.cu",
        "replaces": "benchmarks/probes/gather_floor.py:52",
        "launches": probe["launches"] + b3_serving + b3_training,
        "launches_by_path": {"probe": probe["launches"],
                             "serving": b3_serving,
                             "training": b3_training},
        "max_abs_err": max(r["max_abs_err"]
                           for recs in probe["shapes"].values()
                           for r in recs),
        "ms": b3_shape["ms"],
        "plain_ms": b3_shape["plain_ms"],
        "bound_ms": b3_shape["bound_ms"],
        "bound_by": b3_shape["bound_by"],
        "library_ms": b3_shape["library_ms"],
    }]
    device_line = gpu_name_and_power()
    log(json.dumps({"shapes": records, "backward_shapes": b2_records,
                    "split_edges": ell_spmm.split_edges(),
                    "probe": probe, "serving": serving, "training": training,
                    "card_vs_cpu": card_vs_cpu, "profile": profile}))
    log(device_line)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
