#!/usr/bin/env python3
"""Drive the PyTorch port (ggnn_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each raising (and so exiting non-zero) on any failure.

Where the JAX package jits a step, the port replays it (ROADMAP A20):
every train and validation step of `Runner.train()`, `Runner.predict`'s
forward and each Predictor's and artifact's forward is a replay of a
CUDA graph captured once per batch shape. A kernel's counter moves where
its wrapper launches it, so over a call it reads 2 x (the warm-up step
and the capture) the launches of the graphs the call captured, and a
replay counts none; every phase that counts launches over `train()` or a
request holds the counters to that (`Captures`) and each graph's
launches a replay, from its capture, to the step's or forward's
prediction (`check_graphs`, `check_forwards`).

  1. setup — TF32 off for matmuls and cuDNN; build the CUDA kernels from
     ggnn_tpu_torch/csrc into build/kernels/, one nvcc for each source,
     all started together, and beside them the native host packer
     (ggnn_tpu_torch/native/packer.cpp, g++, into build/native/), and
     report the build times; the run fails where the native packer does
     not build or GGNN_TPU_NO_NATIVE is set, so every later phase packs
     as the default config does;
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
     float4 and scalar instances (62 and 51, else the phase fails); and
     the launch floor: a one-element `zero_` and an empty kernel through
     the kernels' `ctypes` launch path, timed as the kernels are;
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
     3,000-graph request, with the kernels' launch counters set to 0
     before each request and read after it (the first request captures
     the envelope's graph, which holds 8 B1 launches a forward and no
     other kernel), each answer held
     against the same checkpoint served on the CPU (rtol = atol = 1e-4:
     8 GRU steps with f32 products in another order), graphs/s of the
     large request and the 1-graph latency;
  5. dense serving — the same for the default `dense` and `blocked`
     models (cuBLAS products, no hand kernel; a graph a bucket): every
     counter 0;
  6. training — `Runner(variant, cfg).train()` on the default device, 3
     epochs of synthetic_molecules(6000, seed=40), validated on
     synthetic_molecules(600, seed=41), the kernels' counters set to 0
     before `train()` and read after it, the train graphs all captured in
     epoch 1: `sparse` with the default config plus
     configs/sparse_tpu.json (20,000-node batches, edge-weight dropout
     0.8; each train graph 8 B1 and 7 B2 launches, each validation graph
     8 B1, no B3); `dense` with the default
     config and the buckets [16, 32] bench.py trains; `blocked` with the
     default config plus configs/blocked_tpu.json (no B1, B2 or B3 for
     either); every loss finite, the last validation loss below that of
     the initial weights; per epoch the losses, MAE, error_ratio,
     graphs/s, the median synchronised train-step time and the seconds
     its captures took (in epoch 1's graphs/s, as JAX's compilation is
     in its first epoch), and the packer
     alone over one epoch (the native one: the phase fails where a
     variant but `async` packed with numpy);
  7. card against CPU — one train step, every keep probability 1.0, from
     the same initial weights on the card and on the CPU, for `sparse`
     on one 20k-node batch and for `dense` and `blocked` on one
     256-graph batch of the V = 32 bucket: loss at rtol 1e-5, every
     parameter's gradient at a relative L2 error <= 1e-4 (f32 sums in
     another order over 8 GRU steps);
  8. dense forward — the device time of one `dense` and one `blocked`
     inference forward and readout at that batch (`time_ms` over 50 and
     over 5 calls, which must agree within 20%) against the least time
     of their products at the f32 rate outside the tensor cores;
  9. profile — `torch.profiler` over train steps of `sparse` on a
     20k-node batch and of `dense` and `blocked` on a 256-graph V = 32
     batch: wall ms, device-busy ms, the device's idle share, the kernel
     count and the top device operations;
 10. weighted kernel — the weighted instance of B1's body (the GCN's
     Â·H, `weighted_gather_segment_sum`) and its transpose
     (`weighted_segment_scatter_sum`) against their plain versions
     (rtol = atol = 1e-5) at the GCN serving envelope (N 2048), a
     20,000-node GCN batch, the skewed 160,000-edge lane with random
     weights and a 5,000-edge hub with weights in multiples of 1/8
     (exact), each with its time, byte bound, plain time and
     `torch.sparse.mm` of the CSR weight matrix, two calls bit-equal, and
     the registers of the weighted instances;
 11. GCN — the default `gcn` and `gcn_blocked` models served (as in 4,
     every counter set to 0 around each request: `num_timesteps` weighted
     launches a `gcn` forward and nothing else, no hand kernel for
     `gcn_blocked`), trained for 3 epochs (`gcn` at 20,000-node batches:
     each train graph a weighted launch a layer and a transpose launch a
     layer but the first; `gcn_blocked` with buckets [16, 32]), one train
     step each on the card against the CPU, and a profile of each;
 12. async — B1 and B2 at the widest substep of a 10,000-node async
     training batch (its compact buffer and (target, type)-sorted send
     lane; B2 over the model's transpose of it) and B1 at the widest
     substep of a served envelope (the plain path's [T*SE] messages in
     stable target order), against their plain versions, two calls
     bit-equal; the default `async` model with `propagation_substeps` 40
     (the synthetic corpus reaches schedule depth 17) served as in 4 (B1
     once a substep of every round, R x S = 160 a forward, nothing else;
     the CPU answers the 1- and 300-graph requests only: its plain path
     runs 160 substeps of [4, 16384, 100] products an envelope); trained
     for 3 epochs with configs/async_tpu.json (10,000-node batches, one
     pack and a batch-order shuffle): each train and validation graph B1
     once a substep of the segmented path, each train graph B2 once a
     substep but the first of round 0, counted from the graph's batch;
     one train step on the card against the CPU, and the same step with
     `async_remat` on against off on the card (gradients within 1e-6, B1
     again in the backward); and a profile;
 13. attention — at the serving envelope and the 20k-node budget, each
     new kernel use against its plain version: `edge_dot` for the scores
     <h[src], h[tgt]> and for the attention weights' gradient (max abs
     error at most 1e-5 of the dots' magnitude, two calls bit-equal),
     the weighted instance with the lane's attention weights over
     target*T + type and, at 20k, over the three weighted transposes of
     a train step (`EdgeDot` backward by a and by b, the aggregation's by
     source), B1 over the flattened per-type lanes (exact, rows of
     eighths: its dump segments sum thousands of pads) and B3 at the
     per-edge route's [T, E], each with its time, bound, plain time and
     library call (`torch.sparse.mm`, `index_select`, and for `edge_dot`
     cuSPARSE's SDDMM, `torch.sparse.sampled_addmm`);
     configs/sparse_attention.json served as in 4 (edge_dot and the
     weighted instance once a step of each forward, nothing else),
     trained for 3 epochs at configs/sparse_tpu.json's 20,000-node
     batches (each train graph 16 edge_dot, 8 weighted and 21 transpose
     launches), one train step on the card against the CPU (the
     attention factors' gradients among those held), two card forwards
     bit-equal, and a profile; and each route besides the combined lane
     (`combined_edge_lanes: false`, `aggregate_first: false`,
     `edges_sorted_by_target: false`, the last on the 20k batch with its
     lanes permuted), attention off and on: a 300-graph request against
     the CPU and one train step against the CPU, each with the launches
     `route_launches` gives (B3 exactly on the per-edge route);
 14. TF1 — the reference TF1 fixtures sparse_default, rgcn,
     sparse_attention_bias, dense_default and gcn_default
     (tests/fixtures/tf1/) written as reference pickles and served on the
     card by `Predictor.from_checkpoint` over their validation corpora:
     the launches each graph holds a forward, the answers against the CPU port and
     against the fixture (the reference's outputs of its first validation
     batch; gcn_default holds none, so its validation epoch's masked MAE),
     each at 1e-4;
 15. server — `server.PredictionServer` on 127.0.0.1, port 0, over the
     default sparse model and over configs/sparse_attention.json: the
     warm-up capturing the envelope's graph (the per-forward count), 20
     sequential one-graph requests (p50 over HTTP), then 16 clients
     sending one-graph requests for 5 s (requests/s, p50, p99, device
     calls, coalesced requests), every answer within 1e-5 of a card
     Predictor's, no launch by the traffic (every call a replay); the
     default model again with `max_coalesced_graphs` 4 (no forward over 4
     graphs);
 16. export — `sparse`, configs/sparse_attention.json, `gcn`, `dense`
     and `async` (40 substeps) exported on the CPU (`export_predictor`:
     seconds, bytes) and loaded on the card (`load_predictor`): the 1- and
     300-graph requests capture graphs holding what a live card forward
     launches, as the live Predictor's do, and answer within 1e-6 of it and within 1e-4 of the artifact on the CPU
     (async: its 1-graph request), the 3,000-graph request timed through
     the artifact and the live Predictor, and the sparse artifact served
     through `server.main(["--checkpoint", ...])` for one request;
 17. bf16 (`compute_dtype: bfloat16`) — each kernel's bf16 instance at
     configs/sparse_wide_bf16.json's width (H 512) against its plain
     version: B1 at the envelope, the 20k-node budget, a hub and the
     skewed lane, B2 at their transposes, the weighted instance with
     attention weights at 20k and its transpose, edge_dot for the scores
     and the weights' gradient at 20k, B3 at the 20k per-edge [4, 32736]
     (within one bf16 ulp of each output element, exact on rows of
     eighths, two calls bit-equal), each with its time, its bound at the
     bf16 byte widths, the plain version's time and the library call's
     (`torch.sparse.mm` and `sampled_addmm` in bf16, or their refusal,
     `index_select`), and the bf16 instances' registers;
     configs/sparse_wide_bf16.json served (1, 300 and 3,000 graphs
     against the CPU at 1e-3; B1's bf16 instance once a step of each
     forward, counted by the bf16 counters) and the same config in f32
     on this card beside it; trained for 3 epochs at its 20,000-node
     batches (each train graph 8 bf16 B1 and 7 bf16 B2, each validation
     graph 8 bf16 B1) and profiled; one train step on the card against the
     CPU at 4,000-node batches (loss 1e-5, gradients 5e-3) for the
     combined lane and for the routes of BF16_ROUTES (each with a
     300-graph request), their bf16 launches as `bf16_route_launches`
     gives; `dense`, `blocked` and `gcn_blocked` in bf16 served and
     stepped against the CPU, the dense forward's time in bf16 against
     f32 and against the bf16 tensor rate; and the bf16 config exported
     on the CPU and served on the card, launching what the live
     Predictor launches;
 18. training extras — `sparse` at configs/sparse_tpu.json over phase 6's
     corpus: 2 epochs uninterrupted; the same with a rolling checkpoint
     every 2 steps (the one at epoch 2, step 2 kept) and every step; the
     run resumed on the card from the kept checkpoint, its parameters
     within 1e-6 of the uninterrupted run's (bit-equality reported),
     graphs/s with a checkpoint every step against none, each run's B1
     and B2 launches (each train graph 8 and 7, each validation graph 8);
     `cli.main(["sparse", "--profile", DIR, ...])` for one epoch, whose
     Chrome trace names B1's and B2's ops twice as often as the counters
     read over the profiled epoch (its graph's warm-up step and capture,
     each op recorded again by the capture's operator recorder) and
     their kernel (`segment_sum_kernel`, shared) as often as the warm-up
     step and the epoch's replays launch it; `Runner.predict` on the card
     over the validation corpus from the best pickle (replays of the
     graph a warm-up call captured, no launch) against the card
     `Predictor` (1e-5) and the CPU Runner (1e-4), and `cli.main([...,
     "--restore",
     best, "--evaluate"])`; a QM9-layout tarball of 40 molecules of
     tests/test_smiles.py's oracle extracted by `ggnn_tpu_torch.data.qm9`
     and trained for one epoch through `cli.main(["sparse", "--data_dir",
     ..., "--checkpoint-every-steps", "1"])` to a finite loss (each CLI
     call's counters 2 x the launches of its Runner's graphs: the CLI
     replays); and whether tensorboardX imported (then the
     run's event files must exist);
 19. native packer — its build (seconds, g++'s version, the library's
     path, the host's cores); each native packer (`sparse` and `gcn` at
     20,000-node budgets, `dense` with the buckets [16, 32], `blocked`,
     `gcn_blocked`, each at its phase-6 or phase-11 training config)
     against the port's numpy packer over one epoch of phase 6's training
     corpus, in eval mode and in training mode from the same RandomState,
     every leaf equal; the packer alone over a training epoch, native
     against numpy, median of 3, in seconds and as a share of the
     variant's median train epoch; the dense family's bf16 adjacency
     (compute_dtype bfloat16) against the f32 one cast; the async corpus
     cache's packer against the flat packer over configs/async_tpu.json's
     training corpus (eval, two training epochs), bit-equal, with both
     packers' times; the default sparse model with `native_pack` on and
     off: the 3,000-graph request's pack and request time, the 1-graph
     latency, the answers equal; the default `dense` model in bf16
     served on the card with the native bf16 adjacency against the CPU
     (TOL_BF16_SERVING, no hand kernel); and `sparse`, `gcn` and `dense`
     trained for 2 epochs with the numpy and the native packer in turns
     (numpy, native, native, numpy): set-up seconds and train graphs/s;
 20. train on device (ROADMAP A18) — (a) every configuration that
     `Runner.train_on_device` takes (`sparse` at configs/sparse_tpu.json,
     `dense` at bench.py's buckets, `gcn`, configs/sparse_attention.json,
     `blocked`, `gcn_blocked`, `async` at configs/async_tpu.json, each
     other route of the sparse GGNN with attention off and on,
     configs/sparse_wide_bf16.json on the combined lane and per edge
     with attention), every keep probability 1.0, on
     synthetic_molecules(1300, seed=42): `train_on_device(2)` against the
     same steps run eagerly on a twin Runner, both under deterministic
     algorithms, each parameter within 1e-5 and the loss at rtol 1e-5,
     then the same in the default mode, and two default-mode eager runs
     bit-equal after 2 epochs (every sum in a fixed order);
     (b) the kernel launches each replay holds, from its graph's capture
     (B1 8 and B2 7 a sparse step, 68 and 67 an async one at 10k nodes,
     the weighted instance 4 + 3 a `gcn` step, edge_dot 16 and the
     weighted 8 + 21 an attention step, B3 8 a per-edge step, bf16
     B1/B2 8/7, 0 for the dense family; `route_launches` for each
     route), the counters over the call equal to 2 x (the warm-up step
     and the capture) each graph's launches (no replay launches a kernel
     eagerly) and the eager twin's to 2 epochs of the replays'; (c) train
     graphs/s, ms a step and idle share through `time_epochs`, in turns
     with the eager Runner epoch (eager, graph; two turns of each until
     PR 16; the eager epoch's steps run by `eager_steps`), for
     `dense` at bench.py's workload (synthetic_molecules(25600, seed=0),
     100 batches in 2 shapes) and for phase 6's `sparse`, `gcn`,
     attention and `async` Runners, the busy ms from a profiled epoch of
     replays; (d) `dense` with edge weights kept at 0.8: graphs against
     eager steps within 1e-5 (the same masks), the validation loss
     falling, a later eager step agreeing, and a dropout mask from the
     Runner's generator fresh every replay and equal to the eager draw;
 21. mesh (ROADMAP A11) — ranks of one `torch.distributed` gloo group
     sharing cuda:0 (`parallel/launch.py:RankPool`, one spawn a world
     size; point-to-point sends copied through the host, which gloo
     needs for CUDA tensors and the phase prints), every keep
     probability 1.0: `sparse` at configs/sparse_tpu.json's 20,000-node
     budget, H 100, at (2,1), and node-sharded at (1,2) and (2,2) under
     each of the alltoall, shift and ragged exchanges; type-TP at (1,2);
     configs/sparse_attention.json node-sharded at (1,2); `gcn` at (1,2)
     and (2,1); `dense`, `blocked`, `gcn_blocked` (one V 32 bucket) and
     `async` (configs/async_tpu.json) at (2,1). Each case: one train step
     of `make_parallel_steps` over the step corpus' first two batches
     against the single-device step over both on the card (loss rtol
     1e-5, every gradient leaf rtol 2e-4 / atol 1e-6), each rank's
     launches as `mesh_step_launches` predicts; 2 epochs of the first
     3,000 of phase 6's training molecules through `Runner(mesh=)`: the
     weights bit-equal across ranks after each epoch, the validation
     loss below the initial weights',
     each rank's counters over `train()` (set to 0 just before it) equal
     to the prediction summed over its steps (a node shard: twice the
     single-device route's launches a propagation step); ms a mesh
     train step beside a single-device step over the same batches, for
     the record only (the ranks share one card: no scaling number).
     Then one rank over `nccl` (its collectives on the world's group):
     `sparse` through `Runner(mesh=make_mesh(1, 1))` for 1 epoch of the
     step corpus against the plain Runner, both under deterministic
     algorithms (1e-6). The type-TP Runner is also saved by every rank
     as an Orbax directory and a pickle (rank 0 writes, the slices
     gathered first);
 22. Orbax checkpoints (ROADMAP A17) — `tensorstore`, `orbax` and
     `zstandard` not importable here, or at least not loaded after the
     phase; the zstd decoder (native/zstd.cpp) built by g++ at the
     script's start. `sparse` at configs/sparse_tpu.json (20,000-node
     batches, H 100, the reference depth) trained 1 epoch by
     `Runner.train()` on phase 6's corpus with a rolling checkpoint
     every 2 steps, the one after step 2 (Adam state, the mid-epoch
     iterator state) saved also as a directory and as a pickle; a new
     `Runner(restore=...)` of each, bit-equal weights, moments and
     counters, each resumed to the end of epoch 2 (B1 and B2 counted:
     each train graph 8 and 7, each validation graph 8), weights, moments
     and losses bit-equal between the formats; `Predictor.from_checkpoint`
     of each answering a 300-graph request bit-equal (B1 8 a forward);
     ms a save and a restore, bytes on disk. The same for
     configs/sparse_wide_bf16.json (its bf16 counters). Phase 21's
     type-TP directory and pickle: the same bits, whole leaves, restored
     into a single-device Runner with the ranks' digest. The committed
     JAX-written directory tests/fixtures/orbax/sparse_h32 read with the
     port's reader, bit-equal to its pickle twin, and served on the card
     as its twin is;
 23. replayed steps (ROADMAP A20) — for every configuration of phase 20
     (each with its own dropout; `dense` without remainder dropping, so
     that the step corpus' 50 validation molecules fill a batch), 2
     epochs of `Runner.train()` on the step corpus with a rolling
     checkpoint every 2 steps, every step a replay, against an eager twin
     (`eager_steps`: the same `train()`, `train_step` and `eval_step`
     called directly): every per-step loss and MAE of both splits and
     every parameter bit-equal; the train graphs after epoch 2 those after
     epoch 1, and every graph count printed; the run resumed from the last
     rolling checkpoint bit-equal; the trained weights served by a
     replayed `Predictor.from_checkpoint` (512 nodes, 64 graphs) and its
     artifact (exported on the CPU, for the variants and attention; for
     `async` phase 16's artifact, whose export takes a minute), the 1- and
     300-graph answers
     bit-equal to their forwards run eagerly, and 16 threads calling the
     Predictor at once answered as serial calls. Then, for the record, one
     turn each, eager then replayed (host clock, synchronised): the
     training epoch's graphs/s and ms a step of phase 6's `sparse` and
     `dense`, phase 11's `gcn`, phase 13's attention and phase 12's
     `async` Runners; the 3,000-graph throughput (median of 3, `async` 1)
     and the 1-graph latency (median of 20) of the seven variants at the
     default envelope; 16 server clients for 3 s (requests/s, p99); and
     the launch floor inside a graph: graphs of 1 and of 100
     `ell_spmm.empty_launch` kernels replayed, beside one empty kernel
     outside a graph.

The last three lines of standard output are the card's name and power
limit (nvidia-smi), one JSON object with the kernels' numbers, and
{"ok": true, "device": {...}}. Without CUDA, or outside a checkout of
the repository, the script fails and prints no result.
"""

import contextlib
import dataclasses
import glob
import itertools
import json
import os
import statistics
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

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
TOL_REMAT = 1e-6           # async step, remat on vs off on the card
HIDDEN = 100
EDGE_TYPES = 4
# The registers a thread of B1's and B2's float4 and scalar instances
# compile to.
B1_REGISTERS = {"float4": 62, "scalar": 51}
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
    (see `time_ms`; None where the library refused the inputs), and the
    call's bound from the bytes it must move and the operations it must
    do."""
    ms, host_ms = time_ms(kernel)
    plain_ms, plain_host_ms = time_ms(plain)
    library_ms, library_host_ms = (time_ms(library) if library is not None
                                   else (None, None))
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


def library_call(label, call, dtype):
    """(call, None) to time `call` as the library yardstick, or (None,
    its error's first line) where the library refuses bf16 inputs
    (cuSPARSE's SDDMM does); a refusal of f32 inputs raises."""
    try:
        call()
        torch.cuda.synchronize()
        return call, None
    except (RuntimeError, NotImplementedError) as err:
        if dtype != torch.bfloat16:
            raise
        log(f"library call for {label} refuses bf16: {err}")
        return None, str(err).strip().splitlines()[0]


def timing_text(rec) -> str:
    def ms(key):   # None: the library refused the call
        return "-" if rec[key] is None else f"{rec[key]:.6f}"

    return (f"device ms={rec['ms']:.6f} bound_us={rec['bound_ms'] * 1e3:.3f}"
            f" ({rec['bound_by']}) plain_ms={rec['plain_ms']:.6f} "
            f"library_ms={ms('library_ms')} | host ms per call: kernel "
            f"{rec['host_ms']:.6f} plain {rec['plain_host_ms']:.6f} library "
            f"{ms('library_host_ms')} | "
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
    from ggnn_tpu_torch.ops.messages import EdgeLanes

    def rand_h(n, h_dim=HIDDEN):
        return torch.randn(n, h_dim, generator=gen, device=dev)

    def check(*args, **kwargs):
        return check_kernel(ell_spmm, "gather_segment_sum", *args, **kwargs)

    records = []
    for label, batch, t_dim in batches:
        n_cap = batch.node_capacity
        b = batch.to(dev)
        offsets = EdgeLanes.combined(b.edge_sources_all, b.edge_types_all,
                                     b.edge_targets_all, t_dim,
                                     n_cap).offsets
        records.append(check(label, rand_h(n_cap), b.edge_sources_all,
                             offsets, n_cap * t_dim))
    records.append(check("hub + empty segments",
                         *hub_case(dev, gen, 23, 4096, 6000, 1234), 4096,
                         exact=True))
    src, types, tgt = skewed
    num_segments = SKEWED_NODES * EDGE_TYPES
    records.append(check(
        "skewed in-degree", eighths(gen, dev, SKEWED_NODES), src,
        EdgeLanes.combined(src, types, tgt, EDGE_TYPES,
                           SKEWED_NODES).offsets,
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
    from ggnn_tpu_torch.ops.messages import EdgeLanes

    def check(*args, **kwargs):
        return check_kernel(ell_spmm, "segment_scatter_sum", *args,
                            **kwargs)

    records = []
    for label, batch, t_dim in batches:
        n_cap = batch.node_capacity
        b = batch.to(dev)
        _, bgather, boff = EdgeLanes.combined(
            b.edge_sources_all, b.edge_types_all, b.edge_targets_all,
            t_dim, n_cap).segment_transpose
        g = torch.randn(n_cap * t_dim, HIDDEN, generator=gen, device=dev)
        records.append(check(f"backward of the {label}", g, bgather, boff,
                             n_cap))
    records.append(check("hub + empty rows",
                         *hub_case(dev, gen, 24, 4096, 4096 * EDGE_TYPES,
                                   2345), 4096, exact=True))
    src, types, tgt = skewed
    _, bgather, boff = EdgeLanes.combined(src, types, tgt, EDGE_TYPES,
                                          SKEWED_NODES).segment_transpose
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


# ------------------------------------------------------ weighted kernel

def check_weighted(name, label, x, idx, w, offsets, num_segments,
                   exact=False):
    """The weighted instance (`weighted_gather_segment_sum`, or over a
    transpose `weighted_segment_scatter_sum`) against its plain version
    on the card at one shape, with two calls bit-equal; returns the
    shape's record. out[s] sums w[e] * x[idx[e]] over the edges e of
    segment s. The bound counts the rows of x that some edge reads (each
    once), the segments' indices, weights and offsets once and the output
    written once, and two operations an edge and column. The library
    yardstick is `torch.sparse.mm` of the CSR weight matrix."""
    from ggnn_tpu_torch.ops.kernels import ell_spmm

    kernel = getattr(ell_spmm, name)
    plain = ell_spmm.weighted_gather_segment_sum_reference
    got = kernel(x, idx, w, offsets, num_segments)
    again = kernel(x, idx, w, offsets, num_segments)
    want = plain(x, idx, w, offsets, num_segments)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise RuntimeError(f"{name} [{label}]: two calls differ")
    err = float((got - want).abs().max().item()) if got.numel() else 0.0
    tol = 0.0 if exact else TOL_KERNEL
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    rows, h_dim = x.shape
    begin, end = int(offsets[0].item()), int(offsets[-1].item())
    if begin != 0:
        raise RuntimeError("the CSR yardstick needs off[0] = 0")
    used = end - begin
    rows_read = int(torch.unique(idx[begin:end]).numel())
    matrix = torch.sparse_csr_tensor(offsets.long(), idx[:end].long(),
                                     w[:end], size=(num_segments, rows))
    torch.testing.assert_close(torch.sparse.mm(matrix, x), want,
                               rtol=TOL_KERNEL, atol=TOL_KERNEL)
    rec = {
        "shape": label, "rows_of_input": rows, "H": h_dim,
        "S": num_segments, "E": int(idx.shape[0]), "edges_used": used,
        "rows_read": rows_read, "max_abs_err": err, "bit_equal_repeat": True,
        **measure(
            lambda: kernel(x, idx, w, offsets, num_segments),
            lambda: plain(x, idx, w, offsets, num_segments),
            lambda: torch.sparse.mm(matrix, x),
            bytes_moved=4 * (rows_read * h_dim + 2 * used
                             + (num_segments + 1) + num_segments * h_dim),
            ops=2 * used * h_dim),
    }
    log(f"kernel {name} [{label}] rows(input)={rows} H={h_dim} "
        f"S={num_segments} E={rec['E']} used={used} rows_read={rows_read}: "
        f"{timing_text(rec)}")
    return rec


def gcn_batches():
    """[(label, GCN batch)]: the serving envelope (a request packed as
    Predictor packs `gcn` at max_nodes=2048, max_graphs=256) and a
    20,000-node batch (capacities planned by the port's packer over a
    synthetic corpus), the training path's batch."""
    from ggnn_tpu_torch.data import packing
    from ggnn_tpu_torch.data.synthetic import synthetic_molecules

    caps = packing.PackCapacities(nodes=2048, edges_per_type=16384,
                                  graphs=256, edges_all=16384)
    proc = packing.preprocess_gcn(synthetic_molecules(300, seed=21), [0],
                                  {}, False)
    envelope = next(packing.pack_gcn_batches(proc, caps.nodes + 1, caps,
                                             HIDDEN, 5, False, None))
    proc = packing.preprocess_gcn(synthetic_molecules(2400, seed=22), [0],
                                  {}, False)
    caps20k = packing.plan_gcn_capacities(proc, 20000)
    log(f"20k-node GCN plan: {caps20k}")
    budget = next(packing.pack_gcn_batches(proc, 20000, caps20k, HIDDEN, 5,
                                           False, None))
    return [("GCN serving envelope", envelope),
            ("20k-node GCN batch", budget)]


def weighted_kernel_phase(dev, gen, skewed, b1_20k):
    """The weighted instance forward and over its transpose at the GCN
    serving envelope, the 20k-node GCN batch, the skewed lane (rows and
    weights random multiples of 1/8: exact) and a hub (exact); its
    registers; and B1 at the 20k-node budget timed again five times."""
    from ggnn_tpu_torch.models.gcn import gcn_edges
    from ggnn_tpu_torch.ops.kernels import ell_spmm
    from ggnn_tpu_torch.ops.segment import segment_offsets

    fwd, bwd = "weighted_gather_segment_sum", "weighted_segment_scatter_sum"
    records, b_records = [], []
    for label, batch in gcn_batches():
        b = batch.to(dev)
        n_cap = b.node_capacity
        src, weights, offsets, transpose = gcn_edges(b, n_cap, True, True)
        x = torch.randn(n_cap, HIDDEN, generator=gen, device=dev)
        records.append(check_weighted(fwd, label, x, src, weights, offsets,
                                      n_cap))
        g = torch.randn(n_cap, HIDDEN, generator=gen, device=dev)
        b_records.append(check_weighted(bwd, f"transpose of the {label}", g,
                                        *transpose, n_cap))
    src, _, tgt = skewed
    w = torch.randint(-8, 9, (src.shape[0],), generator=gen,
                      device=dev).float() / 8
    offsets = segment_offsets(tgt, SKEWED_NODES)
    records.append(check_weighted(
        fwd, "skewed in-degree", eighths(gen, dev, SKEWED_NODES), src, w,
        offsets, SKEWED_NODES, exact=True))
    bgather, bweights, boff = ell_spmm.weighted_transpose_layout(
        src, tgt, w, SKEWED_NODES)
    b_records.append(check_weighted(
        bwd, "transpose of the skewed in-degree",
        eighths(gen, dev, SKEWED_NODES), bgather, bweights, boff,
        SKEWED_NODES, exact=True))
    for seed, name, out in ((28, fwd, records), (29, bwd, b_records)):
        x, idx, offsets = hub_case(dev, gen, seed, 4096, 6000, 1234)
        w = torch.randint(-8, 9, (idx.shape[0],), generator=gen,
                          device=dev).float() / 8
        out.append(check_weighted(name, "hub + empty segments", x, idx, w,
                                  offsets, 4096, exact=True))
    registers = {"float4": ell_spmm.registers(True, dev, weighted=True),
                 "scalar": ell_spmm.registers(False, dev, weighted=True)}
    log(f"weighted instance: registers a thread {registers}")
    b1_again = [time_ms(b1_20k)[0] for _ in range(5)]
    log("B1 at the 20k-node budget, timed again 5 times: "
        + ", ".join(f"{ms * 1e3:.3f} us" for ms in b1_again))
    return {"shapes": records, "transpose_shapes": b_records,
            "registers": registers, "b1_20k_again_ms": b1_again}


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

# The launch counters, in the order of `launch_counts`.
COUNTERS = ("b1", "b2", "b3", "weighted", "weighted_transpose", "edge_dot")
COUNTER_NAMES = "B1/B2/B3/weighted/transpose/edge_dot"
NO_LAUNCH = (0,) * len(COUNTERS)


def launch_counts():
    """(B1, B2, B3, weighted, weighted transpose, edge_dot) launch
    counters."""
    from ggnn_tpu_torch.ops.kernels import edge_dot, ell_spmm, gather_floor
    return (ell_spmm.launches, ell_spmm.scatter_launches,
            gather_floor.launches, ell_spmm.weighted_launches,
            ell_spmm.weighted_scatter_launches, edge_dot.launches)


def bf16_launch_counts():
    """The same six counters of the kernels' bf16 instances alone."""
    from ggnn_tpu_torch.ops.kernels import edge_dot, ell_spmm, gather_floor
    return (ell_spmm.launches_bf16, ell_spmm.scatter_launches_bf16,
            gather_floor.launches_bf16, ell_spmm.weighted_launches_bf16,
            ell_spmm.weighted_scatter_launches_bf16, edge_dot.launches_bf16)


def zero_launch_counts():
    from ggnn_tpu_torch.ops.kernels import edge_dot, ell_spmm, gather_floor
    ell_spmm.launches = ell_spmm.scatter_launches = gather_floor.launches = 0
    ell_spmm.weighted_launches = ell_spmm.weighted_scatter_launches = 0
    edge_dot.launches = 0
    ell_spmm.launches_bf16 = ell_spmm.scatter_launches_bf16 = 0
    ell_spmm.weighted_launches_bf16 = 0
    ell_spmm.weighted_scatter_launches_bf16 = 0
    gather_floor.launches_bf16 = edge_dot.launches_bf16 = 0


def per_request(per_forward):
    return lambda calls: tuple(c * calls for c in per_forward)


# The ops.kernels counters that chip_smoke's six-tuples hold, in order
# (`launch_counts`): the first six of `ggnn_tpu_torch.ops.kernels.COUNTERS`.
KERNEL_COUNTERS = ("ell_spmm.launches", "ell_spmm.scatter_launches",
                   "gather_floor.launches", "ell_spmm.weighted_launches",
                   "ell_spmm.weighted_scatter_launches", "edge_dot.launches")


def held(launches, counts=launch_counts):
    """A CUDA graph's launches a replay ({"module.counter": n}, from the
    counters across its capture) as a six-tuple of `counts`'s counters:
    the f32 ones, or with `bf16_launch_counts` the bf16 instances'."""
    suffix = "_bf16" if counts is bf16_launch_counts else ""
    return tuple(launches.get(k + suffix, 0) for k in KERNEL_COUNTERS)


class Captures:
    """The CUDA graphs that the step caches `caches` (a Runner's
    `train_graphs`, `eval_graphs`, `predict_graphs`, a Predictor's
    `_graphs`) capture from its making on. On the card a step is a
    replay: the kernels' counters move only at a new key's warm-up step
    and its capture, each launching the step's kernels once, and a
    replay counts none."""

    def __init__(self, *caches):
        self.caches = caches
        self.before = [set(c.graphs) for c in caches]

    def new(self):
        """Each cache's new graphs, in capture order."""
        return [[g for k, g in c.graphs.items() if k not in before]
                for c, before in zip(self.caches, self.before)]

    def check(self, label, launched, counts=launch_counts):
        """`launched`, the counters read over a call, against 2 x (the
        warm-up step and the capture) the new graphs' launches: else a
        replay launched a kernel eagerly, or a kernel of the step is not
        in its graph. Returns each cache's new graphs as six-tuples."""
        per_cache = [[held(g.launches, counts) for g in graphs]
                     for graphs in self.new()]
        flat = [t for tuples in per_cache for t in tuples]
        want = (tuple(2 * sum(c) for c in zip(*flat)) if flat
                else NO_LAUNCH)
        if tuple(launched) != want:
            raise RuntimeError(
                f"{label}: the counters read {COUNTER_NAMES} "
                f"{tuple(launched)}, not 2 x (a warm-up step and a capture) "
                f"the launches of the {len(flat)} graphs captured, {want}")
        return per_cache


@contextlib.contextmanager
def cli_runners():
    """Inside the block, the list of the Runners made (by a `cli.main`
    call, whose Runner the caller cannot reach)."""
    from ggnn_tpu_torch.training.runner import Runner

    made, init = [], Runner.__init__

    def recorded(self, *args, **kwargs):
        init(self, *args, **kwargs)
        made.append(self)

    Runner.__init__ = recorded
    try:
        yield made
    finally:
        Runner.__init__ = init


def check_cli_graphs(label, runners, launched, cache):
    """The counters over a `cli.main` call, `launched`, against 2 x the
    launches of every graph its Runners captured, the Runners' `cache`
    ("train_graphs", "eval_graphs" or "predict_graphs") among them: the
    CLI reached the replayed path. Returns the graph counts."""
    graphs = [held(g.launches) for r in runners
              for c in (r.train_graphs, r.eval_graphs, r.predict_graphs)
              for g in c.graphs.values()]
    want = (tuple(2 * sum(c) for c in zip(*graphs)) if graphs
            else NO_LAUNCH)
    counts = [r.graph_counts() for r in runners]
    if (tuple(launched) != want or not runners
            or not all(getattr(r, cache).graphs for r in runners)):
        raise RuntimeError(f"{label}: launches {tuple(launched)}, 2 x its "
                           f"graphs' {want}; graphs {counts}: not the "
                           "replayed path")
    return counts


def check_graphs(label, cache, want, counts=launch_counts):
    """Each graph of a step cache holds `want` launches a replay (a
    six-tuple, or a function of the graph giving one): the per-step
    prediction. Returns the distinct tuples held; at least one graph."""
    got = [held(g.launches, counts) for g in cache.graphs.values()]
    wanted = [want(g) if callable(want) else want
              for g in cache.graphs.values()]
    if not got or got != wanted:
        raise RuntimeError(f"{label}: the {len(got)} graphs hold "
                           f"{COUNTER_NAMES} {got}, expected {wanted}")
    return sorted(set(got))


def served_launches(variant, config):
    """The launches of one serving forward of `config`: B1 once a
    propagation step, or with attention edge_dot and the weighted
    instance; the weighted instance once a GCN layer; B1 once an async
    substep; none on the dense family."""
    if variant in ("dense", "blocked", "gcn_blocked"):
        return NO_LAUNCH
    if variant == "gcn":
        return (0, 0, 0, config["num_timesteps"], 0, 0)
    if variant == "async":
        return (config["propagation_rounds"]
                * config["propagation_substeps"], 0, 0, 0, 0, 0)
    return route_launches("combined", config["use_propagation_attention"],
                          sum(config["layer_timesteps"]), False)


def counted_request(predictor, request, counts=launch_counts):
    """(answer, launches, forward calls, new graphs) of one request, the
    kernels' counters set to 0 just before it and `counts()` read just
    after, held to 2 x the launches of the graphs it captured (their
    six-tuples, the last item)."""
    captures = Captures(predictor._graphs)
    forward_calls = 0
    forward = predictor._forward

    def counted_forward(batch):
        nonlocal forward_calls
        forward_calls += 1
        return forward(batch)

    predictor._forward = counted_forward
    try:
        zero_launch_counts()
        answer = predictor(request)
        torch.cuda.synchronize()
        launched = counts()
    finally:
        del predictor._forward
    (new,) = captures.check(f"{predictor.variant} request of "
                            f"{len(request)} graphs", launched, counts)
    return answer, launched, forward_calls, new


def check_forwards(label, new, per_forward):
    """Each graph a request captured holds one forward's launches."""
    if any(t != tuple(per_forward) for t in new):
        raise RuntimeError(f"{label}: the graphs captured hold "
                           f"{COUNTER_NAMES} {new}, a forward launches "
                           f"{tuple(per_forward)}")


def serving_requests():
    from ggnn_tpu_torch.data.synthetic import synthetic_molecules
    return {n: synthetic_molecules(n, seed=30 + i)
            for i, n in enumerate((1, 300, 3000))}


def random_checkpoint(variant, ckpt_dir, overrides=None, tag=""):
    """The default config of `variant` (with `overrides`) with random
    weights from torch.Generator seed 0, written as a pickle checkpoint
    whose name carries `tag`."""
    from ggnn_tpu_torch.data.loader import DatasetMeta
    from ggnn_tpu_torch.models.base import ModelParams, init_output_heads
    from ggnn_tpu_torch.training.checkpoint import save_checkpoint
    from ggnn_tpu_torch.training.config import default_params_for
    from ggnn_tpu_torch.training.variants import make_adapter

    config = {**default_params_for(variant), **(overrides or {})}
    gen = torch.Generator().manual_seed(0)
    adapter = make_adapter(variant, config, DatasetMeta(
        2048, EDGE_TYPES, config["hidden_size"]))
    params = ModelParams(
        graph=adapter.build_model(gen),
        heads=init_output_heads(gen, config["hidden_size"],
                                config["task_ids"]))
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"{variant}{tag}_random_seed0.pickle")
    save_checkpoint(path, config, params, 0, 0)
    return config, path


def check_and_time_answers(label, predictor, cpu_predictor, requests,
                           answers, cpu_sizes=None, tol=TOL_SERVING):
    """Each request's answer (of the sizes in `cpu_sizes`, all when None)
    held against the CPU's (rtol = atol = `tol`), then graphs/s of the
    3,000-graph request (median of 3) and the 1-graph latency (median of
    20), host clock, synchronised."""
    max_err = 0.0
    for n, req in requests.items():
        got = answers[n]
        if got.shape != (1, n) or not np.isfinite(got).all():
            raise RuntimeError(f"{label}: {n}-graph answer has shape "
                               f"{got.shape} or non-finite values")
        if cpu_sizes is not None and n not in cpu_sizes:
            log(f"{label} {n}-graph request: finite, shape {got.shape}; "
                "not held against the CPU")
            continue
        want = cpu_predictor(req)
        err = float(np.abs(got - want).max())
        max_err = max(max_err, err)
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
        log(f"{label} {n}-graph request: matches CPU port "
            f"(max_abs_err={err:.3e}, tolerance {tol})")
    result = {"max_abs_err_vs_cpu": max_err,
              "requests_held_against_cpu": sorted(
                  n for n in requests
                  if cpu_sizes is None or n in cpu_sizes)}
    if not {1, 3000} <= set(requests):
        return result
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        predictor(requests[3000])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    lat = []
    for _ in range(25):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        predictor(requests[1])
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
    result.update({"graphs_per_s_3000": 3000 / statistics.median(times),
                   "latency_1_graph_ms": statistics.median(lat[5:]) * 1e3})
    log(f"{label}: {result['graphs_per_s_3000']:.1f} graphs/s on the "
        f"3000-graph request (median of 3, host clock, synchronised); "
        f"1-graph latency {result['latency_1_graph_ms']:.3f} ms "
        "(median of 20)")
    return result


def serving_phase(ckpt_dir):
    """The default sparse model served: B1 once a propagation step of
    each forward, and no other kernel (serving builds no transpose
    layout)."""
    from ggnn_tpu_torch.training.config import default_params_for

    return counted_serving("sparse", ckpt_dir, per_request(
        served_launches("sparse", default_params_for("sparse"))))


def counted_serving(variant, ckpt_dir, want, overrides=None,
                    cpu_sizes=None, sizes=None, tag="", tol=TOL_SERVING,
                    counts=launch_counts):
    """The default `variant` (with `overrides`) served from a pickle
    checkpoint on the default device: the kernels' counters set to 0
    before each request and `counts()` read after it, equal to 2 x the
    launches of the graphs the request captured (the first request
    captures the envelope's, or its buckets'), each graph holding
    `want(1)`, one forward's launches; then the answers
    against the CPU's (of the requests in `cpu_sizes`, all when None) at
    `tol` and, when the 1- and 3,000-graph requests are among the `sizes`
    (all three when None), the times."""
    from ggnn_tpu_torch.serving import Predictor

    requests = serving_requests()
    if sizes is not None:
        requests = {n: requests[n] for n in sizes}
    _, path = random_checkpoint(variant, ckpt_dir, overrides, tag)
    predictor = Predictor.from_checkpoint(path, variant)
    if predictor.device.type != "cuda":
        raise RuntimeError(f"default device is {predictor.device}")
    cpu_predictor = Predictor.from_checkpoint(path, variant, device="cpu")
    answers, counted, captured, calls = {}, [], [], 0
    for n, req in requests.items():
        answers[n], launched, forward_calls, new = counted_request(
            predictor, req, counts)
        check_forwards(f"{variant}{tag} serving of {n} graphs", new,
                       want(1))
        counted.append(launched)
        captured.append(len(new))
        calls += forward_calls
    if not captured[0]:
        raise RuntimeError(f"{variant}{tag} serving: the first request "
                           "captured no graph")
    log(f"{variant}{tag} serving: launches {COUNTER_NAMES} around "
        f"the {sorted(requests)}-graph requests {counted}, graphs captured "
        f"{captured} ({want(1)} a forward)")
    return {"forward_calls": calls, "launches_by_request": counted,
            "graphs_captured_by_request": captured,
            "graphs": predictor.graph_count(),
            "launches": [sum(c) for c in zip(*counted)],
            **check_and_time_answers(f"{variant}{tag} serving", predictor,
                                     cpu_predictor, requests, answers,
                                     cpu_sizes, tol)}


def dense_serving_phase(ckpt_dir):
    """The default `dense` and `blocked` models served: no hand kernel
    launches (the dense family runs cuBLAS products)."""
    return {variant: counted_serving(variant, ckpt_dir,
                                     per_request(NO_LAUNCH))
            for variant in DENSE_VARIANTS}


# ------------------------------------------------------------ training

def resolved_config(variant, config_file=None, overrides=None,
                    hidden=HIDDEN):
    from ggnn_tpu_torch.training.config import resolve_config
    config = resolve_config(
        variant, None if config_file is None
        else os.path.join(REPO, "configs", config_file),
        json.dumps(overrides or {}))
    assert config["hidden_size"] == hidden
    return config


# Each variant's training configuration: the sparse default plus the
# 20,000-node batches of configs/sparse_tpu.json; the dense default with
# the two buckets bench.py trains (bench.py:77-83); the blocked default
# plus configs/blocked_tpu.json.
TRAIN_CONFIGS = {
    "sparse": ("sparse_tpu.json", {}),
    "dense": (None, {"dense_bucket_sizes": [16, 32]}),
    "blocked": ("blocked_tpu.json", {}),
    # GCN_DEFAULTS at the sparse training batch's 20,000 nodes (the
    # reference's 100,000 would give about one step an epoch).
    "gcn": (None, {"batch_size": 20000}),
    "gcn_blocked": (None, {"dense_bucket_sizes": [16, 32]}),
    # configs/async_tpu.json (10,000-node batches, one pack and a
    # batch-order shuffle); the synthetic corpus reaches schedule depth
    # 17, past the default 15 substeps (QM9 fits in 15).
    "async": ("async_tpu.json", {"propagation_substeps": 40}),
}
DENSE_VARIANTS = ("dense", "blocked")
GCN_VARIANTS = ("gcn", "gcn_blocked")
# Variants whose batches are edge lists under a node budget.
EDGE_LIST_VARIANTS = ("sparse", "gcn", "async")
ASYNC_SERVING = {"propagation_substeps": 40}
NO_DROPOUT = {"edge_weight_dropout_keep_prob": 1.0,
              "graph_state_dropout_keep_prob": 1.0,
              "out_layer_dropout_keep_prob": 1.0}


def train_config(variant, overrides=None):
    config_file, extra = TRAIN_CONFIGS[variant]
    return resolved_config(variant, config_file, {**extra,
                                                  **(overrides or {})})


def train_run(variant, epochs, corpus, log_dir, config=None,
              counts=launch_counts):
    """`epochs` epochs of `variant` through `Runner.train()` on the
    default device, each train and validation step a replay of a CUDA
    graph: the kernels' counters set to 0 just before `train()` and
    `counts()` read just after, equal to 2 x the launches of the graphs
    `train()` captured (`Captures`); the train graphs all captured in
    epoch 1; every loss finite, the last validation loss below that of
    the initial weights; per epoch the losses, MAE, error_ratio,
    graphs/s, the median synchronised train-step time (a replay, its
    batch's copy in included) and the seconds its captures took; and
    the packer alone over one training epoch. `config` (with its
    num_epochs) replaces the variant's training config."""
    from ggnn_tpu_torch.training.runner import Runner

    config = ({**config, "num_epochs": epochs} if config is not None
              else train_config(variant, {"num_epochs": epochs}))
    train, valid = corpus
    t0 = time.perf_counter()
    runner = Runner(variant, config, train_data=train, valid_data=valid,
                    log_dir=log_dir, quiet=True)
    setup_s = time.perf_counter() - t0
    if runner.device.type != "cuda":
        raise RuntimeError(f"default device is {runner.device}")
    init_loss, init_accs, _, _, _ = runner.run_epoch(
        "initial validation", runner.valid_processed, False)
    log(f"{variant} training: Runner set-up {setup_s:.2f} s (preprocess "
        f"and plan of {len(train) + len(valid):,} graphs); validation loss "
        f"of the initial weights {init_loss:.6f} (MAE {init_accs[0]:.6f})")

    # Synchronised step times, per epoch; the captures' seconds and the
    # train graphs after each training epoch.
    step_times, epoch_marks, capture_s, train_graphs = [], [], [], []
    caches = (runner.train_graphs, runner.eval_graphs)
    run_epoch = runner.run_epoch

    def timed_step(batch):
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = caches[0](batch)
        torch.cuda.synchronize()
        step_times.append(time.perf_counter() - start)
        return out

    def timed_capture(capture):
        def timed(new):
            torch.cuda.synchronize()
            start = time.perf_counter()
            capture(new)
            torch.cuda.synchronize()
            if capture_s:
                capture_s[-1] += time.perf_counter() - start
        return timed

    def marked_epoch(name, processed, is_training):
        if is_training:
            epoch_marks.append(len(step_times))
            capture_s.append(0.0)
        out = run_epoch(name, processed, is_training)
        if is_training:
            train_graphs.append(len(caches[0].graphs))
        return out

    for cache in caches:
        cache.capture = timed_capture(cache.capture)
    runner.train_graphs, runner.run_epoch = timed_step, marked_epoch
    captures = Captures(*caches)
    zero_launch_counts()
    t0 = time.perf_counter()
    history = runner.train()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launched = counts()
    b1, b2, b3, w_fwd, w_bwd, dots = launched
    runner.train_graphs = caches[0]
    del runner.run_epoch
    for cache in caches:
        del cache.capture
    new_train, new_eval = captures.check(f"{variant} training", launched,
                                         counts)
    log(f"{variant} training: {len(history)} epochs, {runner.train_step_id} "
        f"train steps, {runner.valid_step_id} validation batches in "
        f"{train_s:.2f} s; graphs {runner.graph_counts()}, train graphs "
        f"after each epoch {train_graphs}, captured in train() "
        f"{len(new_train)} train and {len(new_eval)} validation; launches "
        f"B1 {b1}, B2 {b2}, B3 {b3}, weighted {w_fwd}, weighted transpose "
        f"{w_bwd}, edge_dot {dots} (2 x the new graphs')")
    if not new_train or len(set(train_graphs)) != 1:
        raise RuntimeError(f"{variant} training: train graphs after each "
                           f"epoch {train_graphs}: not all captured in "
                           "epoch 1")

    epoch_marks.append(len(step_times))
    epochs_out = []
    for i, entry in enumerate(history):
        tr, va = entry["train_results"], entry["valid_results"]
        times = step_times[epoch_marks[i]:epoch_marks[i + 1]]
        rec = {"epoch": entry["epoch"], "train_loss": tr[0],
               "train_mae": tr[1][0], "train_error_ratio": tr[2][0],
               "train_graphs_per_s": tr[3], "valid_loss": va[0],
               "valid_mae": va[1][0], "valid_error_ratio": va[2][0],
               "valid_graphs_per_s": va[3], "train_steps": len(times),
               "median_train_step_ms": statistics.median(times) * 1e3,
               "capture_seconds": capture_s[i]}
        epochs_out.append(rec)
        log(f"{variant} training epoch {rec['epoch']}: train loss "
            f"{tr[0]:.6f} MAE {tr[1][0]:.6f} error_ratio {tr[2][0]:.4f} "
            f"{tr[3]:.1f} graphs/s | valid loss {va[0]:.6f} MAE "
            f"{va[1][0]:.6f} error_ratio {va[2][0]:.4f} {va[3]:.1f} "
            f"graphs/s | median train step {rec['median_train_step_ms']:.3f}"
            f" ms (synchronised, {len(times)} steps) | captures "
            f"{capture_s[i]:.3f} s of the epoch")
        values = [tr[0], va[0], *tr[1], *va[1]]
        if not np.isfinite(values).all():
            raise RuntimeError(f"{variant} epoch {rec['epoch']}: "
                               "non-finite loss")
    if not epochs_out[-1]["valid_loss"] < init_loss:
        raise RuntimeError(
            f"{variant}: validation loss after training "
            f"{epochs_out[-1]['valid_loss']} is not below the initial "
            f"{init_loss}")
    # The packer alone over one epoch's training split (the Runner runs
    # it in a prefetch thread beside the steps): the native one where the
    # config packs natively, which every variant but async must.
    packer = packer_kind(runner)
    if variant != "async" and config.get("native_pack", True) \
            and packer != "native":
        raise RuntimeError(f"{variant} training packed with {packer}, not "
                           "the native packer")
    t0 = time.perf_counter()
    packed = sum(1 for _ in runner.adapter.batches(
        runner.train_processed, True, np.random.RandomState(0)))
    pack_s = time.perf_counter() - t0
    epoch_s = len(train) / statistics.median(
        e["train_graphs_per_s"] for e in epochs_out)
    log(f"{variant} training: the {packer} packer alone packs one epoch "
        f"({packed} batches) in {pack_s:.3f} s, {pack_s / epoch_s:.1%} of "
        f"the median train epoch's {epoch_s:.3f} s")
    return runner, {
        "launches_b1": b1, "launches_b2": b2, "launches_b3": b3,
        "launches_weighted": w_fwd, "launches_weighted_transpose": w_bwd,
        "launches_edge_dot": dots,
        "pack_seconds_per_epoch": pack_s, "packer": packer,
        "train_epoch_seconds_median": epoch_s,
        "train_steps": runner.train_step_id,
        "valid_batches": runner.valid_step_id,
        "graphs": runner.graph_counts(), "train_graphs_by_epoch": train_graphs,
        "graphs_captured_in_train": {"train": new_train,
                                     "validation": new_eval},
        "initial_valid_loss": init_loss, "train_seconds": train_s,
        "setup_seconds": setup_s, "epochs": epochs_out}


def packer_kind(runner) -> str:
    """The packer a Runner's training split went through: "native" (the
    C++ library), "numpy" or, for `async`, "async numpy"."""
    from ggnn_tpu_torch.data import native_pack

    if runner.variant == "async":
        return "async numpy"
    native_kinds = (native_pack.SparseProcessed, native_pack.DenseProcessed,
                    native_pack.GCNProcessed)
    return ("native" if isinstance(runner.train_processed, native_kinds)
            else "numpy")


def check_runner_graphs(label, runner, step, forward,
                        counts=launch_counts):
    """Each train graph of `runner` holds `step` launches a replay and
    each validation graph `forward` (six-tuples, or functions of the
    graph giving one)."""
    held_by = {"train": check_graphs(f"{label}, train graphs",
                                     runner.train_graphs, step, counts),
               "validation": check_graphs(f"{label}, validation graphs",
                                          runner.eval_graphs, forward,
                                          counts)}
    log(f"{label}: launches a replay {COUNTER_NAMES} {held_by}")
    return held_by


def training_phase(corpus, log_dir):
    """The sparse variant at the 20k-node budget: each train graph holds
    8 B1 and 7 B2 launches, each validation graph 8 B1, no B3."""
    runner, result = train_run("sparse", 3, corpus, log_dir)
    assert runner.config["batch_size"] == 20000
    assert runner.config["edge_weight_dropout_keep_prob"] == 0.8
    steps = sum(runner.config["layer_timesteps"])
    result["launches_a_replay"] = check_runner_graphs(
        "sparse training", runner,
        route_launches("combined", False, steps, True),
        route_launches("combined", False, steps, False))
    if not (result["launches_b1"] and result["launches_b2"]):
        raise RuntimeError("the training path did not launch B1 and B2")
    return runner, result


def dense_training_phase(corpus, log_dir):
    """3 epochs of each dense-family variant: no B1, B2 or B3 launch."""
    runners, results = {}, {}
    for variant in DENSE_VARIANTS:
        runners[variant], results[variant] = train_run(
            variant, 3, corpus, os.path.join(log_dir, variant))
        check_runner_graphs(f"{variant} training", runners[variant],
                            NO_LAUNCH, NO_LAUNCH)
        counts = [results[variant][f"launches_{k}"] for k in COUNTERS]
        if any(counts):
            raise RuntimeError(f"{variant} training launched "
                               f"{COUNTER_NAMES} {counts} times")
    return runners, results


def gcn_serving_phase(ckpt_dir):
    """The default `gcn` model served: `num_timesteps` weighted launches
    a forward and no other kernel; `gcn_blocked`: no hand kernel."""
    from ggnn_tpu_torch.training.config import default_params_for

    return {variant: counted_serving(variant, ckpt_dir, per_request(
                served_launches(variant, default_params_for(variant))))
            for variant in GCN_VARIANTS}


def gcn_training_phase(corpus, log_dir):
    """3 epochs of each GCN variant. `gcn` at 20,000-node batches: each
    train graph holds the weighted kernel once a layer and its transpose
    once a layer but the first, each validation graph the weighted
    kernel once a layer, no B1, B2 or B3; `gcn_blocked`: no hand
    kernel."""
    runners, results = {}, {}
    for variant in GCN_VARIANTS:
        runners[variant], result = train_run(
            variant, 3, corpus, os.path.join(log_dir, variant))
        results[variant] = result
        step = forward = NO_LAUNCH
        if variant == "gcn":
            config = runners[variant].config
            assert config["batch_size"] == 20000
            layers = config["num_timesteps"]
            step, forward = (0, 0, 0, layers, layers - 1, 0), \
                (0, 0, 0, layers, 0, 0)
        result["launches_a_replay"] = check_runner_graphs(
            f"{variant} training", runners[variant], step, forward)
        counts = [result[f"launches_{k}"] for k in COUNTERS]
        if variant == "gcn" and not all(counts[3:5]):
            raise RuntimeError(f"gcn training launched {counts}")
    return runners, results


# ------------------------------------------------------------ async

def async_launches(batch, config):
    """(B1 launches of one forward, B2 launches of one train step) of an
    async batch. The segmented path launches B1 once a substep and B2
    once a substep but the first of round 0, whose buffer holds only
    features; a batch without segments (its segment plan overflowed)
    takes the plain path: R x S substeps, each with a gradient through
    the edge weights."""
    if batch.seg_rounds is None:
        steps = config["propagation_rounds"] * config["propagation_substeps"]
        return steps, steps
    steps = sum(seg.old_compact.shape[0] for segs in batch.seg_rounds
                for seg in segs)
    return steps, steps - 1


def is_async_10k_batch(batch):
    return batch.seg_rounds is not None and int(batch.num_nodes) >= 9000


def async_batches():
    """(training batch, serving batch) of `async` at 4 rounds and 40
    substeps: the first batch of synthetic_molecules(2400, seed=22) under
    the 10,000-node budget of configs/async_tpu.json and its own plan,
    and a 300-graph request packed as the Predictor packs it (max_nodes
    2048, max_graphs 256, no plan: the plain path)."""
    from ggnn_tpu_torch.data import async_schedule
    from ggnn_tpu_torch.data.synthetic import synthetic_molecules

    rounds, substeps = 4, ASYNC_SERVING["propagation_substeps"]

    def first_batch_of(n, seed, budget, caps=None):
        proc = async_schedule.preprocess_async(
            synthetic_molecules(n, seed=seed), EDGE_TYPES, True, rounds,
            substeps, [0], {}, False)
        if caps is None:
            caps = async_schedule.plan_async_capacities(proc, EDGE_TYPES,
                                                        budget, rounds)
            log(f"10k-node async plan: {caps}")
        return next(async_schedule.pack_async_batches(
            proc, EDGE_TYPES, budget, caps, rounds, substeps, HIDDEN, 5,
            False))

    serving_caps = async_schedule.AsyncCapacities(
        nodes=2048, graphs=256, initial_nodes=2048, sending_edges=16384,
        receiving_nodes=2048)
    return (first_batch_of(2400, 22, 10000),
            first_batch_of(300, 21, serving_caps.nodes + 1, serving_caps))


def check_repeat(name, label, *args):
    """Two calls of a B1/B2 wrapper give the same bits."""
    from ggnn_tpu_torch.ops.kernels import ell_spmm

    kernel = getattr(ell_spmm, name)
    if not torch.equal(kernel(*args), kernel(*args)):
        raise RuntimeError(f"{name} [{label}]: two calls differ")


def async_kernel_phase(dev, gen, train, serve):
    """B1 and B2 at the substep of the 10k-node async batch with the most
    real edges, over the layouts the model makes once per batch (B1 over
    the compact buffer and the (target, type)-sorted send lane, B2 over
    its source-sorted transpose into the buffer), and B1 at the served
    envelope's substep with the most real messages (the plain path's
    [T*SE, H] messages in stable target order), each against its plain
    version, two calls bit-equal."""
    from ggnn_tpu_torch.models.async_ggnn import (compact_dump_row,
                                                  plain_layouts,
                                                  segment_layouts)
    from ggnn_tpu_torch.ops.kernels import ell_spmm

    b = train.to(dev)
    rows = compact_dump_row(b) + 1
    layouts = segment_layouts(b, EDGE_TYPES, True)
    edges, r, i, k = max(
        (int(offsets[k, -1]), r, i, k)
        for r, segs in enumerate(layouts)
        for i, (offsets, _, _) in enumerate(segs)
        for k in range(offsets.shape[0]))
    seg = b.seg_rounds[r][i]
    offsets, bgather, boff = layouts[r][i]
    rc_cap, sea_cap = seg.old_compact.shape[1], seg.send_compact.shape[1]
    num_segments = rc_cap * EDGE_TYPES
    substeps = sum(o.shape[0] for segs in layouts for o, _, _ in segs)
    log(f"async 10k batch: {int(b.num_nodes)} nodes, {int(b.num_graphs)} "
        f"graphs, {substeps} substeps, buffer rows {rows}; widest substep "
        f"(round {r}, segment {i}, step {k}): {edges} edges, RC {rc_cap}, "
        f"SEA {sea_cap}")
    buf = torch.randn(rows, HIDDEN, generator=gen, device=dev)
    fwd_args = (buf, seg.send_compact[k], offsets[k], num_segments)
    b1 = check_kernel(ell_spmm, "gather_segment_sum", "async substep",
                      *fwd_args)
    check_repeat("gather_segment_sum", "async substep", *fwd_args)
    g = torch.randn(num_segments, HIDDEN, generator=gen, device=dev)
    bwd_args = (g, bgather[k], boff[k], rows)
    b2 = check_kernel(ell_spmm, "segment_scatter_sum",
                      "backward of the async substep", *bwd_args)
    check_repeat("segment_scatter_sum", "backward of the async substep",
                 *bwd_args)

    s = serve.to(dev)
    perm, p_offsets, _, _ = plain_layouts(s, False)
    real = p_offsets[..., -1]
    r, step = divmod(int(torch.argmax(real)), real.shape[1])
    rc_cap = s.receiving_nodes.shape[-1]
    msgs = torch.randn(perm.shape[-1], HIDDEN, generator=gen, device=dev)
    serve_args = (msgs, perm[r, step], p_offsets[r, step], rc_cap)
    log(f"async serving envelope: {int(s.num_graphs)} graphs, widest "
        f"substep (round {r}, step {step}): {int(real[r, step])} of "
        f"{perm.shape[-1]} message slots real, RC {rc_cap}")
    b1_serving = check_kernel(ell_spmm, "gather_segment_sum",
                              "async serving substep", *serve_args)
    check_repeat("gather_segment_sum", "async serving substep", *serve_args)
    return {"b1": b1, "b2": b2, "b1_serving": b1_serving,
            "substeps": substeps, "buffer_rows": rows}


def async_serving_phase(ckpt_dir):
    """The default `async` model with 40 substeps served: the plain path
    launches B1 once a substep of every round and nothing else. The CPU
    answers the 1- and 300-graph requests only: its plain path runs R x S
    = 160 substeps of [4, 16384, 100] products an envelope."""
    from ggnn_tpu_torch.training.config import default_params_for

    config = {**default_params_for("async"), **ASYNC_SERVING}
    return counted_serving("async", ckpt_dir,
                           per_request(served_launches("async", config)),
                           overrides=ASYNC_SERVING, cpu_sizes=(1, 300))


def async_training_phase(corpus, log_dir):
    """3 epochs of `async` with configs/async_tpu.json: each train graph
    holds B1 once a substep and B2 once a substep but the first of round
    0, each validation graph B1 once a substep, counted from the graph's
    batch; the batches those the Runner ran (packed once, the same every
    epoch); no B3 and no weighted launch."""
    runner, result = train_run("async", 3, corpus, log_dir)
    config = runner.config
    assert config["num_nodes"] == 10000
    assert config["async_epoch_shuffle"] == "batches"
    epochs = len(result["epochs"])
    splits = {name: list(runner.adapter.batches(processed, False))
              for name, processed in (("train", runner.train_processed),
                                      ("valid", runner.valid_processed))}
    if (epochs * len(splits["train"]) != result["train_steps"]
            or epochs * len(splits["valid"]) != result["valid_batches"]):
        raise RuntimeError("the async batches are not those the Runner ran")
    per_batch = {name: [async_launches(b, config) for b in batches]
                 for name, batches in splits.items()}
    plain = sum(b.seg_rounds is None for batches in splits.values()
                for b in batches)
    got = [result[f"launches_{k}"] for k in COUNTERS]
    log(f"async training: substeps per train batch "
        f"{[b1 for b1, _ in per_batch['train']]}, per validation batch "
        f"{[b1 for b1, _ in per_batch['valid']]} ({plain} batches on the "
        f"plain path); launches {COUNTER_NAMES} {got}")
    result["launches_a_replay"] = check_runner_graphs(
        "async training", runner,
        lambda g: async_launches(g.static, config) + (0, 0, 0, 0),
        lambda g: (async_launches(g.static, config)[0], 0, 0, 0, 0, 0))
    if not all(got[:2]):
        raise RuntimeError(f"async training launched the kernels {got} "
                           "times")
    result["substeps_per_batch"] = {name: [b1 for b1, _ in v]
                                    for name, v in per_batch.items()}
    result["plain_path_batches"] = plain
    return runner, result


def async_remat_step(runner, batch, loss, grads, launches):
    """The card's async train step again with `async_remat` on: each
    substep recomputed in the backward from a buffer that no later write
    changes, so the same loss and gradients within TOL_REMAT, and B1
    launched once more a substep."""
    runner.config["async_remat"] = True
    zero_launch_counts()
    loss_remat, _, grads_remat = runner.loss_and_grads(
        batch.to(runner.device))
    torch.cuda.synchronize()
    got = launch_counts()
    del runner.config["async_remat"]
    want = (2 * launches[0],) + tuple(launches[1:])
    loss_err = abs(float(loss_remat) - float(loss)) / abs(float(loss))
    worst = max(float((grads_remat[n] - g).abs().max())
                for n, g in grads.items())
    log(f"async train step on the card, remat on vs off: loss relative "
        f"error {loss_err:.3e}, worst gradient max abs error {worst:.3e} "
        f"(limit {TOL_REMAT}); launches {COUNTER_NAMES} {got}, "
        f"expected {want}")
    if not loss_err <= TOL_REMAT or not worst <= TOL_REMAT or got != want:
        raise RuntimeError("the async step with remat on disagrees with "
                           "remat off")
    return {"loss_relative_error": loss_err, "worst_grad_max_abs": worst,
            "launches": list(got)}


def first_batch(runner, want):
    """The first batch of the runner's training split, unshuffled, that
    `want` accepts."""
    for batch in runner.adapter.batches(runner.train_processed, False):
        if want(batch):
            return batch
    raise RuntimeError("no batch of the wanted shape")


def is_20k_batch(batch):
    return int(batch.num_nodes) >= 19000


def is_full_v32_batch(batch):
    return int(batch.num_graphs) == 256 and batch.num_vertices == 32


def card_vs_cpu_phase(variant, corpus, pick, log_dir, config=None,
                      transform=None, want=None, label=None,
                      repeat_forward=False, loss_tol=TOL_STEP_LOSS,
                      grad_tol=TOL_STEP_GRAD, counts=launch_counts):
    """One train step, keep probabilities 1.0, on the card and on the
    CPU from the same initial weights (both Runners draw them from a CPU
    generator seeded with random_seed), on the batch `pick` accepts
    (passed through `transform` if given): the loss at `loss_tol`
    (relative), each gradient at a relative L2 error of `grad_tol`.
    `config` replaces the variant's training config, `want` the
    launches expected of a step (`counts()` read after it), `label` the
    variant's name in the log and the log directory; `repeat_forward`
    also holds two card forwards of the batch bit-equal."""
    from ggnn_tpu_torch.training.runner import Runner

    label = label or variant
    config = dict(config or train_config(variant, {"num_epochs": 1}))
    config.update({k: v for k, v in NO_DROPOUT.items() if k in config})
    train, valid = corpus
    runners = {dev: Runner(variant, dict(config), train_data=train,
                           valid_data=valid,
                           log_dir=os.path.join(log_dir, label, dev),
                           quiet=True, device=dev)
               for dev in ("cuda", "cpu")}
    batch = first_batch(runners["cpu"], pick)
    if transform is not None:
        batch = transform(batch)
    out = {}
    for dev, runner in runners.items():
        t0 = time.perf_counter()
        zero_launch_counts()
        out[dev] = runner.loss_and_grads(batch.to(runner.device))
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = counts()
        log(f"card vs CPU: {label} {dev} step (first call) "
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
    what = (f"{int(batch.num_nodes)} nodes" if variant in EDGE_LIST_VARIANTS
            else f"V = {batch.num_vertices}")
    log(f"card vs CPU, one {label} train step on {what} "
        f"({int(batch.num_graphs)} graphs): loss {float(loss_gpu):.8f} vs "
        f"{float(loss_cpu):.8f} (relative error {loss_err:.3e}, limit "
        f"{loss_tol}); worst gradient relative L2 error {worst:.3e} "
        f"({worst_name}, limit {grad_tol}) over {len(grads_cpu)} "
        f"parameters; launches {COUNTER_NAMES} {launches}")
    if not loss_err <= loss_tol or not worst <= grad_tol:
        raise RuntimeError(f"the card's {label} train step disagrees "
                           "with the CPU's")
    # A `gcn` step: the weighted kernel once a layer forward, its
    # transpose once a layer but the first (whose input needs no
    # gradient); no hand kernel on the dense family.
    layers = config.get("num_timesteps")
    if want is not None:
        want = tuple(want)
    elif variant == "gcn":
        want = (0, 0, 0, layers, layers - 1, 0)
    elif variant == "async":
        want = async_launches(batch, config) + (0, 0, 0, 0)
    elif variant != "sparse":
        want = NO_LAUNCH
    if want is not None and launches != want:
        raise RuntimeError(f"the {label} train step launched "
                           f"{launches}, expected {want}")
    result = {"loss_relative_error": loss_err,
              "worst_grad_relative_l2": worst, "worst_grad": worst_name,
              "launches": list(launches), "parameters": sorted(grads_cpu)}
    if repeat_forward:
        model = runners["cuda"].params.graph
        on_card = batch.to(runners["cuda"].device)
        with torch.no_grad():
            first, second = model(on_card), model(on_card)
        torch.cuda.synchronize()
        diff = float((first - second).abs().max())
        result["forward_repeat_max_abs_diff"] = diff
        log(f"card: two {label} forwards on the same batch differ by at "
            f"most {diff:.3e} (0 = bit-equal)")
        if diff != 0.0:
            raise RuntimeError(f"two {label} forwards on the card differ")
    if variant == "async":
        result["remat"] = async_remat_step(runners["cuda"], batch, loss_gpu,
                                           grads_gpu, launches)
    return result


def profile_phase(runner, batch, steps=5, label=None):
    """torch.profiler over `steps` train steps on one training batch
    already on the card (the variant's dropout on); `label` names the
    run (the variant by default)."""
    from torch.autograd import DeviceType

    batch = batch.to(runner.device)
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
    shape = (f"{int(batch.num_nodes)} nodes"
             if hasattr(batch, "num_nodes") else
             f"{int(batch.num_graphs)} graphs, V = {batch.num_vertices}")
    label = label or runner.variant
    result = {
        "variant": label, "batch": shape, "steps": steps,
        "wall_ms_per_step": wall * 1e3 / steps,
        "device_busy_ms_per_step": busy_us / 1e3 / steps,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall,
        "kernels_per_step": sum(k[2] for k in kernels) / steps,
        "top_device_ops": [
            {"name": k[0][:80], "ms_per_step": k[1] / 1e3 / steps,
             "calls_per_step": k[2] / steps} for k in kernels[:12]],
    }
    log(f"profile of a {label} train step ({shape}): wall "
        f"{result['wall_ms_per_step']:.3f} ms, device busy "
        f"{result['device_busy_ms_per_step']:.3f} ms, idle share "
        f"{result['device_idle_share']:.3f}, "
        f"{result['kernels_per_step']:.0f} kernels per step")
    for k in result["top_device_ops"]:
        log(f"  {k['ms_per_step']:.4f} ms/step, {k['calls_per_step']:.0f} "
            f"calls: {k['name']}")
    return result


def dense_forward_flops(model, batch):
    """(message, cell) operations (2 per multiply-add) of the products
    of one DenseGGNN forward: per step the bmm with the adjacency and the
    [B*V, T*H] x [T*H, H] transform (bf16 under compute_dtype bfloat16),
    and the cell's products (each 2-D cell weight used once per row;
    f32 always). The default configs have no attention."""
    b, t, v, _ = batch.adjacency.shape
    h, rows = model.hidden_size, b * v
    if model.extended:
        stages = [(n, layer.cell) for n, layer in zip(model.layer_timesteps,
                                                      model.layers)]
    else:
        stages = [(model.num_timesteps, model.cell)]
    messages = cells = 0
    for steps, cell in stages:
        cell_weights = sum(p.numel() for p in cell.parameters()
                           if p.dim() == 2)
        messages += steps * (2 * b * v * t * v * h + 2 * rows * t * h * h)
        cells += steps * 2 * rows * cell_weights
    return messages, cells


def dense_forward_phase(runners, message_ops_per_s=None, rate="f32 SIMT"):
    """Device time of one inference forward and readout of each dense
    variant at a full 256-graph batch of the V = 32 bucket (CUDA events,
    `time_ms`), against the least time its products need: the message
    products at `message_ops_per_s` (by default the f32 rate outside the
    tensor cores: TF32 is off; `rate` names it), the cell's at the f32
    rate. A call launches 80-200
    kernels, so 50 of them overflow the launch queue; `time_ms` queues
    them in groups that fit, and its time over 50 calls must agree with
    that over 5 (which fit in one group) within 20%."""
    results = {}
    for variant, runner in runners.items():
        batch = first_batch(runner, is_full_v32_batch).to(runner.device)
        model, heads = runner.params.graph, runner.params.heads

        def forward():
            with torch.inference_mode():
                return model.readout(heads, runner.task_ids, model(batch),
                                     batch)

        ms, host_ms = time_ms(forward)
        ms_5_calls = time_ms(forward, iters=5)[0]
        message_flops, cell_flops = dense_forward_flops(model, batch)
        flops = message_flops + cell_flops
        bound_ms = (message_flops / (message_ops_per_s or F32_OPS_PER_S)
                    + cell_flops / F32_OPS_PER_S) * 1e3
        results[variant] = {"gflop": flops / 1e9,
                            "message_gflop": message_flops / 1e9, "ms": ms,
                            "ms_5_calls": ms_5_calls, "host_ms": host_ms,
                            "bound_ms": bound_ms,
                            "share_of_bound": bound_ms / ms}
        log(f"{variant} forward + readout at 256 graphs, V = 32: device "
            f"{ms:.4f} ms over 50 calls, {ms_5_calls:.4f} ms over 5 (host "
            f"{host_ms:.4f} ms a call), {flops / 1e9:.3f} GFLOP of "
            f"products ({message_flops / 1e9:.3f} of messages at "
            f"{(message_ops_per_s or F32_OPS_PER_S) / 1e12:.0f} TFLOP/s, "
            f"{rate}; the cell's at {F32_OPS_PER_S / 1e12:.0f}), bound "
            f"{bound_ms:.4f} ms: {bound_ms / ms:.1%} of the bound")
        if abs(ms - ms_5_calls) > 0.2 * ms_5_calls:
            raise RuntimeError(f"time_ms of the {variant} forward: "
                               f"{ms} ms over 50 calls, {ms_5_calls} over 5")
    return results

# ------------------------------------------ attention and the A15 routes

ATTENTION_FILE = "sparse_attention.json"
# The sparse GGNN's routes besides the combined lane, each with the
# config keys that select it (ggnn_tpu/models/sparse_ggnn.py:214-258).
ROUTES = {"per-type": {"combined_edge_lanes": False},
          "per-edge": {"aggregate_first": False},
          "unsorted": {"edges_sorted_by_target": False}}


def config_keys(name):
    with open(os.path.join(REPO, "configs", name)) as f:
        return json.load(f)


def attention_config(overrides=None):
    """configs/sparse_attention.json (attention, edge bias, state dropout
    0.95) at configs/sparse_tpu.json's 20,000-node batches, with
    `overrides`."""
    return resolved_config("sparse", ATTENTION_FILE, {
        **config_keys("sparse_tpu.json"), **(overrides or {})})


def route_launches(route, attention, steps, train):
    """The launches of B1, B2, B3, the weighted instance, its transpose
    and edge_dot in one forward (`train` False) or one train step of a
    sparse GGNN of `steps` propagation steps on `route` ("combined",
    "per-type", "unsorted" or "per-edge"). Forward: the scores are one
    edge_dot a step; the aggregate-first routes sum through B1, or with
    attention through the weighted instance; the per-edge route gathers
    with B3, scales the messages and sums through B1. Backward, the
    first step's input (node features) needs no gradient: the
    aggregation's transpose (B2, or the weighted transpose) and the
    scores' two weighted launches run from the second step on, the
    weights' gradient (edge_dot) at every step, the per-edge
    aggregation's B2 at every step (the messages depend on W)."""
    s, per_edge = steps, route == "per-edge"
    dots = s if attention else 0
    if not train:
        if per_edge:
            return (s, 0, s, 0, 0, dots)
        return (0, 0, 0, s, 0, s) if attention else (s, 0, 0, 0, 0, 0)
    if per_edge:
        return (s, 2 * s - 1, s, 0, 2 * (s - 1) if attention else 0, dots)
    if attention:
        return (0, 0, 0, s, 3 * (s - 1), 2 * s)
    return (s, s - 1, 0, 0, 0, 0)


def sampled_dots(x, a, y, b):
    """The library's SDDMM for edge_dot: a CSR pattern over y's rows
    (rows b, columns a) of the real pairs, sorted by (b, a) and built
    here, outside the timed call, and the call
    `torch.sparse.sampled_addmm(pattern, y, x.T)`, whose k-th value is
    <y[b_k], x[a_k]>. Returns (call, order): `order` maps the call's
    values back to the pairs' positions."""
    from ggnn_tpu_torch.ops.segment import segment_offsets

    real = torch.nonzero((b >= 0) & (b < y.shape[0])).squeeze(1)
    rows, cols = b[real].long(), a[real].long()
    perm = torch.argsort(rows * x.shape[0] + cols)
    rows, cols = rows[perm], cols[perm]
    pattern = torch.sparse_csr_tensor(
        segment_offsets(rows, y.shape[0]).long(), cols,
        torch.zeros(rows.shape[0], dtype=x.dtype, device=x.device),
        size=(y.shape[0], x.shape[0]))
    xt = x.t()
    return (lambda: torch.sparse.sampled_addmm(pattern, y, xt, beta=0.0),
            real[perm])


def check_edge_dot(label, x, a, y, b):
    """edge_dot (f32 or bf16 rows) against its plain version on the card
    at one shape: f32 dots, max abs error at most TOL_KERNEL of their
    magnitude (f32 sums in another order), two calls bit-equal, the pads
    (b out of range) 0. The bound counts each row that some pair reads
    once (x and y the same table: the union of both ids), the ids once
    and one float an edge written, and two operations an element of the
    real pairs. The library call is cuSPARSE's SDDMM over the real pairs
    (`sampled_dots`), held to the same tolerance, or its refusal of the
    rows' dtype."""
    from ggnn_tpu_torch.ops.kernels import edge_dot

    got = edge_dot.edge_dot(x, a, y, b)
    again = edge_dot.edge_dot(x, a, y, b)
    want = edge_dot.edge_dot_reference(x, a, y, b)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise RuntimeError(f"edge_dot [{label}]: two calls differ")
    real = (b >= 0) & (b < y.shape[0])
    if got.dtype != torch.float32 or got[~real].any():
        raise RuntimeError(f"edge_dot [{label}]: dots of {got.dtype}, or "
                           "a pad is not 0")
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    if not err <= TOL_KERNEL * scale:
        raise RuntimeError(f"edge_dot [{label}]: max abs error {err} past "
                           f"{TOL_KERNEL} x {scale}")
    call, order = sampled_dots(x, a, y, b)
    library, refused = library_call(f"edge_dot [{label}]", call, x.dtype)
    lib_err = None
    if library is not None:
        lib_err = float((library().values().float()
                         - want[order]).abs().max())
        if not lib_err <= TOL_KERNEL * scale:
            raise RuntimeError(f"sampled_addmm [{label}]: max abs error "
                               f"{lib_err} past {TOL_KERNEL} x {scale}")
    h_dim = x.shape[1]
    if x is y:
        rows = int(torch.unique(torch.cat([a, b[real]])).numel())
    else:
        rows = (int(torch.unique(a).numel())
                + int(torch.unique(b[real]).numel()))
    edges, used = int(a.shape[0]), int(real.sum())
    rec = {"shape": label, "E": edges, "real_pairs": used, "H": h_dim,
           "rows_read": rows, "max_abs_err": err, "dot_scale": scale,
           "bit_equal_repeat": True, "library_max_abs_err": lib_err,
           "library_refused": refused,
           **measure(lambda: edge_dot.edge_dot(x, a, y, b),
                     lambda: edge_dot.edge_dot_reference(x, a, y, b),
                     library,
                     bytes_moved=(x.element_size() * rows * h_dim
                                  + 4 * 3 * edges),
                     ops=2 * used * h_dim)}
    log(f"kernel edge_dot [{label}] {x.dtype} E={edges} real={used} "
        f"H={h_dim} rows_read={rows}: {timing_text(rec)}")
    return rec


def check_gather(label, h, src):
    """B3 (`gather_rows`, f32 or bf16 rows) at the per-edge route's
    [T, E] shape and its widest unroll dividing E, equal to its plain
    version (a copy); the bound counts the rows some id reads, the ids
    and the output once; the library call is one `index_select`."""
    from ggnn_tpu_torch.ops.kernels import gather_floor

    unroll = gather_floor.widest_unroll(src.shape[1])
    got = gather_floor.gather_rows(h, src, unroll)
    want = gather_floor.gather_rows_reference(h, src)
    torch.cuda.synchronize()
    if got.dtype != h.dtype or not torch.equal(got, want):
        raise RuntimeError(f"gather_rows [{label}] differs from its plain "
                           "version")
    flat = src.reshape(-1)
    rows, h_dim = int(torch.unique(flat).numel()), h.shape[1]
    rec = {"shape": label, "T": src.shape[0], "E": src.shape[1],
           "unroll": unroll, "H": h_dim, "rows_read": rows,
           "max_abs_err": 0.0, "library_refused": None,
           **measure(lambda: gather_floor.gather_rows(h, src, unroll),
                     lambda: gather_floor.gather_rows_reference(h, src),
                     lambda: torch.index_select(h, 0, flat),
                     bytes_moved=(h.element_size() * (rows * h_dim
                                                      + flat.shape[0] * h_dim)
                                  + 4 * flat.shape[0]),
                     ops=0)}
    log(f"kernel gather_rows [{label}] {h.dtype} T={src.shape[0]} "
        f"E={src.shape[1]} unroll={unroll} rows_read={rows}: "
        f"{timing_text(rec)}")
    return rec


def attention_kernel_phase(dev, gen, batches):
    """At the serving envelope and the 20k-node budget, each kernel of
    the new paths against its plain version: edge_dot for the scores
    <h[src], h[tgt]> over the combined lane and for the attention
    weights' gradient <h[src], g[target*T + type]>; the weighted instance
    with the lane's attention weights over target*T + type, and at 20k over
    the three weighted transposes of an attention train step (`EdgeDot`
    backward by a and by b, the aggregation's by source); B1 over the
    flattened per-type lanes (composite id t*(N+1) + target, the pads in
    the dump segments; rows of eighths, exact); B3 at the per-edge
    route's [T, E]."""
    from ggnn_tpu_torch.ops.kernels import edge_dot, ell_spmm
    from ggnn_tpu_torch.ops.messages import (
        EdgeLanes, propagation_attention_weights_combined)

    out = {"edge_dot": [], "edge_dot_gradient": [], "weighted": [],
           "weighted_transposes": [], "per_type_b1": [], "gather_rows": []}
    for label, batch, t_dim in batches:
        b = batch.to(dev)
        n = b.node_capacity
        lanes = EdgeLanes.combined(b.edge_sources_all, b.edge_types_all,
                                   b.edge_targets_all, t_dim, n)
        h = torch.randn(n, HIDDEN, generator=gen, device=dev)
        out["edge_dot"].append(check_edge_dot(
            f"scores, {label}", h, b.edge_sources_all, h,
            b.edge_targets_all))
        g = torch.randn(n * t_dim, HIDDEN, generator=gen, device=dev)
        out["edge_dot_gradient"].append(check_edge_dot(
            f"weights' gradient, {label}", h, b.edge_sources_all, g,
            lanes.segments))
        factors = torch.rand(t_dim, generator=gen, device=dev) + 0.5
        with torch.no_grad():
            att = propagation_attention_weights_combined(
                h, b.edge_sources_all, b.edge_targets_all, b.edge_mask_all,
                b.edge_types_all, factors, n, lanes)
        out["weighted"].append(check_weighted(
            "weighted_gather_segment_sum", f"attention weights, {label}", h,
            b.edge_sources_all, att, lanes.offsets, n * t_dim))
        if n >= 20000:
            # The weighted transposes of an attention train step (ops/
            # attention.py): EdgeDot's backward by a and by b, and the
            # aggregation's by source, each weighted by a gradient.
            ds = torch.randn(lanes.src.shape[0], generator=gen, device=dev)
            for name, order, table in (
                    ("EdgeDot backward by a", lanes.source_pairs, h),
                    ("EdgeDot backward by b", lanes.target_pairs, h),
                    ("aggregation's by source", lanes.segment_transpose, g)):
                ws = ds if order.perm is None else ds[order.perm].contiguous()
                out["weighted_transposes"].append(check_weighted(
                    "weighted_segment_scatter_sum", f"{name}, {label}",
                    table, order.ids, ws, order.offsets,
                    order.offsets.shape[0] - 1))
        # The dump segments sum thousands of pads' copies of row 0, whose
        # f32 rounding depends on the order past 1e-5: rows of eighths
        # make every partial sum exact, so the kernel must equal its
        # plain version.
        typed = EdgeLanes.typed(b.edge_sources, b.edge_targets, n)
        out["per_type_b1"].append(check_kernel(
            ell_spmm, "gather_segment_sum", f"per-type lanes, {label}",
            eighths(gen, dev, n), typed.src, typed.offsets,
            t_dim * (n + 1), exact=True))
        out["gather_rows"].append(check_gather(f"per-edge [T, E], {label}",
                                               h, b.edge_sources))
    out["edge_dot_registers"] = {
        "float4": edge_dot.registers(True, dev),
        "scalar": edge_dot.registers(False, dev)}
    log(f"edge_dot: registers a thread {out['edge_dot_registers']}")
    return out


def permuted_lanes(batch, seed=44):
    """The batch with each type's lane (pads included) permuted by a
    seeded permutation: no longer target-sorted."""
    import dataclasses

    rng = np.random.default_rng(seed)
    perms = np.stack([rng.permutation(batch.edge_sources.shape[1])
                      for _ in range(batch.edge_sources.shape[0])])
    return dataclasses.replace(batch, **{
        name: np.take_along_axis(np.asarray(getattr(batch, name)), perms,
                                 axis=1)
        for name in ("edge_sources", "edge_targets", "edge_mask")})


def attention_serving_phase(ckpt_dir):
    """configs/sparse_attention.json served (random weights, factors at
    their initial ones): edge_dot and the weighted instance once a
    propagation step of each forward, and nothing else."""
    steps = sum(attention_config()["layer_timesteps"])
    return counted_serving(
        "sparse", ckpt_dir,
        per_request(route_launches("combined", True, steps, False)),
        overrides=config_keys(ATTENTION_FILE), tag="_attention")


def attention_training_phase(corpus, log_dir):
    """3 epochs of configs/sparse_attention.json at 20,000-node batches:
    each train and validation graph holds the launches `route_launches`
    gives a train step and a forward, B1, B2 and B3 none."""
    config = attention_config()
    runner, result = train_run("sparse", 3, corpus, log_dir, config=config)
    assert runner.config["use_propagation_attention"]
    assert runner.config["batch_size"] == 20000
    steps = sum(config["layer_timesteps"])
    result["launches_a_replay"] = check_runner_graphs(
        "attention training", runner,
        route_launches("combined", True, steps, True),
        route_launches("combined", True, steps, False))
    return runner, result


def routes_phase(step_corpus, ckpt_dir, step_dir):
    """Each route besides the combined lane, attention off and on: a
    300-graph request served on the card against the CPU and one train
    step on the 20k-node batch (its lanes permuted for the unsorted
    route) on the card against the CPU, each with its launches."""
    steps = sum(attention_config()["layer_timesteps"])
    results = {}
    for route, keys in ROUTES.items():
        for attention in (False, True):
            label = f"{route}, attention {'on' if attention else 'off'}"
            overrides = {**keys, "use_propagation_attention": attention}
            serving = counted_serving(
                "sparse", ckpt_dir,
                per_request(route_launches(route, attention, steps, False)),
                overrides={**config_keys(ATTENTION_FILE), **overrides},
                sizes=(300,), tag=f"_{route}_{int(attention)}")
            step = card_vs_cpu_phase(
                "sparse", step_corpus, is_20k_batch, step_dir,
                config=attention_config({**overrides, "num_epochs": 1}),
                transform=permuted_lanes if route == "unsorted" else None,
                want=route_launches(route, attention, steps, True),
                label=f"sparse ({label})")
            results[label] = {"serving": serving, "train_step": step}
    return results


# ------------------------------ TF1 pickles, the server, the artifacts

# The reference TF1 fixtures served from pickles (tests/fixtures/tf1/).
TF1_CASES = ("sparse_default", "rgcn", "sparse_attention_bias",
             "dense_default", "gcn_default")
TF1_ENVELOPE = dict(max_nodes=512, max_graphs=64, annotation_size=5)
TOL_ARTIFACT = 1e-6        # artifact vs live Predictor on the card
TOL_SERVER = 1e-5          # an HTTP answer vs the Predictor's
SERVER_CLIENTS = 16
SERVER_SECONDS = 5.0
CAPPED_SECONDS = 2.0


def tf1_pickle(case, ckpt_dir):
    """The fixture's weights written as a reference TF1 pickle
    (chem_tensorflow.py:309-323): (path, meta, the fixture's outputs)."""
    import pickle

    data = np.load(os.path.join(REPO, "tests", "fixtures", "tf1",
                                f"{case}.npz"))
    meta = json.loads(str(data["meta"]))
    weights = {k[2:]: data[k] for k in data.files if k.startswith("w/")}
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"tf1_{case}.pickle")
    with open(path, "wb") as f:
        pickle.dump({"params": meta["config"], "weights": weights,
                     "train_step": 0, "valid_step": 0}, f)
    return path, meta, np.asarray(data["output"], np.float32).reshape(-1)


def tf1_phase(ckpt_dir):
    """Each TF1 fixture as a reference pickle, served on the card over
    its validation corpus: each graph captured holds `served_launches`,
    one forward's launches, and the counters 2 x theirs; the answers against the CPU port (1e-4) and against the fixture: the
    reference's outputs of its first validation batch (last task), or,
    where the fixture holds none (gcn_default), its validation epoch's
    masked MAE, each at 1e-4."""
    from ggnn_tpu_torch.data.synthetic import synthetic_molecules
    from ggnn_tpu_torch.serving import Predictor

    results = {}
    for case in TF1_CASES:
        path, meta, ref_out = tf1_pickle(case, ckpt_dir)
        variant = meta["variant"]
        card = Predictor.from_checkpoint(path, variant, **TF1_ENVELOPE)
        if card.device.type != "cuda":
            raise RuntimeError(f"default device is {card.device}")
        cpu = Predictor.from_checkpoint(path, variant, device="cpu",
                                        **TF1_ENVELOPE)
        corpus = meta["corpus"]
        valid = synthetic_molecules(corpus["n_valid"],
                                    seed=corpus["seed"] + 1,
                                    num_targets=corpus["num_targets"])
        got, counts, calls, new = counted_request(card, valid)
        check_forwards(f"TF1 {case}", new, served_launches(variant,
                                                           card.config))
        want = cpu(valid)
        err_cpu = float(np.abs(got - want).max())
        np.testing.assert_allclose(got, want, rtol=TOL_SERVING,
                                   atol=TOL_SERVING)
        if ref_out.size:
            graphs = list(range(len(valid)))
            if variant in ("dense", "blocked", "gcn_blocked"):
                graphs = card._dense_batches(valid, 5)[0][
                    :int(card.config["batch_size"])]
            g = meta["batch_num_graphs"]
            mine = got[-1, graphs[:g]]
            reference = ref_out[:g]
        else:
            targets = np.asarray([[v["targets"][k][0] for v in valid]
                                  for k in card.task_ids], np.float32)
            mine = np.abs(got - targets).mean(axis=1)
            reference = np.asarray(meta["valid_accuracies"], np.float32)
        err_ref = float(np.abs(mine - reference).max())
        np.testing.assert_allclose(mine, reference, rtol=TOL_SERVING,
                                   atol=TOL_SERVING)
        results[case] = {
            "variant": variant, "graphs": len(valid), "launches": counts,
            "forward_calls": calls, "graphs_captured": len(new),
            "max_abs_err_vs_cpu": err_cpu,
            "max_abs_err_vs_fixture": err_ref,
            "fixture_holds": "outputs" if ref_out.size else "valid MAE"}
        log(f"TF1 {case} ({variant}): {len(valid)} graphs served on the "
            f"card, {len(new)} graphs captured, launches {COUNTER_NAMES} "
            f"{counts}; max abs err vs CPU "
            f"{err_cpu:.3e}, vs the fixture's "
            f"{results[case]['fixture_holds']} {err_ref:.3e}")
    return results


def http_predict(base, graphs):
    """(answer [K, n], seconds) of one POST /predict."""
    import urllib.request

    req = urllib.request.Request(
        f"{base}/predict", data=json.dumps({"graphs": graphs}).encode(),
        headers={"Content-Type": "application/json"})
    start = time.perf_counter()
    with urllib.request.urlopen(req, timeout=120) as r:
        out = np.asarray(json.load(r)["outputs"], np.float32)
    return out, time.perf_counter() - start


def http_health(base):
    import urllib.request

    with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
        return json.load(r)


def percentile_ms(seconds, q):
    return float(np.percentile(np.asarray(seconds), q)) * 1e3


def load_clients(base, pool, want, seconds, clients=SERVER_CLIENTS):
    """`clients` threads, each sending one-graph requests of the pool
    (client i its graphs i, i + clients, ...) for `seconds`: requests,
    requests/s, p50 and p99 latency, and the worst error against `want`
    [K, len(pool)]."""
    import threading

    latencies, errors, failures = [], [], []
    lock = threading.Lock()
    start = threading.Barrier(clients + 1)

    def client(i):
        start.wait(timeout=60)
        deadline = time.perf_counter() + seconds
        k = i
        try:
            while time.perf_counter() < deadline:
                idx = k % len(pool)
                out, took = http_predict(base, [pool[idx]])
                err = float(np.abs(out[:, 0] - want[:, idx]).max())
                with lock:
                    latencies.append(took)
                    errors.append(err)
                k += clients
        except Exception as exc:  # raised below, in the main thread
            failures.append(repr(exc))

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(clients)]
    for t in threads:
        t.start()
    start.wait(timeout=60)
    t0 = time.perf_counter()
    for t in threads:
        t.join(timeout=seconds + 120)
    wall = time.perf_counter() - t0
    if failures:
        raise RuntimeError(f"server clients failed: {failures[:3]}")
    return {"clients": clients, "requests": len(latencies),
            "requests_per_s": len(latencies) / wall,
            "p50_ms": percentile_ms(latencies, 50),
            "p99_ms": percentile_ms(latencies, 99),
            "max_abs_err": max(errors)}


def server_phase(ckpt_dir):
    """A `PredictionServer` on 127.0.0.1, port 0, over the default sparse
    model and over configs/sparse_attention.json (random weights): its
    warm-up, which captures the envelope's graph (the counters 2 x its
    launches, `served_launches` a forward); one client sending 20
    sequential one-graph requests (p50 over HTTP), then 16 clients
    sending one-graph requests for 5 s (requests/s, p50, p99, device
    calls and coalesced requests from /healthz), every answer within
    1e-5 of another card Predictor's on the same graphs, and no kernel
    launched by the traffic (every device call a replay); and, for the
    default model, 16 clients for 2 s with `max_coalesced_graphs` 4: no
    forward over more than 4 graphs."""
    from ggnn_tpu_torch.data.synthetic import synthetic_molecules
    from ggnn_tpu_torch.server import PredictionServer
    from ggnn_tpu_torch.serving import Predictor

    pool = synthetic_molecules(400, seed=52)
    results = {}
    for label, overrides in (("sparse", None),
                             ("sparse_attention",
                              config_keys(ATTENTION_FILE))):
        _, path = random_checkpoint("sparse", ckpt_dir, overrides,
                                    tag=f"_server_{label}")
        predictor = Predictor.from_checkpoint(path, "sparse")
        want = Predictor.from_checkpoint(path, "sparse")(pool)
        per_forward = served_launches("sparse", predictor.config)
        server = PredictionServer(predictor, port=0)
        captures = Captures(predictor._graphs)
        zero_launch_counts()
        server.warmup()
        torch.cuda.synchronize()
        warm_counts = launch_counts()
        (new,) = captures.check(f"{label} server warm-up", warm_counts)
        check_forwards(f"{label} server warm-up", new, per_forward)
        if len(new) != 1:
            raise RuntimeError(f"{label} server: the warm-up captured "
                               f"{len(new)} graphs, not the envelope's")
        server.start()
        host, port = server.address
        base = f"http://{host}:{port}"
        try:
            zero_launch_counts()
            sequential, seq_err = [], 0.0
            for i in range(20):
                out, took = http_predict(base, [pool[i]])
                sequential.append(took)
                seq_err = max(seq_err, float(np.abs(out[:, 0]
                                                    - want[:, i]).max()))
            torch.cuda.synchronize()
            seq_counts = launch_counts()
            if seq_counts != NO_LAUNCH:
                raise RuntimeError(f"{label} server: 20 sequential requests "
                                   f"launched {seq_counts}: not replays")
            before = http_health(base)
            zero_launch_counts()
            load = load_clients(base, pool, want, SERVER_SECONDS)
            torch.cuda.synchronize()
            counts = launch_counts()
            after = http_health(base)
        finally:
            server.shutdown()
        calls = after["device_calls"] - before["device_calls"]
        coalesced = (after["coalesced_requests"]
                     - before["coalesced_requests"])
        if counts != NO_LAUNCH or predictor.graph_count() != 1:
            raise RuntimeError(
                f"{label} server: {calls} device calls launched "
                f"{COUNTER_NAMES} {counts} and left "
                f"{predictor.graph_count()} graphs: not replays of the "
                "warm-up's")
        if not calls < load["requests"]:
            raise RuntimeError(f"{label} server: {calls} device calls for "
                               f"{load['requests']} requests: no coalescing")
        worst = max(seq_err, load["max_abs_err"])
        if worst > TOL_SERVER:
            raise RuntimeError(f"{label} server: an answer is {worst:.3e} "
                               "off the Predictor's")
        results[label] = {
            "warmup_launches": warm_counts,
            "sequential_p50_ms": percentile_ms(sequential, 50),
            "sequential_launches": seq_counts, **load,
            "device_calls": calls, "coalesced_requests": coalesced,
            "graphs_per_device_call": load["requests"] / calls,
            "launches": counts, "max_abs_err_vs_predictor": worst}
        log(f"{label} server: 1 client p50 "
            f"{results[label]['sequential_p50_ms']:.3f} ms; "
            f"{SERVER_CLIENTS} clients {load['requests']} requests in "
            f"{SERVER_SECONDS} s, {load['requests_per_s']:.1f} requests/s, "
            f"p50 {load['p50_ms']:.3f} ms, p99 {load['p99_ms']:.3f} ms, "
            f"{calls} device calls, {coalesced} coalesced requests; "
            f"launches {COUNTER_NAMES} at the warm-up {warm_counts}, by the "
            f"traffic {counts}; max abs err vs the Predictor {worst:.3e}")
        if label == "sparse":
            results["sparse_capped"] = capped_server(predictor, pool, want)
    return results


def capped_server(predictor, pool, want):
    """16 clients for 2 s against a server with `max_coalesced_graphs`
    4: every forward packs at most 4 graphs."""
    from ggnn_tpu_torch.server import PredictionServer

    sizes = []
    forward = predictor._forward

    def recorded(batch):
        sizes.append(int(batch.num_graphs))
        return forward(batch)

    server = PredictionServer(predictor, port=0, max_coalesced_graphs=4)
    server.warmup()
    server.start()
    host, port = server.address
    predictor._forward = recorded
    try:
        load = load_clients(f"http://{host}:{port}", pool, want,
                            CAPPED_SECONDS)
    finally:
        del predictor._forward
        server.shutdown()
    if not sizes or max(sizes) > 4 or load["max_abs_err"] > TOL_SERVER:
        raise RuntimeError(f"capped server: forwards of {sorted(set(sizes))}"
                           f" graphs, max abs err {load['max_abs_err']:.3e}")
    log(f"sparse server, max_coalesced_graphs 4: {load['requests']} "
        f"requests, {len(sizes)} forwards of at most {max(sizes)} graphs, "
        f"{load['requests_per_s']:.1f} requests/s, p50 "
        f"{load['p50_ms']:.3f} ms, p99 {load['p99_ms']:.3f} ms")
    return {**load, "forwards": len(sizes), "max_graphs_a_forward":
            max(sizes)}


# label -> (variant, config overrides): the artifacts exported.
EXPORTED = {"sparse": ("sparse", None),
            "sparse_attention": ("sparse", "attention"),
            "gcn": ("gcn", None), "dense": ("dense", None),
            "async": ("async", ASYNC_SERVING)}


def timed_pair(first, second, request, repeats):
    """Median seconds of `repeats` synchronised calls of each predictor
    on `request`, in turns first, second, second, first, ... so that a
    drift of the host's pace reaches both alike."""
    times = ([], [])
    for i in range(2 * repeats):
        which = (i + i // 2) % 2
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (first, second)[which](request)
        torch.cuda.synchronize()
        times[which].append(time.perf_counter() - t0)
    return statistics.median(times[0]), statistics.median(times[1])


def export_phase(ckpt_dir):
    """Each of EXPORTED (the default configs, random weights) exported on
    the CPU (`export_predictor` of a CPU Predictor: seconds, bytes) and
    loaded on the card (`load_predictor`): the 1- and 300-graph requests
    through the artifact capture what the live card Predictor captures,
    each graph holding `served_launches`, one forward's launches (the
    counters 2 x the graphs'), their answers within 1e-6 of the live
    card Predictor's and within 1e-4 of the artifact on the CPU (async:
    the 1-graph request only, its plain path takes seconds an envelope
    on the CPU); the 3,000-graph request timed through the artifact and
    the live Predictor in turns (A B B A ..., median of 3 each; async 1);
    and the sparse artifact
    served through `server.main(["--checkpoint", ...])` for one
    request."""
    from ggnn_tpu_torch.export import export_predictor, load_predictor
    from ggnn_tpu_torch.serving import Predictor

    requests = serving_requests()
    results = {}
    for label, (variant, overrides) in EXPORTED.items():
        if overrides == "attention":
            overrides = config_keys(ATTENTION_FILE)
        _, path = random_checkpoint(variant, ckpt_dir, overrides,
                                    tag=f"_export_{label}")
        cpu = Predictor.from_checkpoint(path, variant, device="cpu")
        artifact = os.path.join(ckpt_dir, f"{label}.ggnnx")
        t0 = time.perf_counter()
        export_predictor(cpu, artifact)
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        card = load_predictor(artifact)
        load_s = time.perf_counter() - t0
        if card.device.type != "cuda" or card.model is not None:
            raise RuntimeError(f"{label} artifact on {card.device}")
        cpu_artifact = load_predictor(artifact, device="cpu")
        live = Predictor.from_checkpoint(path, variant)
        per_forward = served_launches(variant, live.config)
        rec = {"export_s": export_s, "load_s": load_s,
               "bytes": os.path.getsize(artifact), "requests": {}}
        for n in (1, 300):
            got, counts, calls, new = counted_request(card, requests[n])
            want, live_counts, _, live_new = counted_request(live,
                                                             requests[n])
            check_forwards(f"{label} artifact, {n} graphs", new,
                           per_forward)
            if counts != live_counts or len(new) != len(live_new):
                raise RuntimeError(
                    f"{label} artifact, {n} graphs: launched "
                    f"{COUNTER_NAMES} {counts} ({len(new)} graphs "
                    f"captured), the live Predictor {live_counts} "
                    f"({len(live_new)})")
            err_live = float(np.abs(got - want).max())
            np.testing.assert_allclose(got, want, rtol=TOL_ARTIFACT,
                                       atol=TOL_ARTIFACT)
            err_cpu = None
            if variant != "async" or n == 1:
                cpu_want = cpu_artifact(requests[n])
                err_cpu = float(np.abs(got - cpu_want).max())
                np.testing.assert_allclose(got, cpu_want, rtol=TOL_SERVING,
                                           atol=TOL_SERVING)
            rec["requests"][n] = {"launches": counts, "forward_calls": calls,
                                  "graphs_captured": len(new),
                                  "max_abs_err_vs_live": err_live,
                                  "bit_equal_to_live": err_live == 0.0,
                                  "max_abs_err_vs_cpu_artifact": err_cpu}
        repeats = 1 if variant == "async" else 3
        artifact_s, live_s = timed_pair(card, live, requests[3000], repeats)
        rec["artifact_graphs_per_s_3000"] = 3000 / artifact_s
        rec["live_graphs_per_s_3000"] = 3000 / live_s
        results[label] = rec
        log(f"{label} artifact: exported on the CPU in {export_s:.2f} s, "
            f"{rec['bytes']} bytes, loaded on the card in {load_s:.2f} s; "
            f"launches {COUNTER_NAMES} a request "
            f"{[r['launches'] for r in rec['requests'].values()]} as the "
            f"live Predictor's; max abs err vs live "
            f"{[r['max_abs_err_vs_live'] for r in rec['requests'].values()]}"
            f", vs the CPU artifact "
            f"{[r['max_abs_err_vs_cpu_artifact'] for r in rec['requests'].values()]}; "
            f"3,000 graphs: artifact {rec['artifact_graphs_per_s_3000']:.1f}"
            f" graphs/s, live {rec['live_graphs_per_s_3000']:.1f} "
            f"(median of {repeats} each, in turns)")
    results["server_main"] = served_artifact(
        os.path.join(ckpt_dir, "sparse.ggnnx"), requests[1])
    return results


def served_artifact(artifact, request):
    """`server.main(["--checkpoint", artifact])` on the card, one request
    over HTTP against the artifact's own answer (1e-6)."""
    from ggnn_tpu_torch import server as server_module
    from ggnn_tpu_torch.export import load_predictor

    seen = {}

    def ready(server):
        host, port = server.address
        try:
            seen["answer"], seen["seconds"] = http_predict(
                f"http://{host}:{port}", request)
            seen["health"] = http_health(f"http://{host}:{port}")
        finally:
            server.shutdown()

    server_module.main(["--checkpoint", artifact, "--port", "0"],
                       ready=ready)
    if "answer" not in seen:
        raise RuntimeError("server.main served no request")
    want = load_predictor(artifact)(request)
    err = float(np.abs(seen["answer"] - want).max())
    np.testing.assert_allclose(seen["answer"], want, rtol=TOL_ARTIFACT,
                               atol=TOL_ARTIFACT)
    log(f"server.main --checkpoint {os.path.basename(artifact)}: one "
        f"request in {seen['seconds'] * 1e3:.3f} ms, max abs err "
        f"{err:.3e}, /healthz {seen['health']}")
    return {"max_abs_err": err, "health": seen["health"]}


# ------------------------------------------------ bf16 (ROADMAP A16)

BF16_FILE = "sparse_wide_bf16.json"
BF16_HIDDEN = 512
BF16 = {"compute_dtype": "bfloat16"}
# Dense bf16 products on the tensor cores (NVIDIA H100 SXM data sheet,
# dense, without sparsity).
BF16_TENSOR_OPS_PER_S = 989e12
# The port on the card against the port on the CPU under bf16: both
# round the same sums to bf16, but cuBLAS's f32 sums (another order than
# the CPU's) now and then round a bf16 value the other way, and the GRU
# steps carry it. On an H100 the worst errors were 2.6e-4 (answers,
# `dense`), 1.8e-7 (a step's loss) and 8.6e-4 (a gradient); JAX pins
# 0.05 absolute for bf16 against f32 (tests/test_models.py:268-280).
TOL_BF16_SERVING = 1e-3    # answers, rtol = atol
TOL_BF16_STEP_LOSS = 1e-5  # a train step's loss, relative
TOL_BF16_STEP_GRAD = 5e-3  # each gradient, relative L2 error
# The routes besides the headline's that launch the other bf16
# instances: the weighted instance, its transpose and edge_dot (combined
# lane, attention on); B3 and B3's transpose (per edge). The per-type
# route runs the combined lane's kernels; tests/test_torch_cuda.py holds
# every route x attention in bf16.
BF16_ROUTES = {"combined, attention on": ("combined", {}, True),
               "per-edge, attention on": (
                   "per-edge", {"aggregate_first": False}, True)}


def bf16_config(overrides=None):
    """configs/sparse_wide_bf16.json (hidden 512, 20,000-node batches,
    layer_timesteps [2, 2, 1, 2, 1], edge-weight dropout 0.8), with
    `overrides`."""
    return resolved_config("sparse", BF16_FILE, overrides,
                           hidden=BF16_HIDDEN)


def bf16_route_launches(route, attention, steps, train):
    """The launches of the bf16 instances in a forward or train step of
    a bf16 sparse GGNN on `route`: those of `route_launches`, less the
    per-edge route's f32 ones (its messages are f32, as JAX's are, so B1
    and B1's transpose B2 over them run in f32; the gather B3, its
    transpose B2 and the scores' kernels take the bf16 node states)."""
    b1, b2, b3, w, wt, dots = route_launches(route, attention, steps, train)
    if route != "per-edge":
        return (b1, b2, b3, w, wt, dots)
    return (0, b2 - steps if train else 0, b3, w, wt, dots)


def bf16_ulp_error(got, want):
    """The largest |got - want| of two bf16 tensors over one bf16 ulp of
    `want` (or, where a sum cancels to near 0, over 1e-5 of want's
    largest magnitude): at most 1 passes."""
    got, want = got.float(), want.float()
    spacing = torch.exp2(torch.floor(torch.log2(
        want.abs().clamp_min(2.0 ** -126))) - 7)
    bound = torch.maximum(spacing, 1e-5 * want.abs().max())
    return float(((got - want).abs() / bound).max()) if got.numel() else 0.0


def check_bf16_segment(name, label, x, idx, offsets, num_segments,
                       weights=None, exact=False):
    """A bf16 instance of the segment sums (B1 `gather_segment_sum`, B2
    `segment_scatter_sum`, the weighted instance or its transpose) on
    bf16 rows against its plain version at one shape: within one bf16
    ulp of each output element (0 when `exact`: rows of eighths), two
    calls bit-equal. The bound counts the bf16 rows some edge reads once,
    the int32 ids and offsets (and the bf16 weights) once and the bf16
    output once; the library yardstick is `torch.sparse.mm` of the bf16
    CSR matrix, or its refusal."""
    from ggnn_tpu_torch.ops.kernels import ell_spmm

    kernel = getattr(ell_spmm, name)
    if weights is None:
        args = (x, idx, offsets, num_segments)
        plain = ell_spmm.gather_segment_sum_reference
    else:
        args = (x, idx, weights, offsets, num_segments)
        plain = ell_spmm.weighted_gather_segment_sum_reference
    got, again = kernel(*args), kernel(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    if got.dtype != torch.bfloat16 or not torch.equal(got, again):
        raise RuntimeError(f"{name} bf16 [{label}]: dtype {got.dtype} or "
                           "two calls differ")
    ulps = bf16_ulp_error(got, want)
    if (exact and not torch.equal(got, want)) or ulps > 1.0:
        raise RuntimeError(f"{name} bf16 [{label}]: {ulps:.3f} ulp from "
                           "its plain version")
    rows, h_dim = x.shape
    begin, end = int(offsets[0].item()), int(offsets[-1].item())
    used = end - begin
    rows_read = int(torch.unique(idx[begin:end]).numel())
    values = (torch.ones(end, dtype=x.dtype, device=x.device)
              if weights is None else weights[:end])
    matrix = torch.sparse_csr_tensor(offsets.long(), idx[:end].long(),
                                     values, size=(num_segments, rows))
    library, refused = library_call(f"{name} [{label}]",
                                    lambda: torch.sparse.mm(matrix, x),
                                    x.dtype)
    rec = {"shape": label, "dtype": "bf16", "rows_of_input": rows,
           "H": h_dim, "S": num_segments, "E": int(idx.shape[0]),
           "edges_used": used, "rows_read": rows_read,
           "max_abs_err": float((got.float() - want.float()).abs().max()),
           "max_ulp_err": ulps, "bit_equal_repeat": True,
           "library_refused": refused,
           **measure(
               lambda: kernel(*args), lambda: plain(*args), library,
               bytes_moved=(2 * (rows_read * h_dim + num_segments * h_dim)
                            + 4 * (used + num_segments + 1)
                            + (0 if weights is None else 2 * used)),
               ops=(1 if weights is None else 2) * used * h_dim)}
    log(f"kernel {name} bf16 [{label}] rows(input)={rows} H={h_dim} "
        f"S={num_segments} used={used} rows_read={rows_read} "
        f"ulp={ulps:.3f}: {timing_text(rec)}")
    return rec


def bf16_rows(gen, dev, rows, h_dim=BF16_HIDDEN, eighths_only=False):
    """[rows, h_dim] bf16: randn rounded, or multiples of 1/8 in [-2, 2]
    (every f32 partial sum exact)."""
    if eighths_only:
        x = torch.randint(-16, 17, (rows, h_dim), generator=gen,
                          device=dev).float() / 8
    else:
        x = torch.randn(rows, h_dim, generator=gen, device=dev)
    return x.to(torch.bfloat16)


def bf16_kernel_phase(dev, gen, batches, skewed):
    """Each bf16 instance against its plain version at the bf16 config's
    width (H 512): B1 at the serving envelope, the 20k-node budget, a hub
    and the skewed lane, B2 at their transposes; the weighted instance
    with attention weights at 20k and over its transpose; edge_dot for
    the scores and the weights' gradient at 20k; B3 at the 20k per-edge
    [4, 32736]; the registers of each bf16 instance."""
    from ggnn_tpu_torch.ops.kernels import edge_dot, ell_spmm, gather_floor
    from ggnn_tpu_torch.ops.messages import (
        EdgeLanes, propagation_attention_weights_combined)

    out = {"b1": [], "b2": [], "weighted": [], "edge_dot": [],
           "gather_rows": []}
    for label, batch, t_dim in batches:
        b = batch.to(dev)
        n = b.node_capacity
        lanes = EdgeLanes.combined(b.edge_sources_all, b.edge_types_all,
                                   b.edge_targets_all, t_dim, n)
        h = bf16_rows(gen, dev, n)
        out["b1"].append(check_bf16_segment(
            "gather_segment_sum", label, h, b.edge_sources_all,
            lanes.offsets, n * t_dim))
        _, bgather, boff = lanes.segment_transpose
        out["b2"].append(check_bf16_segment(
            "segment_scatter_sum", f"backward of the {label}",
            bf16_rows(gen, dev, n * t_dim), bgather, boff, n))
        if n < 20000:
            continue
        factors = torch.rand(t_dim, generator=gen, device=dev) + 0.5
        with torch.no_grad():
            att = propagation_attention_weights_combined(
                h, b.edge_sources_all, b.edge_targets_all, b.edge_mask_all,
                b.edge_types_all, factors, n, lanes).to(torch.bfloat16)
        out["weighted"].append(check_bf16_segment(
            "weighted_gather_segment_sum", f"attention weights, {label}", h,
            b.edge_sources_all, lanes.offsets, n * t_dim, weights=att))
        perm, bids, boff = lanes.segment_transpose
        out["weighted"].append(check_bf16_segment(
            "weighted_segment_scatter_sum", f"transpose, {label}",
            bf16_rows(gen, dev, n * t_dim), bids, boff, n,
            weights=att[perm].contiguous()))
        out["edge_dot"].append(check_edge_dot(
            f"scores, {label}", h, b.edge_sources_all, h,
            b.edge_targets_all))
        out["edge_dot"].append(check_edge_dot(
            f"weights' gradient, {label}", h, b.edge_sources_all,
            bf16_rows(gen, dev, n * t_dim), lanes.segments))
        out["gather_rows"].append(check_gather(
            f"per-edge [T, E], {label}", h, b.edge_sources))
    out["b1"].append(check_bf16_segment(
        "gather_segment_sum", "hub + empty segments",
        bf16_rows(gen, dev, 6000, eighths_only=True),
        *hub_case(dev, gen, 23, 4096, 6000, 1234)[1:], 4096, exact=True))
    out["b2"].append(check_bf16_segment(
        "segment_scatter_sum", "hub + empty rows",
        bf16_rows(gen, dev, 4096 * EDGE_TYPES, eighths_only=True),
        *hub_case(dev, gen, 24, 4096, 4096 * EDGE_TYPES, 2345)[1:], 4096,
        exact=True))
    src, types, tgt = skewed
    lanes = EdgeLanes.combined(src, types, tgt, EDGE_TYPES, SKEWED_NODES)
    out["b1"].append(check_bf16_segment(
        "gather_segment_sum", "skewed in-degree",
        bf16_rows(gen, dev, SKEWED_NODES, eighths_only=True), src,
        lanes.offsets, SKEWED_NODES * EDGE_TYPES, exact=True))
    _, bgather, boff = lanes.segment_transpose
    out["b2"].append(check_bf16_segment(
        "segment_scatter_sum", "backward of the skewed in-degree",
        bf16_rows(gen, dev, SKEWED_NODES * EDGE_TYPES, eighths_only=True),
        bgather, boff, SKEWED_NODES, exact=True))
    bf16 = torch.bfloat16
    out["registers"] = {
        "ell_spmm": {f"x{e}": ell_spmm.registers(e, dev, dtype=bf16)
                     for e in (8, 4, 1)},
        "ell_spmm_weighted": {
            f"x{e}": ell_spmm.registers(e, dev, weighted=True, dtype=bf16)
            for e in (8, 4, 1)},
        "edge_dot": {f"x{e}": edge_dot.registers(e, dev, dtype=bf16)
                     for e in (8, 4, 1)},
        "gather_rows_unroll8": {
            f"x{e}": gather_floor.registers(8, e, False, dev, dtype=bf16)
            for e in (8, 4, 1)}}
    log(f"bf16 instances: registers a thread {out['registers']} (f32 B1/B2 "
        f"float4 / scalar {ell_spmm.registers(True, dev)} / "
        f"{ell_spmm.registers(False, dev)})")
    return out


def bf16_serving_phase(ckpt_dir):
    """configs/sparse_wide_bf16.json (random weights, seed 0) served on
    the card: the 1-, 300- and 3,000-graph requests, B1's bf16 instance
    once a propagation step of each forward and no other bf16 launch,
    every answer held against the same checkpoint served on the CPU
    (TOL_BF16_SERVING), graphs/s and the 1-graph latency; then the same
    config with compute_dtype float32 on the same card, a plain
    comparison (its B1 launches f32)."""
    keys = config_keys(BF16_FILE)
    steps = sum(keys["layer_timesteps"])
    served = counted_serving(
        "sparse", ckpt_dir, per_request((steps, 0, 0, 0, 0, 0)),
        overrides=keys, tag="_wide_bf16", tol=TOL_BF16_SERVING,
        counts=bf16_launch_counts)
    f32 = counted_serving(
        "sparse", ckpt_dir, per_request((0,) * 6),
        overrides={**keys, "compute_dtype": "float32"}, tag="_wide_f32",
        cpu_sizes=(1,), counts=bf16_launch_counts)
    log(f"sparse_wide_bf16 vs the same config in f32 on this card: "
        f"{served['graphs_per_s_3000']:.1f} vs "
        f"{f32['graphs_per_s_3000']:.1f} graphs/s, "
        f"{served['latency_1_graph_ms']:.3f} vs "
        f"{f32['latency_1_graph_ms']:.3f} ms (no claim)")
    return {"bf16": served, "f32": f32}


def bf16_training_phase(corpus, log_dir):
    """3 epochs of configs/sparse_wide_bf16.json (20,000-node batches,
    edge-weight dropout 0.8) on the card: each train graph holds B1's
    bf16 instance 8 times and B2's 7 times, each validation graph B1's
    8 times, no other bf16 launch; then a profile of its train step on a
    20k-node batch."""
    runner, result = train_run("sparse", 3, corpus, log_dir,
                               config=bf16_config(),
                               counts=bf16_launch_counts)
    steps = sum(runner.config["layer_timesteps"])
    result["launches_a_replay"] = check_runner_graphs(
        "sparse_wide_bf16 training", runner, (steps, steps - 1, 0, 0, 0, 0),
        (steps, 0, 0, 0, 0, 0), bf16_launch_counts)
    got = [result[f"launches_{k}"] for k in COUNTERS]
    if not all(got[:2]):
        raise RuntimeError(f"sparse_wide_bf16 training launched bf16 "
                           f"{COUNTER_NAMES} {got}")
    result["profile"] = profile_phase(
        runner, first_batch(runner, is_20k_batch), label="sparse_wide_bf16")
    return runner, result


def bf16_step_config(overrides=None):
    """The bf16 config at 4,000-node batches for the card-vs-CPU steps:
    a 20k-node step at H 512 takes the CPU tens of seconds."""
    return bf16_config({"batch_size": 4000, "num_epochs": 1,
                        **(overrides or {})})


def is_4k_batch(batch):
    return int(batch.num_nodes) >= 3500


def bf16_routes_phase(step_corpus, ckpt_dir, step_dir):
    """The bf16 config's train step on the card against the CPU (the
    combined lane without attention: the headline path), then each of
    BF16_ROUTES: a 300-graph request against the CPU and a train step
    against the CPU, each with the bf16 launches
    `bf16_route_launches` gives."""
    steps = sum(config_keys(BF16_FILE)["layer_timesteps"])
    tol = dict(loss_tol=TOL_BF16_STEP_LOSS, grad_tol=TOL_BF16_STEP_GRAD,
               counts=bf16_launch_counts)
    results = {"combined, attention off": {"train_step": card_vs_cpu_phase(
        "sparse", step_corpus, is_4k_batch, step_dir,
        config=bf16_step_config(),
        want=bf16_route_launches("combined", False, steps, True),
        label="sparse_wide_bf16", **tol)}}
    for label, (route, keys, attention) in BF16_ROUTES.items():
        overrides = {**keys, "use_propagation_attention": attention}
        serving = counted_serving(
            "sparse", ckpt_dir, per_request(bf16_route_launches(
                route, attention, steps, False)),
            overrides={**config_keys(BF16_FILE), **overrides},
            sizes=(300,), tag=f"_bf16_{route}_{int(attention)}",
            tol=TOL_BF16_SERVING, counts=bf16_launch_counts)
        step = card_vs_cpu_phase(
            "sparse", step_corpus, is_4k_batch, step_dir,
            config=bf16_step_config(overrides),
            want=bf16_route_launches(route, attention, steps, True),
            label=f"sparse_wide_bf16 ({label})", **tol)
        results[label] = {"serving": serving, "train_step": step}
    return results


def bf16_dense_phase(step_corpus, ckpt_dir, step_dir, f32_forward):
    """`dense`, `blocked` and `gcn_blocked` with compute_dtype bfloat16
    (their default configs otherwise): a 300-graph request against the
    CPU and one train step against the CPU each, no hand kernel; and the
    `dense` and `blocked` forward's device time in bf16 at the 256-graph
    V = 32 batch against the f32 one of `dense_forward_phase` in this
    run, and against the least time of its products at the bf16 tensor
    rate."""
    from ggnn_tpu_torch.training.runner import Runner

    results = {}
    tol = dict(loss_tol=TOL_BF16_STEP_LOSS, grad_tol=TOL_BF16_STEP_GRAD)
    for variant in DENSE_VARIANTS + ("gcn_blocked",):
        serving = counted_serving(variant, ckpt_dir, per_request(NO_LAUNCH),
                                  overrides=BF16, sizes=(300,),
                                  tag="_bf16", tol=TOL_BF16_SERVING)
        step = card_vs_cpu_phase(
            variant, step_corpus, is_full_v32_batch, step_dir,
            config=train_config(variant, {"num_epochs": 1, **BF16}),
            label=f"{variant}_bf16", **tol)
        results[variant] = {"serving": serving, "train_step": step}
    runners = {variant: Runner(
        variant, train_config(variant, {"num_epochs": 1, **BF16}),
        train_data=step_corpus[0], valid_data=step_corpus[1],
        log_dir=os.path.join(step_dir, f"{variant}_bf16_forward"),
        quiet=True) for variant in DENSE_VARIANTS}
    forward = dense_forward_phase(runners, BF16_TENSOR_OPS_PER_S,
                                  "bf16 tensor cores")
    for variant, rec in forward.items():
        rec["f32_ms_this_run"] = f32_forward[variant]["ms"]
        log(f"{variant} forward at 256 graphs, V = 32: bf16 {rec['ms']:.4f}"
            f" ms against f32 {rec['f32_ms_this_run']:.4f} ms in this run; "
            f"{rec['share_of_bound']:.2%} of the bf16 tensor rate's bound")
    results["forward"] = forward
    return results


def bf16_export_phase(ckpt_dir):
    """configs/sparse_wide_bf16.json exported on the CPU and loaded on the
    card: the 1- and 300-graph requests capture graphs holding the bf16
    instances a live forward launches, as the live card Predictor's do,
    answers within TOL_ARTIFACT of it (the
    program runs cuBLAS's bf16 product through the `product_f32` op, as
    the live model does) and within TOL_BF16_SERVING of the artifact on
    the CPU."""
    from ggnn_tpu_torch.export import export_predictor, load_predictor
    from ggnn_tpu_torch.serving import Predictor

    requests = serving_requests()
    _, path = random_checkpoint("sparse", ckpt_dir, config_keys(BF16_FILE),
                                tag="_export_wide_bf16")
    artifact = os.path.join(ckpt_dir, "sparse_wide_bf16.ggnnx")
    t0 = time.perf_counter()
    export_predictor(Predictor.from_checkpoint(path, "sparse",
                                               device="cpu"), artifact)
    export_s = time.perf_counter() - t0
    card, live = load_predictor(artifact), Predictor.from_checkpoint(
        path, "sparse")
    cpu_artifact = load_predictor(artifact, device="cpu")
    rec = {"export_s": export_s, "bytes": os.path.getsize(artifact),
           "requests": {}}
    for n in (1, 300):
        got, counts, calls, new = counted_request(card, requests[n],
                                                  bf16_launch_counts)
        want, live_counts, _, _ = counted_request(live, requests[n],
                                                  bf16_launch_counts)
        steps = sum(live.config["layer_timesteps"])
        check_forwards(f"bf16 artifact, {n} graphs", new,
                       (steps, 0, 0, 0, 0, 0))
        if counts != live_counts:
            raise RuntimeError(f"bf16 artifact, {n} graphs: launched "
                               f"{counts}, the live Predictor {live_counts}")
        err_live = float(np.abs(got - want).max())
        np.testing.assert_allclose(got, want, rtol=TOL_ARTIFACT,
                                   atol=TOL_ARTIFACT)
        cpu_want = cpu_artifact(requests[n])
        err_cpu = float(np.abs(got - cpu_want).max())
        np.testing.assert_allclose(got, cpu_want, rtol=TOL_BF16_SERVING,
                                   atol=TOL_BF16_SERVING)
        rec["requests"][n] = {"launches": counts, "forward_calls": calls,
                              "max_abs_err_vs_live": err_live,
                              "max_abs_err_vs_cpu_artifact": err_cpu}
    log(f"sparse_wide_bf16 artifact: exported on the CPU in {export_s:.2f}"
        f" s, {rec['bytes']} bytes; {rec['requests']}")
    return rec


# ------------------------------------------------------- training extras

TOL_RESUME = 1e-6          # resumed vs uninterrupted parameters on the card
TOL_PREDICT = 1e-5         # Runner.predict vs the card Predictor
TOL_PREDICT_CPU = 1e-4     # ... and vs the CPU Runner's predict
# SMILES of tests/test_smiles.py's oracle, atoms H/C/N/O/F only: the
# molecules of the QM9-layout tarball phase 18 extracts and trains on.
ORACLE_SMILES = (
    "C", "N", "O", "F", "C=O", "CCO", "CC(=O)O", "c1ccccc1", "c1ccncc1",
    "c1cc[nH]c1", "c1ccoc1", "CC#N", "O=C=O", "C1CC1", "F/C=C/F",
    "Cc1ccccc1", "[C@@H](N)(O)F", "[13CH4]", "C.C", "C%10CC%10",
    "c1ccc2ccccc2c1", "c1:c:c:c:c:c1", "C=1CCCCC=1", "C1=CC=CC=C1",
    "C1=CC=CN1", "C1=CC=CC=N1", "C1=CC=CO1", "C1=CN=CN1",
    "C1=CC=CC2=CC=CC=C12", "O=C1C=CC=CN1", "C1=CC=C1", "C1=CCCCC1",
    "C=C1C=CC=C1", "C=CC=C", "FC(F)F", "CC(C)C", "C/C=C/C", "N#Cc1ccccc1",
    "OCC1OC1", "Cn1cccc1")


def params_of(runner):
    return {n: p.detach().cpu() for n, p in runner.params.named_parameters()}


def counted_sparse_train(label, runner, counts=launch_counts):
    """(history, launches, seconds) of `runner.train()` on the card, the
    counters set to 0 just before and read just after, equal to 2 x the
    launches of the graphs it captured; each train graph holding a
    combined-lane step's launches without attention (B1 once a
    propagation step, B2 once a step but the first) and each validation
    graph a forward's."""
    captures = Captures(runner.train_graphs, runner.eval_graphs)
    zero_launch_counts()
    t0 = time.perf_counter()
    history = runner.train()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launched = counts()
    new = captures.check(label, launched, counts)
    steps = sum(runner.config["layer_timesteps"])
    check_runner_graphs(label, runner,
                        route_launches("combined", False, steps, True),
                        route_launches("combined", False, steps, False),
                        counts)
    log(f"{label}: {len(history)} epochs in {seconds:.2f} s, "
        f"{[len(n) for n in new]} train and validation graphs captured; "
        f"launches {COUNTER_NAMES} {launched}")
    return history, launched, seconds


def counted_train(label, runner, base_steps=(0, 0)):
    """`counted_sparse_train` of `runner` over the steps and validation
    batches the run adds to `base_steps`; every loss finite."""
    history, launched, seconds = counted_sparse_train(f"extras {label}",
                                                      runner)
    train_steps = runner.train_step_id - base_steps[0]
    valid_batches = runner.valid_step_id - base_steps[1]
    log(f"extras {label}: {train_steps} train steps, {valid_batches} "
        f"validation batches; train graphs/s "
        f"{[round(e['train_results'][3], 1) for e in history]}")
    for entry in history:
        if not np.isfinite([entry["train_results"][0],
                            entry["valid_results"][0]]).all():
            raise RuntimeError(f"extras {label}: non-finite loss")
    return {"launches": list(launched), "seconds": seconds,
            "train_steps": train_steps, "valid_batches": valid_batches,
            "train_graphs_per_s": [e["train_results"][3] for e in history],
            "epochs": [e["epoch"] for e in history]}


def resume_phase(corpus, log_dir):
    """2 epochs of `sparse` at configs/sparse_tpu.json (20,000-node
    batches, edge-weight dropout 0.8) uninterrupted; the same with a
    rolling checkpoint every 2 steps, the one at epoch 2, step 2 kept,
    and with one every step, then uninterrupted again (graphs/s with a
    checkpoint every step against the mean of the runs without); and
    the run resumed from the kept checkpoint on the card, its final
    parameters held to the uninterrupted run's."""
    import shutil

    from ggnn_tpu_torch.training import runner as runner_mod
    from ggnn_tpu_torch.training.checkpoint import load_iterator_state
    from ggnn_tpu_torch.training.runner import Runner

    config = train_config("sparse", {"num_epochs": 2})
    assert config["batch_size"] == 20000
    assert config["edge_weight_dropout_keep_prob"] == 0.8
    train, valid = corpus

    def runner(tag, **kwargs):
        return Runner("sparse", dict(config), train_data=train,
                      valid_data=valid, log_dir=os.path.join(log_dir, tag),
                      quiet=True, **kwargs)

    runs = {}
    ref = runner("uninterrupted")
    if ref.device.type != "cuda":
        raise RuntimeError(f"default device is {ref.device}")
    runs["uninterrupted"] = counted_train("uninterrupted", ref)

    ckpt = os.path.join(log_dir, "epoch2_step2.pickle")
    save = runner_mod.save_checkpoint
    save_seconds = []

    def capture(path, *args, iterator_state=None, **kwargs):
        t0 = time.perf_counter()
        save(path, *args, iterator_state=iterator_state, **kwargs)
        if iterator_state is None:   # the best and epoch checkpoints
            return
        save_seconds.append(time.perf_counter() - t0)
        if (iterator_state["epoch"], iterator_state["steps_done"]) == (2, 2):
            shutil.copy(path, ckpt)

    runner_mod.save_checkpoint = capture
    try:
        runs["every_2_steps"] = counted_train("checkpoint every 2 steps",
                                              runner("every2",
                                                     checkpoint_every_steps=2))
        saves_every_2 = len(save_seconds)
        runs["every_step"] = counted_train("checkpoint every step",
                                           runner("every1",
                                                  checkpoint_every_steps=1))
    finally:
        runner_mod.save_checkpoint = save
    # None, every 2, every step, none: the checkpoints' cost against the
    # runs without on either side.
    runs["uninterrupted_again"] = counted_train("uninterrupted, again",
                                                runner("uninterrupted2"))
    it = load_iterator_state(ckpt)
    if ((it["epoch"], it["steps_done"]) != (2, 2)
            or it["torch_generator_device"] != "cuda"):
        raise RuntimeError(f"the kept checkpoint holds {it}")
    resumed = runner("resumed", restore=ckpt)
    base = (resumed.train_step_id, resumed.valid_step_id)
    runs["resumed"] = counted_train("resumed from epoch 2, step 2", resumed,
                                    base)
    if runs["resumed"]["epochs"] != [2] or \
            resumed.train_step_id != ref.train_step_id:
        raise RuntimeError("the resumed run did not finish epoch 2 alone")
    want, got = params_of(ref), params_of(resumed)
    diff = max(float((got[n] - want[n]).abs().max()) for n in want)
    bit_equal = all(torch.equal(got[n], want[n]) for n in want)
    size = os.path.getsize(ckpt)
    log(f"extras resume: the resumed run's {len(want)} parameters against "
        f"the uninterrupted run's: max abs difference {diff:.3e} (limit "
        f"{TOL_RESUME}), bit-equal {bit_equal}; rolling checkpoint "
        f"{size} bytes, {statistics.median(save_seconds) * 1e3:.2f} ms a "
        f"save (median of {len(save_seconds)}, host clock)")
    if not diff <= TOL_RESUME:
        raise RuntimeError("the resumed run's parameters differ from the "
                           "uninterrupted run's")
    none = [(a + b) / 2 for a, b in zip(
        runs["uninterrupted"]["train_graphs_per_s"],
        runs["uninterrupted_again"]["train_graphs_per_s"])]
    ratio = [a / b for a, b in
             zip(runs["every_step"]["train_graphs_per_s"], none)]
    log(f"extras: train graphs/s with a checkpoint every step over the mean "
        f"of the two runs without, epochs 1 and 2: "
        f"{[round(r, 4) for r in ratio]}")
    return ref, {"runs": runs, "max_abs_diff": diff, "bit_equal": bit_equal,
                 "checkpoint_bytes": size,
                 "save_ms_median": statistics.median(save_seconds) * 1e3,
                 "saves": {"every_2_steps": saves_every_2,
                           "every_step": len(save_seconds) - saves_every_2},
                 "every_step_over_none_graphs_per_s": ratio}


def trace_counts(path):
    """(calls of each `ggnn_tpu_torch::` op, kernels by name, kernels of
    `segment_sum_kernel` attributed to the op whose call launched them by
    the launch's correlation id, or None where no launch of them was
    traced) of a Chrome trace of `torch.profiler`."""
    import collections

    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ops = [e for e in events if e.get("cat") == "cpu_op"
           and e["name"].startswith("ggnn_tpu_torch::")]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    by_kernel = collections.Counter(
        "segment_sum_kernel" if "segment_sum_kernel" in e["name"]
        else e["name"][:60] for e in kernels)
    launch_op = {}
    for e in events:
        if e.get("cat") == "cuda_runtime" and "aunch" in e["name"]:
            for op in ops:
                if (op["tid"] == e["tid"] and op["ts"] <= e["ts"]
                        <= op["ts"] + op["dur"]):
                    launch_op[e["args"]["correlation"]] = op["name"]
    attributed = collections.Counter(
        launch_op.get(e["args"].get("correlation"), "unattributed")
        for e in kernels if "segment_sum_kernel" in e["name"])
    if set(attributed) <= {"unattributed"}:
        attributed = None   # no launch event of these kernels was traced
    return (collections.Counter(op["name"] for op in ops), by_kernel,
            None if attributed is None else dict(attributed))


def profile_cli_phase(work_dir):
    """`cli.main(["sparse", "--profile", DIR, ...])` for one epoch on the
    card at configs/sparse_tpu.json over `--synthetic 6000`: one Chrome
    trace of the profiled training epoch, whose steps are replays of the
    graph its first step captured. Its B1 and B2 op calls are twice the
    counters over the epoch (the warm-up step's and the capture's
    dispatches, each recorded again where the step cache's operator
    recorder, a dispatch mode, calls it on); its `segment_sum_kernel` launches (B1 and B2
    share it) are the warm-up step's, attributed to their ops, and each
    replay's, which the graph launches."""
    from ggnn_tpu_torch import cli
    from ggnn_tpu_torch.training.runner import Runner

    profile_dir = os.path.join(work_dir, "profile")
    by_epoch = {}
    run_epoch = Runner.run_epoch

    def counted(self, name, processed, is_training):
        before = launch_counts()
        captures = Captures(self.train_graphs)
        result = run_epoch(self, name, processed, is_training)
        torch.cuda.synchronize()
        (new,) = captures.new()
        by_epoch[name] = (tuple(a - b for a, b in
                                zip(launch_counts(), before)), result[4],
                          [held(g.launches) for g in new])
        return result

    Runner.run_epoch = counted
    try:
        zero_launch_counts()
        t0 = time.perf_counter()
        rc = cli.main(["sparse", "--synthetic", "6000", "--config-file",
                       os.path.join(REPO, "configs", "sparse_tpu.json"),
                       "--config", json.dumps({"num_epochs": 1}),
                       "--log_dir", work_dir, "--profile", profile_dir,
                       "--quiet"])
        seconds = time.perf_counter() - t0
        launched = launch_counts()
    finally:
        Runner.run_epoch = run_epoch
    traces = os.listdir(profile_dir)
    if rc != 0 or len(traces) != 1:
        raise RuntimeError(f"cli --profile returned {rc}, wrote {traces}")
    (b1, b2, *others), steps, new = by_epoch["epoch 1 (training)"]
    ops, kernels, attributed = trace_counts(os.path.join(profile_dir,
                                                         traces[0]))
    # Every step of the epoch replays the one graph its first step
    # captured, after that graph's warm-up step and capture.
    replayed = steps * sum(sum(t[:2]) for t in new)
    log(f"extras profile: cli.main --profile {seconds:.2f} s, launches "
        f"{COUNTER_NAMES} {launched}; the profiled epoch: {steps} steps, "
        f"{len(new)} graph captured ({new}), B1 {b1}, B2 {b2}; its trace "
        f"({os.path.getsize(os.path.join(profile_dir, traces[0]))} bytes): "
        f"ops {dict(ops)}, segment_sum_kernel "
        f"{kernels['segment_sum_kernel']} (warm-up {(b1 + b2) // 2}, "
        f"replays {replayed}), attributed by launch {attributed}; "
        f"{sum(kernels.values())} kernels in all")
    # The warm-up step and the capture run under the cache's operator
    # recorder (`utils/timing.py:_LastOp`), a dispatch mode: each op the
    # step dispatches is recorded once as called and once as the mode
    # calls it on.
    want_ops = {"ggnn_tpu_torch::gather_segment_sum": 2 * b1,
                "ggnn_tpu_torch::segment_scatter_sum": 2 * b2}
    if (len(new) != 1 or b1 == 0 or b2 == 0 or any(others)
            or (b1, b2) != (2 * new[0][0], 2 * new[0][1])
            or ops != want_ops
            or kernels["segment_sum_kernel"] != (b1 + b2) // 2 + replayed):
        raise RuntimeError("the profiled epoch's trace does not name B1 "
                           "and B2 as often as its warm-up, capture and "
                           "replays launch them")
    if attributed is not None and attributed != {
            "ggnn_tpu_torch::gather_segment_sum": b1 // 2,
            "ggnn_tpu_torch::segment_scatter_sum": b2 // 2,
            "unattributed": replayed}:
        raise RuntimeError(f"the trace attributes {attributed} kernels")
    return {"seconds": seconds, "launches": list(launched),
            "epoch_steps": steps, "epoch_b1": b1, "epoch_b2": b2,
            "epoch_graphs": new, "trace_replayed_kernels": replayed,
            "trace_ops": dict(ops),
            "trace_segment_sum_kernels": kernels["segment_sum_kernel"],
            "trace_attributed": attributed,
            "trace_kernels": sum(kernels.values())}


def evaluate_phase(best, corpus, log_dir):
    """`Runner.predict` on the card over the validation corpus from the
    run's best pickle, after a warm-up call that captures its forward's
    graph (B1 once a propagation step): a replay a batch, no kernel
    launched; against the card `Predictor` of it and the CPU Runner's
    predict; then `cli.main([... "--restore", best, "--evaluate"])`."""
    from ggnn_tpu_torch import cli
    from ggnn_tpu_torch.serving import Predictor
    from ggnn_tpu_torch.training.runner import Runner

    config = train_config("sparse", {"num_epochs": 2})
    valid = corpus[1]
    runners = {dev: Runner("sparse", dict(config), train_data=valid,
                           valid_data=valid,
                           log_dir=os.path.join(log_dir, dev), quiet=True,
                           restore=best, device=dev)
               for dev in ("cuda", "cpu")}
    card = runners["cuda"]
    card.predict(valid[:10])   # warm-up: captures the forward's graph
    torch.cuda.synchronize()
    captures = Captures(card.predict_graphs)
    zero_launch_counts()
    t0 = time.perf_counter()
    got = np.concatenate(card.predict(valid), axis=1)
    seconds = time.perf_counter() - t0
    launched = launch_counts()
    captures.check("extras Runner.predict", launched)
    batches = sum(1 for _ in card.adapter.batches(
        card.adapter.preprocess(valid, False), False))
    forward = check_graphs("extras Runner.predict", card.predict_graphs,
                           route_launches("combined", False,
                                          sum(config["layer_timesteps"]),
                                          False))
    predictor = Predictor.from_checkpoint(best, "sparse")
    served = predictor(valid)
    cpu = np.concatenate(runners["cpu"].predict(valid), axis=1)
    err, err_cpu = (float(np.abs(got - served).max()),
                    float(np.abs(got - cpu).max()))
    log(f"extras evaluate: Runner.predict of {len(valid)} graphs on the "
        f"card ({batches} batches, {seconds * 1e3:.1f} ms, host clock) "
        f"launched {COUNTER_NAMES} {launched}, its graphs "
        f"{card.graph_counts()['predict']} holding {forward} a replay; "
        f"max abs error against the card Predictor {err:.3e} (limit "
        f"{TOL_PREDICT}), against the CPU Runner {err_cpu:.3e} (limit "
        f"{TOL_PREDICT_CPU})")
    if got.shape != (1, len(valid)) or not np.isfinite(got).all():
        raise RuntimeError(f"Runner.predict gave shape {got.shape}")
    np.testing.assert_allclose(got, served, rtol=TOL_PREDICT,
                               atol=TOL_PREDICT)
    np.testing.assert_allclose(got, cpu, rtol=TOL_PREDICT_CPU,
                               atol=TOL_PREDICT_CPU)
    zero_launch_counts()
    with cli_runners() as made:
        rc = cli.main(["sparse", "--synthetic", "60", "--config-file",
                       os.path.join(REPO, "configs", "sparse_tpu.json"),
                       "--config", json.dumps({"num_epochs": 2}),
                       "--restore", best, "--evaluate", "--log_dir",
                       os.path.join(log_dir, "cli"), "--quiet"])
    torch.cuda.synchronize()
    cli_launched = launch_counts()
    if rc != 0 or cli_launched[0] == 0:
        raise RuntimeError(f"cli --evaluate returned {rc}")
    cli_graphs = check_cli_graphs("extras cli --restore --evaluate", made,
                                  cli_launched, "predict_graphs")
    log(f"extras evaluate: cli.main --restore --evaluate returned {rc}, "
        f"launches {cli_launched}, graphs {cli_graphs}")
    return {"launches": list(launched), "cli_launches": list(cli_launched),
            "launches_a_replay": forward,
            "cli_graphs": cli_graphs,
            "batches": batches, "predict_ms": seconds * 1e3,
            "max_abs_err_vs_predictor": err, "max_abs_err_vs_cpu": err_cpu}


def write_qm9_tarball(path, mol_ids, seed):
    """A `.tar.bz2` in the QM9 layout, one `dsgdb9nsd_<id>.xyz` a
    molecule of ORACLE_SMILES (atom count, tab-separated properties with
    mu in column 4, atoms, frequencies, the SMILES line, InChI), mu
    random from `seed`."""
    import io
    import tarfile

    rng = np.random.default_rng(seed)
    with tarfile.open(path, "w:bz2") as tar:
        for mol_id, text in zip(mol_ids, ORACLE_SMILES):
            props = ["gdb", str(mol_id), "2", "3",
                     f"{rng.uniform(0.0, 6.0):.4f}", "5", "6"]
            lines = ["3", "\t".join(props)]
            lines += [f"C\t0.0\t0.0\t{i}.0\t0.0" for i in range(3)]
            lines += ["100.0\t200.0", f"{text}\t{text}", "InChI=1S/none"]
            data = ("\n".join(lines) + "\n").encode()
            info = tarfile.TarInfo(f"dsgdb9nsd_{mol_id:06d}.xyz")
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))


def ingestion_phase(work_dir):
    """A QM9-layout tarball of the 40 oracle molecules (10 of them with
    ids of the split file's validation set) extracted by
    `python -m ggnn_tpu_torch.data.qm9`'s `main`, then one epoch of
    `sparse` on the card through `cli.main(["sparse", "--data_dir",
    ...])`: finite losses, B1 and B2 launched."""
    from ggnn_tpu_torch import cli
    from ggnn_tpu_torch.data import qm9

    os.makedirs(work_dir, exist_ok=True)
    valid_ids = sorted(int(i) for i in qm9.load_valid_idx())[:10]
    train_ids = [i for i in range(1, 100) if i not in set(valid_ids)][:30]
    tarball = os.path.join(work_dir, "dsgdb9nsd.xyz.tar.bz2")
    write_qm9_tarball(tarball, sorted(train_ids + valid_ids), seed=45)
    out_dir = os.path.join(work_dir, "json")
    t0 = time.perf_counter()
    qm9.main(["--tarball", tarball, "--data-dir",
              os.path.join(work_dir, "data"), "--out-dir", out_dir])
    extract_s = time.perf_counter() - t0
    sizes = {}
    for split in ("train", "valid"):
        with open(os.path.join(out_dir, f"molecules_{split}.json")) as f:
            sizes[split] = len(json.load(f))
    log_dir = os.path.join(work_dir, "log")
    zero_launch_counts()
    with cli_runners() as made:
        rc = cli.main(["sparse", "--data_dir", out_dir, "--config",
                       json.dumps({"num_epochs": 1}), "--log_dir", log_dir,
                       "--checkpoint-every-steps", "1", "--quiet"])
    torch.cuda.synchronize()
    launched = launch_counts()
    graphs = check_cli_graphs("extras cli --data_dir "
                              "--checkpoint-every-steps 1", made, launched,
                              "train_graphs")
    rolling = [n for n in os.listdir(log_dir)
               if n.endswith("_model_last.pickle")]
    logs = [n for n in os.listdir(log_dir) if n.endswith("_log.json")]
    with open(os.path.join(log_dir, logs[0])) as f:
        entry = json.load(f)[0]
    losses = [entry["train_results"][0], entry["valid_results"][0]]
    log(f"extras ingestion: {sizes} molecules extracted in {extract_s:.2f} "
        f"s; one epoch through cli.main --data_dir --checkpoint-every-steps"
        f" 1 returned {rc}, losses {losses}, launches {COUNTER_NAMES} "
        f"{launched}, graphs {graphs}, rolling checkpoints {rolling}")
    if (rc != 0 or sizes != {"train": 30, "valid": 10}
            or not np.isfinite(losses).all() or not all(launched[:2])
            or len(rolling) != 1):
        raise RuntimeError("the QM9 tarball did not train to a finite loss")
    return {"molecules": sizes, "extract_seconds": extract_s,
            "losses": losses, "launches": list(launched), "graphs": graphs}


def extras_phase(corpus, work_dir):
    """Phase 18: mid-epoch resume, `--profile`, evaluation, QM9 ingestion
    and TensorBoard, each path's launches counted from 0 just before
    it."""
    start = time.perf_counter()
    seconds = {}

    def timed(label, phase, *args):
        t0 = time.perf_counter()
        result = phase(*args)
        seconds[label] = time.perf_counter() - t0
        return result

    ref, resume = timed("resume", resume_phase, corpus,
                        os.path.join(work_dir, "resume"))
    profile = timed("profile", profile_cli_phase,
                    os.path.join(work_dir, "profile_run"))
    evaluate = timed("evaluate", evaluate_phase, ref.best_model_file,
                     corpus, os.path.join(work_dir, "evaluate"))
    ingestion = timed("ingestion", ingestion_phase,
                      os.path.join(work_dir, "qm9"))
    try:
        import tensorboardX  # noqa: F401
        tensorboard = True
    except ImportError:
        tensorboard = False
    events = glob.glob(os.path.join(os.path.dirname(ref.log_file), "tb",
                                    ref.run_id, "*", "events.*"))
    log(f"extras tensorboard: tensorboardX imported {tensorboard}; event "
        f"files of the uninterrupted run {len(events)}")
    if tensorboard and len(events) != 2:
        raise RuntimeError("the run wrote no TensorBoard events")
    total = time.perf_counter() - start
    log(f"extras phases: {total:.1f} s "
        f"({', '.join(f'{k} {v:.1f} s' for k, v in seconds.items())})")
    return {"resume": resume, "profile": profile, "evaluate": evaluate,
            "ingestion": ingestion, "tensorboardx": tensorboard,
            "event_files": len(events), "seconds": seconds,
            "total_seconds": total}


# ------------------------------------------- the native packer (A12)

# The packers that the native library replaces, each at its training
# config; `async` keeps numpy and gains the corpus cache.
NATIVE_VARIANTS = ("sparse", "gcn", "dense", "blocked", "gcn_blocked")
HOST_REPEATS = 3


def native_build():
    """The native packer (ggnn_tpu_torch/native/packer.cpp) built with
    g++ into build/native/, or loaded where this checkout built it: the
    seconds, g++'s version and the library's path. Fails where
    GGNN_TPU_NO_NATIVE is set or the build fails, so that no phase packs
    with numpy in its place."""
    import subprocess

    from ggnn_tpu_torch import native

    if native._no_native_env():
        raise RuntimeError("GGNN_TPU_NO_NATIVE is set: the native packer "
                           "would not run")
    t0 = time.perf_counter()
    native.require_lib()
    seconds = time.perf_counter() - t0
    gxx = subprocess.run(["g++", "--version"], capture_output=True,
                         text=True, check=True).stdout.splitlines()[0]
    return {"seconds": seconds, "gxx_seconds": native.build_info["seconds"],
            "path": os.path.relpath(native.build_info["path"], REPO),
            "gxx": gxx}


def same_batch(a, b) -> bool:
    """Leaf for leaf, dtypes included, through nested segments and
    tuples; a bf16 leaf is a torch tensor."""
    if dataclasses.is_dataclass(a):
        return type(a) is type(b) and all(
            same_batch(getattr(a, f.name), getattr(b, f.name))
            for f in dataclasses.fields(a))
    if isinstance(a, tuple):
        return (isinstance(b, tuple) and len(a) == len(b)
                and all(same_batch(x, y) for x, y in zip(a, b)))
    if a is None or b is None:
        return a is b
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        a, b = torch.as_tensor(a), torch.as_tensor(b)
        return a.dtype == b.dtype and torch.equal(a, b)
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and np.array_equal(a, b)


def check_stream(label, got, want):
    got, want = list(got), list(want)
    if len(got) != len(want) or not got:
        raise RuntimeError(f"{label}: {len(got)} batches against "
                           f"{len(want)}")
    bad = [i for i, (a, b) in enumerate(zip(got, want))
           if not same_batch(a, b)]
    if bad:
        raise RuntimeError(f"{label}: batches {bad[:5]} differ")
    return len(got)


def median_seconds(fn, repeats=HOST_REPEATS):
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def native_bits_phase(corpus, epoch_seconds, card):
    """Each native packer against the port's numpy packer over one epoch
    of phase 6's training corpus at the variant's training config, in
    eval mode and in training mode from the same RandomState: every leaf
    equal; then the packer alone over a training epoch, native against
    numpy (median of 3), in seconds and as a share of the variant's
    median train epoch in phases 6 and 11; and the bf16 adjacency of the
    dense family under compute_dtype bfloat16 against the f32 one cast."""
    from ggnn_tpu_torch.data import native_pack
    from ggnn_tpu_torch.data.loader import infer_metadata
    from ggnn_tpu_torch.training.variants import make_adapter

    native_kinds = (native_pack.SparseProcessed, native_pack.DenseProcessed,
                    native_pack.GCNProcessed)
    train = corpus[0]
    results = {}
    for variant in NATIVE_VARIANTS:
        config = train_config(variant, {"num_epochs": 1})
        meta = infer_metadata([train], config["tie_fwd_bkwd"])
        pair = {on: make_adapter(variant, {**config, "native_pack": on},
                                 meta) for on in (True, False)}
        rec = {"batches": {}}
        for training in (False, True):
            mode = "training" if training else "eval"
            processed, streams = {}, {}
            for on, adapter in pair.items():
                t0 = time.perf_counter()
                processed[on] = adapter.preprocess(
                    train, training,
                    np.random.RandomState(0) if training else None)
                adapter.plan(processed[on])
                rec[f"preprocess_s_{'native' if on else 'numpy'}_{mode}"] = \
                    time.perf_counter() - t0
                if isinstance(processed[on], native_kinds) is not on:
                    raise RuntimeError(f"{variant}: native_pack {on} "
                                       f"preprocessed {type(processed[on])}")
                streams[on] = adapter.batches(
                    processed[on], training,
                    np.random.RandomState(1) if training else None)
            rec["batches"][mode] = check_stream(
                f"{variant} {mode}: native against numpy", streams[True],
                streams[False])
        for on, adapter in pair.items():
            rec[f"pack_s_{'native' if on else 'numpy'}"] = median_seconds(
                lambda: sum(1 for _ in adapter.batches(
                    processed[on], True, np.random.RandomState(2))))
        epoch_s = epoch_seconds[variant]
        rec.update(epoch_s=epoch_s,
                   share_native=rec["pack_s_native"] / epoch_s,
                   share_numpy=rec["pack_s_numpy"] / epoch_s,
                   speedup=rec["pack_s_numpy"] / rec["pack_s_native"])
        log(f"native {variant}: {rec['batches']} batches (eval, training) "
            "bit-equal to the numpy packer's; one training epoch packs in "
            f"{rec['pack_s_native']:.4f} s natively against "
            f"{rec['pack_s_numpy']:.4f} s with numpy (median of "
            f"{HOST_REPEATS}, {rec['speedup']:.2f}x): "
            f"{rec['share_native']:.1%} against {rec['share_numpy']:.1%} of "
            f"the median train epoch's {epoch_s:.3f} s; {card}")
        results[variant] = rec
    for variant in ("dense", "blocked"):
        config = train_config(variant, {"num_epochs": 1})
        meta = infer_metadata([train], config["tie_fwd_bkwd"])
        f32 = make_adapter(variant, config, meta)
        b16 = make_adapter(variant, {**config, **BF16}, meta)
        count = 0
        for a, b in zip(f32.batches(f32.preprocess(train, False), False),
                        b16.batches(b16.preprocess(train, False), False)):
            cast = torch.from_numpy(a.adjacency).to(torch.bfloat16)
            if (b.adjacency.dtype != torch.bfloat16
                    or not torch.equal(b.adjacency, cast)
                    or not same_batch(dataclasses.replace(b, adjacency=cast),
                                      dataclasses.replace(a,
                                                          adjacency=cast))):
                raise RuntimeError(f"{variant} bf16 batch {count} is not "
                                   "the f32 batch with its adjacency cast")
            count += 1
        results[f"{variant}_bf16_batches"] = count
        log(f"native {variant} bf16: {count} batches, each adjacency the "
            "f32 one cast to bf16 bit for bit, the other leaves equal; "
            f"{card}")
    return results


def native_async_phase(runner, card):
    """The async corpus cache over configs/async_tpu.json's training
    corpus (phase 12's, preprocessed by its Runner): the cached packer
    against the flat packer in eval mode and over two training epochs
    from one RandomState, every leaf equal; the cache's build and both
    packers over a training epoch (median of 3)."""
    from ggnn_tpu_torch.data import async_schedule

    cfg, caps = runner.config, runner.adapter.caps
    processed = runner.train_processed
    R, S = cfg["propagation_rounds"], cfg["propagation_substeps"]
    T = runner.meta.num_edge_types
    t0 = time.perf_counter()
    cache = async_schedule.build_async_pack_cache(processed, R, S, T)
    build_s = time.perf_counter() - t0
    if cache is None or not cache.matches(processed, R, S, T):
        raise RuntimeError("the async corpus cache does not match its corpus")

    def pack(training, rng, with_cache):
        return async_schedule.pack_async_batches(
            processed, T, cfg["num_nodes"], caps, R, S, cfg["hidden_size"],
            runner.meta.annotation_size, training, rng,
            cache=cache if with_cache else None)

    batches = check_stream("async eval: cached against flat",
                           pack(False, None, True), pack(False, None, False))
    rngs = np.random.RandomState(3), np.random.RandomState(3)
    for epoch in range(2):
        check_stream(f"async training epoch {epoch}: cached against flat",
                     pack(True, rngs[0], True), pack(True, rngs[1], False))
    rec = {"batches": batches, "cache_build_s": build_s}
    for label, with_cache in (("cached", True), ("flat", False)):
        rec[f"pack_s_{label}"] = median_seconds(lambda: sum(
            1 for _ in pack(True, np.random.RandomState(4), with_cache)))
    log(f"native async: {batches} batches bit-equal, cached against flat, "
        "in eval mode and over two training epochs; the cache builds in "
        f"{build_s:.3f} s; a training epoch packs in "
        f"{rec['pack_s_cached']:.4f} s cached against "
        f"{rec['pack_s_flat']:.4f} s flat (median of {HOST_REPEATS}); {card}")
    return rec


def native_serving_phase(ckpt_dir, card):
    """The default sparse model on the card with `native_pack` on and
    off, in turns (numpy, native, native, numpy): the 3,000-graph
    request's pack (`Predictor._batches`, the profile tool's `pack` span;
    median of 3) and whole request (median of 3), the one-graph pack
    (`_pack_single_sparse`, median of 200) and the 1-graph latency
    (median of 20), each the median over the turns, the answers equal;
    then the default `dense` model in bf16 served on the card with the
    native bf16 adjacency (no hand kernel), against the CPU at
    TOL_BF16_SERVING."""
    from ggnn_tpu_torch.serving import Predictor
    from ggnn_tpu_torch.training.variants import _use_native

    requests = serving_requests()
    big, one = requests[3000], requests[1]
    ann = len(big[0]["node_features"][0])
    _, path = random_checkpoint("sparse", ckpt_dir, tag="_native")
    predictors = {on: Predictor.from_checkpoint(
        path, "sparse", config_overrides={"native_pack": on})
        for on in (True, False)}
    for on, predictor in predictors.items():
        if _use_native(predictor.config) is not on:
            raise RuntimeError(f"native_pack {on} did not select its packer")

    def request(predictor, graphs):
        torch.cuda.synchronize()
        out = predictor(graphs)
        torch.cuda.synchronize()
        return out

    answers = {on: request(p, big) for on, p in predictors.items()}
    for predictor in predictors.values():
        for _ in range(5):
            request(predictor, one)
    turns = {}
    for on in (False, True, True, False):
        p, label = predictors[on], "native" if on else "numpy"
        for key, value in (
                ("pack_ms_3000", 1e3 * median_seconds(
                    lambda: list(p._batches(big, ann)))),
                ("request_ms_3000", 1e3 * median_seconds(
                    lambda: request(p, big))),
                ("single_pack_us", 1e6 * median_seconds(
                    lambda: p._pack_single_sparse(one[0], ann), repeats=200)),
                ("latency_ms_1", 1e3 * median_seconds(
                    lambda: request(p, one), repeats=20))):
            turns.setdefault(f"{key}_{label}", []).append(value)
    rec = {key: statistics.median(values) for key, values in turns.items()}
    rec["turns"] = turns
    err = float(np.abs(answers[True] - answers[False]).max())
    if err > TOL_ARTIFACT:
        raise RuntimeError(f"native and numpy packs answer {err} apart")
    rec["max_abs_err_native_vs_numpy"] = err
    log("native serving, sparse, in turns (numpy, native, native, numpy; "
        "each the median of the two turns): 3,000 graphs: pack "
        f"{rec['pack_ms_3000_native']:.3f} ms native against "
        f"{rec['pack_ms_3000_numpy']:.3f} ms numpy, request "
        f"{rec['request_ms_3000_native']:.3f} against "
        f"{rec['request_ms_3000_numpy']:.3f} ms (median of {HOST_REPEATS}); "
        f"one-graph pack {rec['single_pack_us_native']:.1f} against "
        f"{rec['single_pack_us_numpy']:.1f} us (median of 200); 1-graph "
        f"latency {rec['latency_ms_1_native']:.3f} against "
        f"{rec['latency_ms_1_numpy']:.3f} ms (median of 20); answers "
        f"{err:.3e} apart; {card}; turns {turns}")
    _, bf16_path = random_checkpoint("dense", ckpt_dir, BF16,
                                     tag="_bf16_native")
    predictor = Predictor.from_checkpoint(bf16_path, "dense")
    single = predictor._pack_single_dense(one[0], ann)
    _, dense_batches = predictor._dense_batches(requests[300], ann)
    dtypes = {single.adjacency.dtype} | {b.adjacency.dtype
                                         for b in dense_batches}
    if dtypes != {torch.bfloat16}:
        raise RuntimeError(f"bf16 dense serving packed adjacencies {dtypes}")
    rec["dense_bf16"] = counted_serving(
        "dense", ckpt_dir, per_request(NO_LAUNCH), overrides=BF16,
        sizes=(1, 300), tag="_bf16_native", tol=TOL_BF16_SERVING)
    log("native serving, dense bf16: the adjacency of every batch bf16 "
        f"(native), max abs error against the CPU "
        f"{rec['dense_bf16']['max_abs_err_vs_cpu']:.3e} (tolerance "
        f"{TOL_BF16_SERVING}); {card}")
    return rec


def native_training_phase(corpus, log_dir, card):
    """End to end: `sparse`, `gcn` and `dense` at their training configs,
    2 epochs each with the numpy and with the native packer in turns
    (numpy, native, native, numpy): the Runner's set-up seconds
    (preprocess and plan) and train graphs/s per epoch."""
    from ggnn_tpu_torch.training.runner import Runner

    train, valid = corpus
    results = {}
    for variant in ("sparse", "gcn", "dense"):
        runs = {"native": [], "numpy": []}
        for i, on in enumerate((False, True, True, False)):
            label = "native" if on else "numpy"
            t0 = time.perf_counter()
            runner = Runner(variant, train_config(
                variant, {"num_epochs": 2, "native_pack": on}),
                train_data=train, valid_data=valid, quiet=True,
                log_dir=os.path.join(log_dir, f"{variant}_{i}_{label}"))
            setup_s = time.perf_counter() - t0
            if packer_kind(runner) != label:
                raise RuntimeError(f"{variant}: native_pack {on} packed "
                                   f"with {packer_kind(runner)}")
            history = runner.train()
            runs[label].append({
                "setup_s": setup_s,
                "train_graphs_per_s": [e["train_results"][3]
                                       for e in history]})
        summary = {label: {
            "setup_s_median": statistics.median(r["setup_s"] for r in rec),
            "train_graphs_per_s_median": statistics.median(
                g for r in rec for g in r["train_graphs_per_s"])}
            for label, rec in runs.items()}
        results[variant] = {"runs": runs, **summary}
        log(f"native training, {variant}: train graphs/s (median of 4 "
            "epochs in turns) "
            f"{summary['native']['train_graphs_per_s_median']:.1f} native "
            f"against {summary['numpy']['train_graphs_per_s_median']:.1f} "
            f"numpy; set-up {summary['native']['setup_s_median']:.3f} s "
            f"against {summary['numpy']['setup_s_median']:.3f} s; {card}")
    return results


def native_phase(build, corpus, epoch_seconds, async_runner, work_dir):
    """Phase 19: the native packer's build, its bits and host time against
    the numpy packers, the async cache, and native serving on the card."""
    from ggnn_tpu_torch import native

    start = time.perf_counter()
    if native._no_native_env() or not native.native_available():
        raise RuntimeError("the native packer is not available")
    card = gpu_name_and_power()
    gxx_s = build["gxx_seconds"]
    log(f"native build: {build['gxx']}; {build['path']}; "
        + (f"g++ {gxx_s:.2f} s" if gxx_s is not None
           else "built before this run")
        + f", {build['seconds']:.2f} s to build and load; "
        f"{os.cpu_count()} host cores, 4 packing threads; {card}")
    bits = native_bits_phase(corpus, epoch_seconds, card)
    async_rec = native_async_phase(async_runner, card)
    serving = native_serving_phase(work_dir, card)
    training = native_training_phase(corpus, os.path.join(work_dir, "train"),
                                     card)
    seconds = time.perf_counter() - start
    log(f"native phase: {seconds:.1f} s; {card}")
    return {"build": build, "card": card, "host_cores": os.cpu_count(),
            "bits": bits,
            "async": async_rec, "serving": serving, "training": training,
            "seconds": seconds}


# ------------------------------------ train on device (ROADMAP A18)

# Graphs against eager steps: each parameter, max abs, and the loss,
# rtol; under torch's deterministic algorithms and in the default mode.
# Until the readout and the gathers' gradients summed in a fixed order
# (ops/segment.py), the readout's index_add_ atomics alone parted two
# eager bf16 runs by up to 3.6e-4 after 2 epochs in the default mode;
# now two default-mode eager runs must end bit-equal.
TOL_GRAPH_PARAM = 1e-5
TOL_GRAPH_LOSS = 1e-5


def graph_configs(keep=NO_DROPOUT):
    """(label, variant, config) of every configuration `train_on_device`
    takes in phase 20, every keep probability 1.0 (phase 23: `keep` {},
    each config's own dropout): each variant at its
    phase-6 training config (`dense` at bench.py's buckets [16, 32] and
    256 graphs a batch), configs/sparse_attention.json at 20,000 nodes,
    async at configs/async_tpu.json, each other route of the sparse GGNN
    with attention off and on (as phase 13 steps them) and
    configs/sparse_wide_bf16.json on the combined lane and per edge with
    attention (as phase 17 steps them)."""
    configs = [("sparse", "sparse", train_config("sparse", keep)),
               ("dense", "dense", train_config("dense", keep)),
               ("gcn", "gcn", train_config("gcn", keep)),
               ("sparse_attention", "sparse", attention_config(keep)),
               ("blocked", "blocked", train_config("blocked", keep)),
               ("gcn_blocked", "gcn_blocked",
                train_config("gcn_blocked", keep)),
               ("async", "async", train_config("async", keep))]
    for route, keys in ROUTES.items():
        for attention in (False, True):
            configs.append((
                f"sparse ({route}, attention {'on' if attention else 'off'})",
                "sparse", attention_config({
                    **keys, "use_propagation_attention": attention,
                    **keep})))
    configs.append(("sparse_wide_bf16", "sparse", bf16_config(keep)))
    configs.append(("sparse_wide_bf16 (per-edge, attention on)", "sparse",
                    bf16_config({"aggregate_first": False,
                                 "use_propagation_attention": True,
                                 **keep})))
    return configs


def route_of(config):
    """The message route a sparse config takes (`ROUTES`' keys, or
    "combined")."""
    for route, keys in ROUTES.items():
        if all(config.get(k, True) == v for k, v in keys.items()):
            return route
    return "combined"


def step_launches_wanted(variant, config, batch, launches=route_launches):
    """What a replay of one train step of `batch` must launch, as
    chip_smoke's six-tuple: a step's kernels (`launches` of the sparse
    route, `route_launches` or for the bf16 counters
    `bf16_route_launches`; the GCN's layers; the async substeps) or none
    for the dense family."""
    if variant in ("dense", "blocked", "gcn_blocked"):
        return NO_LAUNCH
    if variant == "gcn":
        layers = config["num_timesteps"]
        return (0, 0, 0, layers, layers - 1, 0)
    if variant == "async":
        b1, b2 = async_launches(batch, config)
        return (b1, b2, 0, 0, 0, 0)
    return launches(route_of(config), config["use_propagation_attention"],
                    sum(config["layer_timesteps"]), True)


def eager_epochs(runner, epochs):
    """`train_on_device`'s steps run eagerly on the card: one pack, JAX's
    groups in their order; (last loss, the numpy batches in step
    order)."""
    from ggnn_tpu_torch.utils.timing import shape_groups

    batches = list(runner.adapter.batches(runner.train_processed, True,
                                          runner.np_rng))
    steps = [b for group in shape_groups(batches) for b in group]
    on_card = [b.to(runner.device) for b in steps]
    for _ in range(epochs):
        for batch in on_card:
            loss, _ = runner.train_step(batch)
    runner.train_step_id += epochs * len(steps)
    torch.cuda.synchronize()
    return float(loss), steps


@contextlib.contextmanager
def eager_steps(runner):
    """Inside the block `runner.run_epoch` runs its steps eagerly: the
    eager twin of the replayed steps, `train_step` and `eval_step` called
    directly on each batch moved to the card."""
    saved = runner.train_graphs, runner.eval_graphs
    runner.train_graphs = lambda batch: runner.train_step(
        batch.to(runner.device))
    runner.eval_graphs = lambda batch: runner.eval_step(
        batch.to(runner.device))
    try:
        yield runner
    finally:
        runner.train_graphs, runner.eval_graphs = saved


def max_param_error(a, b):
    want = dict(b.params.named_parameters())
    return max(float((p - want[n]).abs().max().detach())
               for n, p in a.params.named_parameters())


@contextlib.contextmanager
def deterministic_algorithms():
    """`torch.use_deterministic_algorithms` (warnings only) inside the
    block: index_add_ sums in a fixed order, so a graph and the eager
    steps it replays can agree bit for bit."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def graph_vs_eager(label, variant, config, corpus, log_dir):
    """(a) and (b) for one configuration: `train_on_device(2)` on one
    Runner against the same steps run eagerly on a twin (same seed:
    same weights, pack and order), both under deterministic algorithms
    (`deterministic_algorithms`); the launches each replay holds, from
    its graph's capture, against what its step must launch; the counters
    over the call against 2 x (one warm-up step and the capture) each
    graph's launches,
    so no replay launched a kernel eagerly; and the eager twin's
    counters against 2 epochs of the replays' launches."""
    from ggnn_tpu_torch.ops.kernels import launch_counts as all_counts
    from ggnn_tpu_torch.training.runner import Runner

    config = {**config, "num_epochs": 2}
    train, valid = corpus
    graph, eager = (Runner(variant, dict(config), train_data=train,
                           valid_data=valid, log_dir=os.path.join(log_dir, n),
                           quiet=True, tensorboard=False)
                    for n in ("graph", "eager"))
    zero_launch_counts()
    t0 = time.perf_counter()
    with deterministic_algorithms():
        loss = graph.train_on_device(2)
        torch.cuda.synchronize()
    graph_s = time.perf_counter() - t0
    counted = all_counts()
    graphs = list(graph._epochs_fn.graphs.values())
    in_graphs = {k: sum(g.launches.get(k, 0) for g in graphs)
                 for k in counted}
    if any(counted[k] != 2 * in_graphs[k] for k in counted):
        raise RuntimeError(f"{label}: the counters read {counted} over "
                           f"train_on_device, not 2 x (a warm-up step and "
                           f"a capture) the graphs' {in_graphs}: a replay "
                           "launched eagerly")
    zero_launch_counts()
    t0 = time.perf_counter()
    with deterministic_algorithms():
        want_loss, steps = eager_epochs(eager, 2)
    eager_s = time.perf_counter() - t0
    eager_counts = all_counts()
    replays = graph.replay_launches
    if len(replays) != len(steps):
        raise RuntimeError(f"{label}: {len(replays)} replays an epoch for "
                           f"{len(steps)} steps")
    for k in eager_counts:
        if eager_counts[k] != 2 * sum(r.get(k, 0) for r in replays):
            raise RuntimeError(f"{label}: the eager steps launched "
                               f"{eager_counts}, the graphs hold {replays}:"
                               " a kernel of the step is not in its graph")
    per_step = [held(r) for r in replays]
    want = [step_launches_wanted(variant, config, b) for b in steps]
    bf16_per_step = [held(r, bf16_launch_counts) for r in replays]
    want_bf16 = ([step_launches_wanted(variant, config, b,
                                       bf16_route_launches) for b in steps]
                 if config.get("compute_dtype") == "bfloat16"
                 else [NO_LAUNCH] * len(steps))
    if per_step != want or bf16_per_step != want_bf16:
        raise RuntimeError(f"{label}: launches a replay {per_step} (bf16 "
                           f"{bf16_per_step}), expected {want} (bf16 "
                           f"{want_bf16})")
    param_err = max_param_error(graph, eager)
    loss_err = abs(loss - want_loss) / abs(want_loss)
    log(f"train_on_device {label} (deterministic algorithms): "
        f"{len(steps)} steps an epoch in "
        f"{len(graphs)} graphs; 2 epochs {graph_s:.2f} s (capture "
        f"included) against eager {eager_s:.2f} s; loss {loss:.6f} against "
        f"{want_loss:.6f}, relative error {loss_err:.3e} (limit "
        f"{TOL_GRAPH_LOSS}); parameters max abs error {param_err:.3e} "
        f"(limit {TOL_GRAPH_PARAM}); launches a replay {COUNTER_NAMES} "
        f"{sorted(set(per_step))}")
    if not (loss_err <= TOL_GRAPH_LOSS and param_err <= TOL_GRAPH_PARAM
            and graph.train_step_id == eager.train_step_id
            == graph.optimizer.count == 2 * len(steps)):
        raise RuntimeError(f"{label}: train_on_device disagrees with its "
                           "eager steps")
    default = default_mode_runs(label, variant, config, corpus, log_dir)
    return graph, {"steps_per_epoch": len(steps), "graphs": len(graphs),
                   "default_mode": default,
                   "seconds": graph_s, "eager_seconds": eager_s,
                   "loss": loss, "eager_loss": want_loss,
                   "loss_relative_error": loss_err,
                   "param_max_abs_error": param_err,
                   "launches_per_replay": sorted(set(per_step)),
                   "launches_over_call": counted}


def default_mode_runs(label, variant, config, corpus, log_dir):
    """Without deterministic algorithms: `train_on_device(2)` against an
    eager twin (each parameter within TOL_GRAPH_PARAM, the loss at rtol
    TOL_GRAPH_LOSS), and that twin against a second eager twin: every
    parameter and the loss bit-equal after 2 epochs (every sum of the
    step in a fixed order)."""
    from ggnn_tpu_torch.training.runner import Runner

    train, valid = corpus
    graph, first, second = (
        Runner(variant, dict(config), train_data=train, valid_data=valid,
               log_dir=os.path.join(log_dir, n), quiet=True,
               tensorboard=False)
        for n in ("default_graph", "default_eager", "default_eager2"))
    if torch.are_deterministic_algorithms_enabled():
        raise RuntimeError("deterministic algorithms are on")
    loss = graph.train_on_device(2)
    first_loss, _ = eager_epochs(first, 2)
    second_loss, _ = eager_epochs(second, 2)
    torch.cuda.synchronize()
    param_err = max_param_error(graph, first)
    loss_err = abs(loss - first_loss) / abs(first_loss)
    want = dict(second.params.named_parameters())
    bit_equal = (first_loss == second_loss and all(
        torch.equal(p, want[n]) for n, p in first.params.named_parameters()))
    repeat_err = max_param_error(first, second)
    log(f"train_on_device {label} (default mode): graph against eager "
        f"loss relative error {loss_err:.3e}, parameters {param_err:.3e} "
        f"(limits {TOL_GRAPH_LOSS}, {TOL_GRAPH_PARAM}); two eager runs "
        f"bit-equal: {bit_equal} (parameters {repeat_err:.3e}, losses "
        f"{first_loss!r} and {second_loss!r})")
    if not (loss_err <= TOL_GRAPH_LOSS and param_err <= TOL_GRAPH_PARAM):
        raise RuntimeError(f"{label}: in the default mode train_on_device "
                           "disagrees with its eager steps")
    if not bit_equal:
        raise RuntimeError(f"{label}: two default-mode eager runs part by "
                           f"{repeat_err:.3e}: a sum of the step is not in "
                           "a fixed order")
    return {"loss_relative_error": loss_err, "param_max_abs_error":
            param_err, "eager_repeat_bit_equal": bit_equal,
            "eager_repeat_param_max_abs_error": repeat_err}


def replay_busy_ms(epochs_fn, groups, steps):
    """Device-busy ms a step from `torch.profiler` over one epoch of
    replays; None where the trace holds no device kernel."""
    from torch.autograd import DeviceType

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        epochs_fn(groups, 1)
        torch.cuda.synchronize()
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA)
    return busy_us / 1e3 / steps if busy_us > 0 else None


def graph_timing(label, runner, eager_profile):
    """(c) for one Runner: train graphs/s and ms a step of the Runner's
    eager training epoch (`run_epoch` with `eager_steps`, its packer
    thread included) and of
    `train_on_device`'s replays (`time_epochs`, 1 and 3 epochs
    differenced over one pack), in turns (eager, graph);
    each one's idle share, 1 - busy / wall ms a step, the busy ms from a
    profiled epoch of replays (or from the eager profile of phase 9 where
    the trace shows no graph kernel) and from the eager profile."""
    from ggnn_tpu_torch.utils.timing import time_epochs

    turns = []
    for kind in ("eager", "graph"):
        if kind == "eager":
            t0 = time.perf_counter()
            with eager_steps(runner):
                _, _, _, graphs_per_s, steps = runner.run_epoch(
                    f"{label} eager", runner.train_processed, True)
            torch.cuda.synchronize()
            epoch_s = time.perf_counter() - t0
            turns.append({"kind": kind, "graphs_per_s": graphs_per_s,
                          "ms_per_step": epoch_s * 1e3 / steps,
                          "steps": steps})
            continue
        epochs_fn, groups, steps = runner.device_epochs()
        graphs = sum(int(b.num_graphs) for g in groups for b in g)
        seconds, loss = time_epochs(epochs_fn, groups)
        runner.train_step_id += (1 + 1 + 3) * steps
        if not np.isfinite(loss):
            raise RuntimeError(f"{label}: train_on_device loss {loss}")
        turns.append({"kind": kind, "graphs_per_s": graphs / seconds,
                      "ms_per_step": seconds * 1e3 / steps, "steps": steps,
                      "graphs": graphs, "loss": loss})
    busy = replay_busy_ms(epochs_fn, groups, steps)
    source = "replay profile"
    if busy is None:
        busy, source = eager_profile["device_busy_ms_per_step"], \
            "eager profile (phase 9): the trace shows no graph kernel"
    eager_busy = eager_profile["device_busy_ms_per_step"]
    for t in turns:
        t["idle_share"] = 1.0 - (busy if t["kind"] == "graph"
                                 else eager_busy) / t["ms_per_step"]
    text = ", ".join(f"{t['kind']} {t['graphs_per_s']:.1f} graphs/s "
                     f"{t['ms_per_step']:.3f} ms a step idle "
                     f"{t['idle_share']:.3f}" for t in turns)
    log(f"train_on_device timing {label} ({turns[1]['steps']} steps an "
        f"epoch): {text}; busy {busy:.3f} ms a replayed step ({source}), "
        f"{eager_busy:.3f} eager (phase 9 profile)")
    return {"turns": turns, "graph_busy_ms_per_step": busy,
            "graph_busy_source": source,
            "eager_busy_ms_per_step": eager_busy}


def graph_dropout(corpus, log_dir):
    """(d): `dense` with edge weights kept at 0.8 (the `sparse` and
    `blocked` default; `dense`'s own is 1.0) trained by
    `train_on_device(2)` and its eager twin: the parameters agree within
    TOL_GRAPH_PARAM (the replays drew the masks the eager steps draw:
    fresh ones every step), the validation loss falls, and one later
    eager step on each Runner agrees again (the seeded stream goes on);
    then a dropout mask drawn from the Runner's generator in a replayed
    step differs from replay to replay and equals the eager draw."""
    from ggnn_tpu_torch.ops.dropout import dropout
    from ggnn_tpu_torch.training.runner import Runner
    from ggnn_tpu_torch.utils.timing import make_epochs_fn

    config = train_config("dense", {"edge_weight_dropout_keep_prob": 0.8,
                                    "num_epochs": 2})
    train, valid = corpus
    graph, eager = (Runner("dense", dict(config), train_data=train,
                           valid_data=valid, log_dir=os.path.join(log_dir, n),
                           quiet=True, tensorboard=False)
                    for n in ("graph", "eager"))
    before = graph.run_epoch("valid", graph.valid_processed, False)[0]
    graph.train_on_device(2)
    eager_epochs(eager, 2)
    after = graph.run_epoch("valid", graph.valid_processed, False)[0]
    err = max_param_error(graph, eager)
    batch = next(iter(graph.adapter.batches(graph.train_processed, False)))
    for runner in (graph, eager):
        runner.train_step(batch.to(runner.device))
    later_err = max_param_error(graph, eager)
    state = graph.generator.get_state()
    probe, twin = (torch.Generator(device=graph.device) for _ in range(2))
    probe.set_state(state)
    twin.set_state(state)
    ones = torch.ones(4096, device=graph.device)
    mask = torch.zeros_like(ones)

    def step(_):
        mask.copy_(dropout(ones, 0.8, probe))
        return mask.sum()

    epochs_fn = make_epochs_fn(step, state=[mask], generators=[probe])
    masks = []
    for _ in range(3):
        epochs_fn([[ones]], 1)
        masks.append(mask.clone())
    fresh = all(not torch.equal(masks[i], masks[i + 1]) for i in range(2))
    eager_equal = all(torch.equal(m, dropout(ones, 0.8, twin))
                      for m in masks)
    log(f"train_on_device dropout (dense, edge weights kept at 0.8): "
        f"validation loss {before:.6f} -> {after:.6f}; graph against eager "
        f"parameters {err:.3e}, after one more eager step each "
        f"{later_err:.3e} (limit {TOL_GRAPH_PARAM}); masks of 3 replays "
        f"fresh each replay: {fresh}, equal to the eager draws: "
        f"{eager_equal}; kept share {float(masks[0].ne(0).float().mean()):.4f}")
    if not (after < before and err <= TOL_GRAPH_PARAM
            and later_err <= TOL_GRAPH_PARAM and fresh and eager_equal):
        raise RuntimeError("train_on_device's dropout is not the eager "
                           "stream's")
    return {"valid_loss_before": before, "valid_loss_after": after,
            "param_max_abs_error": err,
            "param_max_abs_error_after_eager_step": later_err,
            "masks_fresh_each_replay": fresh,
            "masks_equal_eager": eager_equal}


def train_on_device_phase(step_corpus, corpus, runners, profiles, work_dir):
    """Phase 20: (a) + (b) every configuration through `train_on_device`
    against its eager steps, (c) train graphs/s in turns with the eager
    Runner epoch, (d) dropout."""
    from ggnn_tpu_torch.data.synthetic import synthetic_molecules
    from ggnn_tpu_torch.training.runner import Runner

    start = time.perf_counter()
    card = gpu_name_and_power()
    checks = {}
    for label, variant, config in graph_configs():
        _, checks[label] = graph_vs_eager(label, variant, config,
                                          step_corpus,
                                          os.path.join(work_dir, label))
    checks_s = time.perf_counter() - start
    # bench.py's workload: 25,600 molecules, buckets [16, 32], 256 graphs
    # a batch: 100 batches in 2 shapes.
    bench = Runner("dense", train_config("dense", {"num_epochs": 1}),
                   train_data=synthetic_molecules(25600, seed=0),
                   valid_data=synthetic_molecules(256, seed=1),
                   log_dir=os.path.join(work_dir, "bench"), quiet=True,
                   tensorboard=False)
    timing = {"dense (bench.py workload)": graph_timing(
        "dense (bench.py workload)", bench, profiles["dense"])}
    for label in ("sparse", "gcn", "sparse_attention", "async"):
        timing[label] = graph_timing(label, runners[label], profiles[label])
    timing_s = time.perf_counter() - start - checks_s
    dropout_rec = graph_dropout(corpus, os.path.join(work_dir, "dropout"))
    seconds = time.perf_counter() - start
    log(f"train_on_device phase: {seconds:.1f} s (checks {checks_s:.1f}, "
        f"timing {timing_s:.1f}); {card}")
    return {"checks": checks, "timing": timing, "dropout": dropout_rec,
            "card": card, "seconds": seconds}


# ------------------------------------------------------------ mesh (A11)

TOL_MESH_LOSS = 1e-5                        # mesh vs single step: rtol
TOL_MESH_GRAD = {"rtol": 2e-4, "atol": 1e-6}  # every gradient leaf
TOL_NCCL = 1e-6                             # one nccl rank vs plain Runner
# Gloo moves CUDA tensors in all-reduce, all-to-all and all-gather but
# not point to point: the shift exchange copies through the host.
MESH_STAGED = ("p2p",)
MESH_DEVICE = "cuda:0"
MESH_ATTENTION = "sparse_attention"
# The mesh Runners train on the first 3,000 of phase 6's 6,000 training
# molecules (all of them until PR 16; cut to keep the script's time).
MESH_RUNNER_MOLECULES = 3000
# The type-TP case also saves its Runner as an Orbax directory and a
# pickle (phase 22 holds the two).
MESH_ORBAX_CASE = "sparse 1x2 type_tp"
# (label, variant, config overrides, n_data, n_edge). The mesh's dense
# family packs one bucket shape (stack_dense_batches refuses two).
MESH_CASES = (
    [("sparse 2x1", "sparse", {}, 2, 1)]
    + [(f"sparse 1x2 {x}", "sparse", {"boundary_exchange": x}, 1, 2)
       for x in ("alltoall", "shift", "ragged")]
    + [("sparse 1x2 type_tp", "sparse", {"edge_parallelism": "type_tp"},
        1, 2),
       ("sparse_attention 1x2", MESH_ATTENTION, {}, 1, 2),
       ("gcn 1x2", "gcn", {}, 1, 2), ("gcn 2x1", "gcn", {}, 2, 1)]
    + [(f"{v} 2x1", v, {"dense_bucket_sizes": [32]}, 2, 1)
       for v in ("dense", "blocked", "gcn_blocked")]
    + [("async 2x1", "async", {}, 2, 1)]
    + [(f"sparse 2x2 {x}", "sparse", {"boundary_exchange": x}, 2, 2)
       for x in ("alltoall", "shift", "ragged")])


def mesh_config(variant, overrides):
    """The variant's training config (configs/sparse_tpu.json's 20,000
    nodes for `sparse`, the attention config at them), every keep
    probability 1.0, 2 epochs, with `overrides`."""
    over = {**NO_DROPOUT, "num_epochs": 2, **overrides}
    if variant == MESH_ATTENTION:
        return attention_config(over)
    return train_config(variant, over)


def model_variant(variant):
    return "sparse" if variant == MESH_ATTENTION else variant


def mesh_step_launches(variant, kind, config, batch, train, n_edge):
    """What one rank launches for one of its batches in a mesh step (the
    prediction PERF.md states): the single-device route's launches, twice
    a propagation step on a node shard (its local and boundary lanes);
    type-TP's per-type route over the rank's types; none for the dense
    family."""
    if kind == "dense":
        return NO_LAUNCH
    if variant == "async":
        b1, b2 = async_launches(batch, config)
        return (b1, b2 if train else 0, 0, 0, 0, 0)
    lanes = 2 if n_edge > 1 and kind in ("sparse", "gcn") else 1
    if variant == "gcn":
        layers = config["num_timesteps"]
        return (0, 0, 0, lanes * layers,
                lanes * (layers - 1) if train else 0, 0)
    one = route_launches("per-type" if kind == "sparse_tp" else "combined",
                         config["use_propagation_attention"],
                         sum(config["layer_timesteps"]), train)
    return tuple(lanes * x for x in one)


def _add(total, counts):
    return [a + b for a, b in zip(total, counts)]


def _tf32_off():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def mesh_params(variant, config, meta, weights, device, edge_axis=None):
    from ggnn_tpu_torch.models.base import ModelParams, init_output_heads
    from ggnn_tpu_torch.training.variants import make_adapter
    adapter = make_adapter(model_variant(variant), config, meta)
    gen = torch.Generator().manual_seed(0)
    model = (adapter.build_model(gen, edge_axis=edge_axis)
             if edge_axis is not None else adapter.build_model(gen))
    params = ModelParams(model, init_output_heads(
        gen, config["hidden_size"], config["task_ids"]))
    params.load_state_dict({k: torch.from_numpy(v)
                            for k, v in weights.items()})
    return params.to(device)


def single_step(variant, config, meta, weights, batches, device):
    """The single-device step over every batch as one batch: (loss, MAE,
    {name: gradient}, ms of the step with its Adam update, median of 5
    after 2 warm-ups)."""
    from ggnn_tpu_torch.training.optimizer import TFAdam
    from ggnn_tpu_torch.utils.constants import SMALL_NUMBER
    params = mesh_params(variant, config, meta, weights, device)
    batches = [b.to(device) for b in batches]
    named = list(params.named_parameters())

    def loss_of():
        abs_s = sq_s = mask_s = 0.0
        for b in batches:
            out = params.graph.readout(params.heads, config["task_ids"],
                                       params.graph(b), b)
            diff = (out - b.targets) * b.target_mask
            abs_s = abs_s + diff.abs().sum(1)
            sq_s = sq_s + (0.5 * diff.square()).sum(1)
            mask_s = mask_s + b.target_mask.sum(1)
        count = mask_s + SMALL_NUMBER
        return (sq_s / count).sum(), abs_s / count

    loss, accs = loss_of()
    grads = torch.autograd.grad(loss, [p for _, p in named],
                                allow_unused=True)
    result = (float(loss.detach()), accs.detach().cpu().numpy(),
              {n: (torch.zeros_like(p) if g is None else g).cpu().numpy()
               for (n, p), g in zip(named, grads)})
    opt = TFAdam(params, config["learning_rate"],
                 config["clamp_gradient_norm"])

    def step():
        loss, _ = loss_of()
        opt.step(dict(zip([n for n, _ in named], torch.autograd.grad(
            loss, [p for _, p in named], allow_unused=True))))
    return result + (median_ms(step),)


def median_ms(step, warm=2, reps=5):
    for _ in range(warm):
        step()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def rank_mesh(n_data, n_edge):
    from ggnn_tpu_torch.parallel.mesh import make_mesh
    _tf32_off()
    mesh = make_mesh(n_data, n_edge, device=MESH_DEVICE,
                     host_staged=MESH_STAGED)
    if mesh.device.type != "cuda" or mesh.backend != "gloo":
        raise RuntimeError(f"rank {mesh.rank} runs {mesh.backend} on "
                           f"{mesh.device}")
    return mesh


def mesh_step_rank(variant, config, meta, weights, batches, n_data, n_edge,
                   kind, exchange):
    """One train step of `make_parallel_steps` on this rank (gloo on the
    card): its metrics, gradients, launches and the launches its batches
    predict."""
    from ggnn_tpu_torch.parallel import tp
    from ggnn_tpu_torch.parallel.step import (local_batches,
                                              make_parallel_steps,
                                              plan_caps, stack_for)
    from ggnn_tpu_torch.training.optimizer import TFAdam
    mesh = rank_mesh(n_data, n_edge)
    edge_axis = (mesh.edge if n_edge > 1 and kind in ("sparse", "gcn",
                                                      "sparse_tp")
                 else None)
    params = mesh_params(variant, config, meta, weights, mesh.device,
                         edge_axis)
    type_tp = kind == "sparse_tp"
    opt = TFAdam(params, config["learning_rate"],
                 config["clamp_gradient_norm"],
                 tp_axis=mesh.edge if type_tp else None,
                 tp_is_sharded=tp.is_tp_sharded_path if type_tp else None)
    types = None
    if type_tp:
        tp.shard_parameters(params, opt, mesh.edge, meta.num_edge_types)
        tr = tp.type_range(meta.num_edge_types, mesh.edge)
        types = (tr.start, tr.stop)
    train_step, _ = make_parallel_steps(
        params, opt, config, config["task_ids"], mesh, return_grads=True,
        batch_kind=kind)
    caps = (plan_caps(kind, batches, n_edge)
            if kind in ("sparse", "gcn") and n_edge > 1 else None)
    local = local_batches(stack_for(kind, batches, n_data, caps, exchange,
                                    n_edge == 1), mesh, kind)
    want = NO_LAUNCH
    for b in local:
        want = _add(want, mesh_step_launches(variant, kind, config, b, True,
                                             n_edge))
    zero_launch_counts()
    metrics = train_step(local, torch.Generator(
        device=mesh.device).manual_seed(1))
    torch.cuda.synchronize()
    return {"loss": float(metrics["loss"]),
            "accuracies": metrics["accuracies"].cpu().numpy(),
            "grads": {n: g.cpu().numpy()
                      for n, g in metrics["grads"].items()},
            "types": types, "launches": list(launch_counts()),
            "want": list(want), "device": str(mesh.device)}


def params_digest(runner):
    """sha256 of the Runner's whole weights (gathered under type-TP)."""
    import hashlib
    digest = hashlib.sha256()
    with runner._whole_weights():
        for name, p in runner.params.named_parameters():
            digest.update(name.encode())
            digest.update(p.detach().cpu().numpy().tobytes())
    return digest.hexdigest()


def mesh_runner_rank(variant, config, corpus, n_data, n_edge, log_dir,
                     save_dir=None):
    """2 epochs through `Runner(mesh=)` on this rank: the validation loss
    of the initial weights and after each epoch, the weights' digest
    after each training epoch, the kernels' counters over `train()` and
    the launches its steps' batches predict, the exchange, and ms a
    mesh train step (median of 5, synchronised). Given `save_dir`, every
    rank then saves the Runner through `Runner._save` as an Orbax
    directory and as a pickle (rank 0 writes; type-TP gathers first),
    and returns the ms of each save and the paths this rank wrote."""
    from ggnn_tpu_torch.training.runner import Runner
    mesh = rank_mesh(n_data, n_edge)
    train, valid = corpus
    t0 = time.perf_counter()
    runner = Runner(model_variant(variant), config, train_data=train,
                    valid_data=valid, log_dir=log_dir, quiet=True,
                    tensorboard=False, mesh=mesh)
    setup_s = time.perf_counter() - t0
    if runner.device != mesh.device:
        raise RuntimeError(f"the mesh Runner runs on {runner.device}")
    init_loss = runner.run_epoch("initial validation",
                                 runner.valid_processed, False)[0]
    want, digests, last = list(NO_LAUNCH), [], {}

    def counted(step, train):
        def run(batches, *args):
            nonlocal want
            for b in batches:
                want = _add(want, mesh_step_launches(
                    variant, runner._mesh_kind, config, b, train, n_edge))
            if train:
                last["batches"] = batches
            return step(batches, *args)
        return run

    mesh_train = runner._mesh_train
    runner._mesh_train = counted(mesh_train, True)
    runner._mesh_eval = counted(runner._mesh_eval, False)
    run_epoch = runner.run_epoch

    def epoch_then_digest(name, processed, is_training):
        out = run_epoch(name, processed, is_training)
        if is_training:
            digests.append(params_digest(runner))
        return out

    runner.run_epoch = epoch_then_digest
    zero_launch_counts()
    t0 = time.perf_counter()
    log_rec = runner.train()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = list(launch_counts())
    saved = {}
    if save_dir is not None:
        from ggnn_tpu_torch.training import runner as runner_mod
        save, wrote = runner_mod.save_checkpoint, []
        runner_mod.save_checkpoint = lambda path, *a, **k: (
            wrote.append(path), save(path, *a, **k))
        try:
            for fmt, path in (("directory", save_dir),
                              ("pickle", save_dir + ".pickle")):
                t0 = time.perf_counter()
                runner._save(path)
                saved[f"save_ms_{fmt}"] = (time.perf_counter() - t0) * 1e3
        finally:
            runner_mod.save_checkpoint = save
        saved["wrote"] = wrote
    gen = torch.Generator(device=mesh.device).manual_seed(2)
    step_ms = median_ms(lambda: mesh_train(last["batches"], gen))
    return {"kind": runner._mesh_kind, "saved": saved,
            "exchange": (runner._resolve_exchange()
                         if runner._nodeshard_caps is not None else None),
            "setup_s": setup_s, "train_s": train_s,
            "initial_valid_loss": init_loss,
            "valid_losses": [e["valid_results"][0] for e in log_rec],
            "train_losses": [e["train_results"][0] for e in log_rec],
            "train_steps": runner.train_step_id,
            "valid_steps": runner.valid_step_id,
            "digests": digests, "launches": launches, "want": want,
            "step_ms": step_ms, "device": str(mesh.device)}


def nccl_rank(config, corpus, log_dir):
    """`sparse` for 1 epoch through `Runner(mesh=make_mesh(1, 1))` over a
    one-rank nccl group, against the plain Runner from the same seed,
    both under deterministic algorithms: the largest parameter
    difference, the losses, each run's launches and, for the plain
    Runner, whose steps replay, the launches its graphs hold and its
    steps (the mesh Runner's steps stay eager)."""
    from ggnn_tpu_torch.parallel.mesh import make_mesh
    from ggnn_tpu_torch.training.runner import Runner
    _tf32_off()
    mesh = make_mesh(1, 1, device=MESH_DEVICE)
    if mesh.backend != "nccl" or mesh.world.group is None:
        raise RuntimeError(f"the one-rank mesh runs {mesh.backend}")
    train, valid = corpus
    runs = {}
    with deterministic_algorithms():
        for label, kwargs in (("plain", {"device": MESH_DEVICE}),
                              ("mesh", {"mesh": mesh})):
            zero_launch_counts()
            runner = Runner("sparse", config, train_data=train,
                            valid_data=valid, log_dir=log_dir, quiet=True,
                            tensorboard=False, **kwargs)
            log_rec = runner.train()
            torch.cuda.synchronize()
            runs[label] = (runner, log_rec, list(launch_counts()))
    plain, meshed = runs["plain"][0], runs["mesh"][0]
    plain_graphs = {name: [held(g.launches) for g in cache.graphs.values()]
                    for name, cache in (("train", plain.train_graphs),
                                        ("validation", plain.eval_graphs))}
    by_name = dict(meshed.params.named_parameters())
    diffs = [float((p.detach() - by_name[n].detach()).abs().max())
             for n, p in plain.params.named_parameters()]
    return {"max_abs_param_diff": max(diffs),
            "bit_equal": max(diffs) == 0.0,
            "train_loss": [runs[k][1][0]["train_results"][0]
                           for k in ("plain", "mesh")],
            "valid_loss": [runs[k][1][0]["valid_results"][0]
                           for k in ("plain", "mesh")],
            "launches": {k: runs[k][2] for k in runs},
            "plain_graphs": plain_graphs,
            "plain_steps": [plain.train_step_id, plain.valid_step_id],
            "backend": mesh.backend, "device": str(mesh.device)}


def check_mesh_step(label, results, oracle):
    """Every rank's step against the single-device step on the card."""
    loss, accs, grads = oracle[:3]
    worst = 0.0
    for rank, out in enumerate(results):
        if abs(out["loss"] - loss) > TOL_MESH_LOSS * abs(loss):
            raise RuntimeError(f"mesh {label} rank {rank}: loss "
                               f"{out['loss']} against {loss}")
        np.testing.assert_allclose(out["accuracies"], accs,
                                   rtol=TOL_MESH_LOSS,
                                   err_msg=f"mesh {label} rank {rank}")
        for name, got in out["grads"].items():
            want = grads[name]
            if out["types"] is not None and name.endswith(
                    ("edge_weights", "attention")) and ".layers." in name:
                want = want[out["types"][0]:out["types"][1]]
            np.testing.assert_allclose(
                got, want, err_msg=f"mesh {label} rank {rank} {name}",
                **TOL_MESH_GRAD)
            scale = float(np.abs(want).max()) or 1.0
            worst = max(worst, float(np.abs(got - want).max()) / scale)
        if out["launches"] != out["want"]:
            raise RuntimeError(f"mesh {label} rank {rank} step launched "
                               f"{out['launches']}, predicted "
                               f"{out['want']} ({COUNTER_NAMES})")
    return worst


def check_mesh_runner(label, results, devices=None):
    """The ranks' 2-epoch runs: the weights alike after each epoch, each
    rank's launches as predicted and on its device (`devices`, by rank;
    MESH_DEVICE for every rank by default), the validation loss falling."""
    first = results[0]
    devices = devices or [MESH_DEVICE] * len(results)
    for rank, out in enumerate(results):
        if out["digests"] != first["digests"] or len(out["digests"]) != 2:
            raise RuntimeError(f"mesh {label}: rank {rank}'s weights "
                               "differ after an epoch")
        if out["launches"] != out["want"]:
            raise RuntimeError(f"mesh {label} rank {rank}: train() "
                               f"launched {out['launches']}, predicted "
                               f"{out['want']} ({COUNTER_NAMES})")
        if out["device"] != devices[rank]:
            raise RuntimeError(f"mesh {label} rank {rank} ran on "
                               f"{out['device']}")
    losses = [first["initial_valid_loss"]] + first["valid_losses"]
    if not all(np.isfinite(losses)) or losses[-1] >= losses[0]:
        raise RuntimeError(f"mesh {label}: validation loss {losses} did "
                           "not fall")


def mesh_phase(corpus, step_corpus, work_dir):
    """Phase 21 (see the module docstring)."""
    from ggnn_tpu_torch.data.loader import infer_metadata
    from ggnn_tpu_torch.models.base import ModelParams, init_output_heads
    from ggnn_tpu_torch.parallel.launch import RankPool
    from ggnn_tpu_torch.training.runner import mesh_kind
    from ggnn_tpu_torch.training.variants import make_adapter
    # The ranks import the functions they run by module name; run as a
    # script, this file's own are __main__'s, which a rank cannot import.
    import chip_smoke as ranks
    start = time.perf_counter()
    dev = torch.device(MESH_DEVICE)
    torch.cuda.empty_cache()   # the earlier phases' cached blocks
    log(f"mesh phase: gloo ranks sharing {MESH_DEVICE}; collectives copied "
        f"through the host: {', '.join(MESH_STAGED)} (gloo sends no CUDA "
        "tensor point to point); all-reduce, all-to-all and all-gather "
        "move CUDA tensors")
    runner_corpus = (corpus[0][:MESH_RUNNER_MOLECULES], corpus[1])
    cases, worlds = {}, {}
    for label, variant, over, n_data, n_edge in MESH_CASES:
        worlds.setdefault(n_data * n_edge, []).append(
            (label, variant, over, n_data, n_edge))
    spawn_s = {}
    for world, group in sorted(worlds.items()):
        t0 = time.perf_counter()
        with RankPool(world, "gloo", python_path=[REPO],
                      timeout=600) as pool:
            spawn_s[world] = time.perf_counter() - t0
            for label, variant, over, n_data, n_edge in group:
                t_case = time.perf_counter()
                config = mesh_config(variant, over)
                train, valid = step_corpus
                meta = infer_metadata([train, valid],
                                      config["tie_fwd_bkwd"])
                adapter = make_adapter(model_variant(variant), config, meta)
                processed = adapter.preprocess(train, False)
                adapter.plan(processed)
                batches = list(itertools.islice(
                    adapter.batches(processed, False), 2))
                gen = torch.Generator().manual_seed(0)
                weights = {n: p.detach().numpy() for n, p in ModelParams(
                    adapter.build_model(gen), init_output_heads(
                        gen, config["hidden_size"],
                        config["task_ids"])).named_parameters()}
                kind = mesh_kind(model_variant(variant), config,
                                 SimpleNamespace(shape={"data": n_data,
                                                        "edge": n_edge}),
                                 meta.num_edge_types)
                exchange = config.get("boundary_exchange", "alltoall")
                oracle = single_step(variant, config, meta, weights,
                                     batches, dev)
                steps = pool.run(ranks.mesh_step_rank, variant, config,
                                 meta, weights, batches, n_data, n_edge,
                                 kind, exchange)
                worst = check_mesh_step(label, steps, oracle)
                save_dir = (os.path.join(work_dir, "type_tp_orbax")
                            if label == MESH_ORBAX_CASE else None)
                runs = pool.run(ranks.mesh_runner_rank, variant, config,
                                runner_corpus, n_data, n_edge, os.path.join(
                                    work_dir, label.replace(" ", "_")),
                                save_dir=save_dir)
                check_mesh_runner(label, runs)
                first = runs[0]
                rec = {
                    "shape": [n_data, n_edge], "kind": kind,
                    "exchange": first["exchange"],
                    "batch_graphs": [int(b.num_graphs) for b in batches],
                    "step_loss": steps[0]["loss"], "single_loss": oracle[0],
                    "step_max_rel_grad_err": worst,
                    "step_launches": [s["launches"] for s in steps],
                    "runner_launches": [r["launches"] for r in runs],
                    "train_steps": first["train_steps"],
                    "valid_steps": first["valid_steps"],
                    "initial_valid_loss": first["initial_valid_loss"],
                    "valid_losses": first["valid_losses"],
                    "train_losses": first["train_losses"],
                    "weights_equal_across_ranks": True,
                    "setup_s": max(r["setup_s"] for r in runs),
                    "train_s": max(r["train_s"] for r in runs),
                    "mesh_step_ms": max(r["step_ms"] for r in runs),
                    "single_step_ms": oracle[3],
                    "saved": [r["saved"] for r in runs],
                    "digests": first["digests"],
                    "config": config,
                    "seconds": time.perf_counter() - t_case}
                cases[label] = rec
                log(f"mesh {label} ({kind}, {rec['exchange']}): step loss "
                    f"{rec['step_loss']:.6f} vs single {oracle[0]:.6f}, "
                    f"gradients within {worst:.2e} of the largest; "
                    f"launches a rank {rec['runner_launches'][0]} "
                    f"({COUNTER_NAMES}) as predicted; validation loss "
                    f"{rec['initial_valid_loss']:.5f} -> "
                    f"{rec['valid_losses'][-1]:.5f}; weights bit-equal "
                    f"across ranks each epoch; ms a step: mesh "
                    f"{rec['mesh_step_ms']:.3f}, single "
                    f"{rec['single_step_ms']:.3f}; {rec['seconds']:.1f} s")
    t0 = time.perf_counter()
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    with RankPool(1, "nccl", python_path=[REPO], timeout=600,
                  env=env) as pool:
        nccl = pool.run(ranks.nccl_rank,
                        mesh_config("sparse", {"num_epochs": 1}),
                        step_corpus, os.path.join(work_dir, "nccl"))[0]
    nccl["seconds"] = time.perf_counter() - t0
    if nccl["max_abs_param_diff"] > TOL_NCCL:
        raise RuntimeError(f"the one-rank nccl mesh Runner is "
                           f"{nccl['max_abs_param_diff']} from the plain "
                           "Runner")
    # The plain Runner replays: its counters read 2 x its graphs'
    # launches; the mesh Runner's eager steps launch a replay's each.
    graphs = nccl["plain_graphs"]
    (step,), (forward,) = graphs["train"], graphs["validation"]
    train_steps, valid_batches = nccl["plain_steps"]
    eager_want = [train_steps * a + valid_batches * b
                  for a, b in zip(step, forward)]
    if (nccl["launches"]["plain"] != [2 * (a + b)
                                      for a, b in zip(step, forward)]
            or nccl["launches"]["mesh"] != eager_want):
        raise RuntimeError(f"nccl mesh launches {nccl['launches']}, the "
                           f"plain Runner's graphs {graphs} over "
                           f"{nccl['plain_steps']} steps")
    log(f"mesh nccl 1x1: parameters {nccl['max_abs_param_diff']:.3g} from "
        f"the plain Runner (bit-equal: {nccl['bit_equal']}), launches "
        f"{nccl['launches']['mesh']}; {nccl['seconds']:.1f} s")
    seconds = time.perf_counter() - start
    log(f"mesh phase: {seconds:.1f} s (rank spawns "
        f"{', '.join(f'{w} ranks {s:.1f} s' for w, s in spawn_s.items())})"
        "; ranks share one card, so no time here is a scaling number")
    return {"cases": cases, "nccl": nccl, "staged": list(MESH_STAGED),
            "spawn_s": spawn_s, "seconds": seconds,
            "runner_corpus": runner_corpus}


# ------------------------------------------- Orbax checkpoints (A17)

# What the JAX package writes its Orbax checkpoints with; the port reads
# and writes the format itself (training/orbax_dir.py, native/zstd.cpp).
ORBAX_LIBRARIES = ("orbax", "tensorstore", "zstandard")
ORBAX_FIXTURE = os.path.join(REPO, "tests", "fixtures", "orbax",
                             "sparse_h32")
# The rolling checkpoint kept in both formats: epoch 1, after step 2.
ORBAX_EVERY = 2


def zstd_build():
    """The zstd decoder (native/zstd.cpp) built by g++ into build/native/
    (or loaded where this checkout built it): seconds and the library's
    path. No fallback: a failed build fails the script."""
    from ggnn_tpu_torch import native
    from ggnn_tpu_torch.native import codec

    t0 = time.perf_counter()
    codec._lib()
    return {"seconds": time.perf_counter() - t0,
            "path": os.path.relpath(native.library_path(native.ZSTD_SOURCE),
                                    REPO)}


def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def runner_state(runner):
    """The Runner's weights, Adam moments and counters, on the host."""
    out = {f"params.{n}": p.detach().cpu()
           for n, p in runner.params.named_parameters()}
    for moment, state in (("mu", runner.optimizer.mu),
                          ("nu", runner.optimizer.nu)):
        out.update({f"{moment}.{n}": t.detach().cpu()
                    for n, t in state.items()})
    out["counters"] = (int(runner.optimizer.count), runner.train_step_id,
                       runner.valid_step_id)
    return out


def same_state(a, b) -> bool:
    return set(a) == set(b) and all(
        torch.equal(a[k], b[k]) if torch.is_tensor(a[k]) else a[k] == b[k]
        for k in a)


def orbax_pair(label, config, corpus, work_dir, bf16=False):
    """Phase 22 for one config: trained for 1 epoch with the mid-epoch
    rolling checkpoint kept as a directory and as a pickle, each restored
    into a new Runner and resumed to the end of epoch 2, each served; the
    two formats bit-equal at every point."""
    from ggnn_tpu_torch.serving import Predictor
    from ggnn_tpu_torch.training import checkpoint
    from ggnn_tpu_torch.training import runner as runner_mod
    from ggnn_tpu_torch.training.runner import Runner

    counts = bf16_launch_counts if bf16 else launch_counts
    train, valid = corpus
    os.makedirs(work_dir, exist_ok=True)
    paths = {"directory": os.path.join(work_dir, "mid"),
             "pickle": os.path.join(work_dir, "mid.pickle")}
    rec = {"save_ms": {}, "restore_ms": {}, "bytes": {}, "runs": {}}
    save = runner_mod.save_checkpoint

    def capture(path, *args, iterator_state=None, **kwargs):
        save(path, *args, iterator_state=iterator_state, **kwargs)
        if iterator_state is not None and (
                iterator_state["epoch"], iterator_state["steps_done"]) == (
                1, ORBAX_EVERY):
            for fmt, target in paths.items():
                t0 = time.perf_counter()
                save(target, *args, iterator_state=iterator_state, **kwargs)
                rec["save_ms"][fmt] = (time.perf_counter() - t0) * 1e3

    def counted(name, runner):
        history, launched, _ = counted_sparse_train(
            f"orbax {label} {name}", runner, counts)
        rec["runs"][name] = {
            "launches": list(launched),
            "epochs": [e["epoch"] for e in history],
            "losses": [[e["train_results"][0], e["valid_results"][0]]
                       for e in history]}
        return history

    first = Runner("sparse", {**config, "num_epochs": 1}, train_data=train,
                   valid_data=valid, log_dir=os.path.join(work_dir, "first"),
                   quiet=True, tensorboard=False,
                   checkpoint_every_steps=ORBAX_EVERY)
    runner_mod.save_checkpoint = capture
    try:
        counted("training", first)
    finally:
        runner_mod.save_checkpoint = save
    if set(rec["save_ms"]) != set(paths):
        raise RuntimeError(f"orbax {label}: no rolling checkpoint after "
                           f"step {ORBAX_EVERY} of epoch 1")
    rec["bytes"] = {"directory": dir_bytes(paths["directory"]),
                    "pickle": os.path.getsize(paths["pickle"])}
    states, resumed, answers = {}, {}, {}
    request = serving_requests()[300]
    for fmt, path in paths.items():
        runner = Runner("sparse", {**config, "num_epochs": 2},
                        train_data=train, valid_data=valid,
                        log_dir=os.path.join(work_dir, fmt), quiet=True,
                        tensorboard=False, restore=path)
        it = runner._resume_iter
        if (it["epoch"], it["steps_done"]) != (1, ORBAX_EVERY):
            raise RuntimeError(f"orbax {label} {fmt}: iterator state {it}")
        states[fmt] = runner_state(runner)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        checkpoint.restore_checkpoint(path, runner.config, runner.params,
                                      log=lambda *a: None,
                                      optimizer=runner.optimizer)
        torch.cuda.synchronize()
        rec["restore_ms"][fmt] = (time.perf_counter() - t0) * 1e3
        history = counted(f"resumed from the {fmt}", runner)
        if [e["epoch"] for e in history] != [1, 2]:
            raise RuntimeError(f"orbax {label} {fmt}: resumed epochs "
                               f"{[e['epoch'] for e in history]}")
        resumed[fmt] = runner_state(runner)
        predictor = Predictor.from_checkpoint(path, "sparse")
        answer, launched, _, new = counted_request(predictor, request,
                                                   counts)
        check_forwards(f"orbax {label} {fmt} serving", new,
                       served_launches("sparse", config))
        rec["runs"][f"serving from the {fmt}"] = {"launches": list(launched)}
        answers[fmt] = np.asarray(answer)
    checks = {
        "restored_bit_equal": same_state(states["directory"],
                                         states["pickle"]),
        "resumed_bit_equal": same_state(resumed["directory"],
                                        resumed["pickle"]),
        "losses_equal": (rec["runs"]["resumed from the directory"]["losses"]
                         == rec["runs"]["resumed from the pickle"]["losses"]),
        "answers_bit_equal": bool(np.array_equal(answers["directory"],
                                                 answers["pickle"])),
        "answers_finite": bool(np.isfinite(answers["directory"]).all())}
    rec["checks"] = checks
    log(f"orbax {label}: the epoch-1 step-{ORBAX_EVERY} checkpoint saved in "
        f"{rec['save_ms']['directory']:.2f} ms as a directory "
        f"({rec['bytes']['directory']} bytes) and "
        f"{rec['save_ms']['pickle']:.2f} ms as a pickle "
        f"({rec['bytes']['pickle']} bytes); restored in "
        f"{rec['restore_ms']['directory']:.2f} / "
        f"{rec['restore_ms']['pickle']:.2f} ms; {checks}; launches "
        f"{COUNTER_NAMES} {({k: v['launches'] for k, v in rec['runs'].items()})}")
    if not all(checks.values()):
        raise RuntimeError(f"orbax {label}: the directory and the pickle "
                           f"part: {checks}")
    return rec


def orbax_mesh_check(case, corpus, work_dir):
    """Phase 21's type-TP Runner saved by every rank: rank 0 alone wrote,
    the directory and the pickle hold the same whole leaves, and each
    restored into a single-device Runner has the ranks' digest."""
    from ggnn_tpu_torch.training import checkpoint
    from ggnn_tpu_torch.training.runner import Runner

    saved = case["saved"]
    wrote = [len(r["wrote"]) for r in saved]
    if wrote != [2] + [0] * (len(saved) - 1):
        raise RuntimeError(f"orbax type-TP: the ranks wrote {wrote} "
                           "checkpoints, rank 0 alone should write 2")
    path = saved[0]["wrote"][0]
    payloads = {"directory": checkpoint._load_payload(path),
                "pickle": checkpoint._load_payload(path + ".pickle")}
    pickled = payloads["pickle"]["weights"]
    same = all(
        np.array_equal(np.asarray(payloads["directory"]["weights"][
            checkpoint._sanitize(k)]), np.asarray(v)) for k, v in
        pickled.items())
    digests = {}
    train, valid = corpus
    for fmt, target in (("directory", path), ("pickle", path + ".pickle")):
        runner = Runner("sparse", dict(case["config"]), train_data=train,
                        valid_data=valid,
                        log_dir=os.path.join(work_dir, f"tp_{fmt}"),
                        quiet=True, tensorboard=False, restore=target)
        digests[fmt] = params_digest(runner)
    ranks_digest = case["digests"][-1]
    ok = same and all(d == ranks_digest for d in digests.values())
    log(f"orbax type-TP (1,2): rank 0 wrote the directory and the pickle "
        f"({saved[0]['save_ms_directory']:.2f} / "
        f"{saved[0]['save_ms_pickle']:.2f} ms); same leaves: {same}; "
        f"restored digests equal the ranks': "
        f"{all(d == ranks_digest for d in digests.values())}")
    if not ok:
        raise RuntimeError("orbax type-TP: the saved leaves are not the "
                           "ranks' whole weights")
    return {"wrote": wrote, "same_leaves": same,
            "digest_equal": True, "save_ms": {
                k: saved[0][f"save_ms_{k}"] for k in ("directory", "pickle")},
            "bytes": {"directory": dir_bytes(path),
                      "pickle": os.path.getsize(path + ".pickle")}}


def orbax_fixture_check():
    """The JAX-written fixture read by the port's own reader (its zstd
    frames hold compressed blocks: Huffman literals, FSE sequences)
    against its pickle twin, bit for bit, and both served on the card."""
    import pickle

    from ggnn_tpu_torch.serving import Predictor
    from ggnn_tpu_torch.training import checkpoint

    t0 = time.perf_counter()
    payload = checkpoint._load_payload(ORBAX_FIXTURE)
    read_ms = (time.perf_counter() - t0) * 1e3
    with open(ORBAX_FIXTURE + ".pickle", "rb") as f:
        twin = pickle.load(f)
    got = payload["weights"]
    mismatched = [k for k, v in twin["weights"].items()
                  if not (np.asarray(got[checkpoint._sanitize(k)]).dtype
                          == np.asarray(v).dtype and np.array_equal(
                              np.asarray(got[checkpoint._sanitize(k)]),
                              np.asarray(v)))]
    counters_equal = (payload["train_step"], payload["valid_step"]) == (
        twin["train_step"], twin["valid_step"])
    request = serving_requests()[300]
    answers, launches = {}, {}
    for fmt, path in (("directory", ORBAX_FIXTURE),
                      ("pickle", ORBAX_FIXTURE + ".pickle")):
        predictor = Predictor.from_checkpoint(path, "sparse")
        answer, launched, _, _ = counted_request(predictor, request)
        answers[fmt], launches[fmt] = np.asarray(answer), list(launched)
    served_equal = bool(np.array_equal(answers["directory"],
                                       answers["pickle"]))
    log(f"orbax fixture (JAX-written, {len(got)} arrays, "
        f"{dir_bytes(ORBAX_FIXTURE)} bytes): read in {read_ms:.2f} ms, "
        f"mismatched leaves {mismatched}, step counters equal "
        f"{counters_equal}; served bit-equal to its twin {served_equal}, "
        f"launches {launches['directory']}")
    if mismatched or not counters_equal or not served_equal:
        raise RuntimeError("the JAX-written Orbax fixture does not read as "
                           "its pickle twin")
    return {"arrays": len(got), "read_ms": read_ms,
            "launches": launches["directory"],
            "pickle_launches": launches["pickle"]}


def orbax_phase(corpus, mesh, work_dir):
    """Phase 22 (see the module docstring)."""
    import importlib.util

    start = time.perf_counter()
    present = {m: importlib.util.find_spec(m) is not None
               for m in ORBAX_LIBRARIES}
    log(f"orbax phase: importable here {present}")
    f32 = orbax_pair("sparse", train_config("sparse"), corpus,
                     os.path.join(work_dir, "sparse"))
    bf16 = orbax_pair("sparse_wide_bf16", bf16_config(), corpus,
                      os.path.join(work_dir, "sparse_wide_bf16"), bf16=True)
    tp_rec = orbax_mesh_check(mesh["cases"][MESH_ORBAX_CASE],
                              mesh["runner_corpus"], work_dir)
    fixture = orbax_fixture_check()
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ORBAX_LIBRARIES)
    if loaded:
        raise RuntimeError(f"the Orbax phase loaded {loaded}")
    seconds = time.perf_counter() - start
    log(f"orbax phase: {seconds:.1f} s; loaded none of {ORBAX_LIBRARIES}")
    return {"importable": present, "sparse": f32, "sparse_wide_bf16": bf16,
            "type_tp": tp_rec, "fixture": fixture, "seconds": seconds}

# ------------------------------------- replayed steps (ROADMAP A20)

# The seven variants' serving timing at the default envelope; phase 23's
# per-configuration Predictors at a smaller one (1- and 300-graph
# requests, artifacts exported on the CPU in seconds).
SERVED_VARIANTS = ("sparse", "rgcn", "dense", "blocked", "gcn",
                   "gcn_blocked", "async")
REPLAY_ENVELOPE = dict(max_nodes=512, max_graphs=64)
REPLAY_EVERY = 2           # the rolling checkpoint's steps
REPLAY_SERVER_SECONDS = 3.0
REPLAY_THREADS = 16


def recorded_train(runner):
    """(per step (split, loss, MAE), train graphs after each training
    epoch) of `runner.train()`: every step's loss and MAE as `run_epoch`
    reports them after the epoch's one copy."""
    seen, counts = [], []
    cache = runner.train_graphs
    runner.summaries.add_batch = (
        lambda split, step, loss, accs, tasks:
        seen.append((split, loss, np.asarray(accs).copy())))
    run_epoch = runner.run_epoch

    def counted(name, processed, is_training):
        out = run_epoch(name, processed, is_training)
        if is_training:
            counts.append(len(getattr(cache, "graphs", ())))
        return out

    runner.run_epoch = counted
    try:
        runner.train()
    finally:
        del runner.run_epoch
    return seen, counts


def same_params(a, b) -> bool:
    want = dict(b.params.named_parameters())
    return all(torch.equal(p, want[n]) for n, p in a.params.named_parameters())


def replay_pair(label, variant, config, corpus, log_dir):
    """(a) and (b) of phase 23 for one configuration: 2 epochs of
    `Runner.train()`, every train and validation step a replay, a rolling
    checkpoint every REPLAY_EVERY steps, against an eager twin (the same
    `train()` with `eager_steps`): every per-step loss and MAE of both
    splits and every parameter bit-equal; the train graphs after epoch 2
    those after epoch 1; the run resumed from the last rolling
    checkpoint bit-equal to the uninterrupted one."""
    from ggnn_tpu_torch.training.checkpoint import load_iterator_state
    from ggnn_tpu_torch.training.runner import Runner

    config = {**config, "num_epochs": 2}
    train, valid = corpus

    def runner(name, **kwargs):
        return Runner(variant, dict(config), train_data=train,
                      valid_data=valid, log_dir=os.path.join(log_dir, name),
                      quiet=True, tensorboard=False, **kwargs)

    t0 = time.perf_counter()
    graph = runner("replayed", checkpoint_every_steps=REPLAY_EVERY)
    eager = runner("eager", checkpoint_every_steps=REPLAY_EVERY)
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    seen, counts = recorded_train(graph)
    torch.cuda.synchronize()
    graph_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with eager_steps(eager):
        want, _ = recorded_train(eager)
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    parted = [i for i, (a, b) in enumerate(zip(seen, want))
              if a[:2] != b[:2] or not np.array_equal(a[2], b[2])]
    params_equal = same_params(graph, eager)
    it = load_iterator_state(graph.last_model_file)
    resumed = runner("resumed", restore=graph.last_model_file)
    resumed.train()
    resumed_equal = same_params(resumed, graph)
    graphs = graph.graph_counts()
    rec = {"steps": len(seen), "train_steps": graph.train_step_id,
           "graphs": graphs, "train_graphs_by_epoch": counts,
           "steps_parted": len(parted), "params_bit_equal": params_equal,
           "resumed_from": [int(it["epoch"]), int(it["steps_done"])],
           "resumed_bit_equal": resumed_equal, "seconds": graph_s,
           "eager_seconds": eager_s, "setup_seconds": setup_s}
    log(f"replay {label}: train() 2 epochs, {graph.train_step_id} train "
        f"steps and {len(seen) - graph.train_step_id} validation steps, "
        f"replayed in {graph_s:.2f} s (captures included), eager "
        f"{eager_s:.2f} s, two Runners set up in {setup_s:.2f} s; graphs "
        f"{graphs}, train graphs after each epoch "
        f"{counts}; per-step losses and MAEs parted at {len(parted)} of "
        f"{len(seen)} steps, parameters bit-equal {params_equal}; resumed "
        f"from epoch {it['epoch']}, step {it['steps_done']}: bit-equal "
        f"{resumed_equal}")
    if (len(seen) != len(want) or parted or not params_equal
            or len(counts) != 2 or counts[0] != counts[1] or not counts[0]
            or not resumed_equal):
        raise RuntimeError(f"replay {label}: the replayed train() is not "
                           "its eager twin's")
    return graph, rec


def eager_twin(predictor):
    """`predictor` with its forward run eagerly: `serve_forward` (or the
    artifact's program) on each batch moved to the card."""
    predictor._forward = lambda batch: predictor._serve(
        batch.to(predictor.device)).to("cpu", copy=True).numpy()
    return predictor


def threads_as_serial(predictor, requests):
    """`requests` answered by REPLAY_THREADS threads calling `predictor`
    at once, against the same requests called serially: bit-equal."""
    import threading

    serial = [predictor(r) for r in requests]
    got = [None] * len(requests)
    barrier = threading.Barrier(len(requests))

    def call(i):
        barrier.wait(timeout=60)
        got[i] = predictor(requests[i])

    threads = [threading.Thread(target=call, args=(i,))
               for i in range(len(requests))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    return all(g is not None and np.array_equal(g, w)
               for g, w in zip(got, serial))


def replay_serving(label, variant, runner, work_dir, artifact=None,
                   export=True):
    """(c) of phase 23 for one configuration: its trained weights saved,
    served by `Predictor.from_checkpoint` (REPLAY_ENVELOPE) replaying its
    forward, and by an eager twin: the 1- and 300-graph answers
    bit-equal; REPLAY_THREADS threads calling the replayed Predictor at
    once answered as serial calls; with `export`, the artifact exported
    on the CPU (or `artifact`, one exported before) replayed on the card
    against its programs run eagerly, bit-equal."""
    from ggnn_tpu_torch.data.synthetic import synthetic_molecules
    from ggnn_tpu_torch.export import export_predictor, load_predictor
    from ggnn_tpu_torch.serving import Predictor

    os.makedirs(work_dir, exist_ok=True)
    path = os.path.join(work_dir, "weights.pickle")
    runner._save(path)
    requests = serving_requests()
    small = [synthetic_molecules(n, seed=60 + n)
             for n in (1, 5, 9, 30)] * (REPLAY_THREADS // 4)
    replayed = Predictor.from_checkpoint(path, variant, **REPLAY_ENVELOPE)
    eager = eager_twin(Predictor.from_checkpoint(path, variant,
                                                 **REPLAY_ENVELOPE))
    equal = {n: bool(np.array_equal(replayed(requests[n]),
                                    eager(requests[n]))) for n in (1, 300)}
    threads = threads_as_serial(replayed, small)
    rec = {"bit_equal": equal, "threads_as_serial": threads,
           "graphs": replayed.graph_count()}
    if not export:
        log(f"replay {label} serving: 1- and 300-graph answers bit-equal "
            f"to serve_forward's {equal}, {REPLAY_THREADS} threads as "
            f"serial calls {threads}, {rec['graphs']} graphs")
        if not (all(equal.values()) and threads):
            raise RuntimeError(f"replay {label}: the replayed Predictor is "
                               "not its eager twin's")
        return rec
    export_s = None
    if artifact is None:
        artifact = os.path.join(work_dir, "served.ggnnx")
        t0 = time.perf_counter()
        export_predictor(Predictor.from_checkpoint(
            path, variant, device="cpu", **REPLAY_ENVELOPE), artifact)
        export_s = time.perf_counter() - t0
    card = load_predictor(artifact)
    replays = {n: card(requests[n]) for n in (1, 300)}
    card_graphs = card.graph_count()
    eager_twin(card)
    artifact_equal = {n: bool(np.array_equal(replays[n], card(requests[n])))
                      for n in (1, 300)}
    rec.update({"artifact_bit_equal": artifact_equal, "artifact": artifact,
                "artifact_graphs": card_graphs, "export_s": export_s})
    exported = ("phase 16's" if export_s is None
                else f"exported in {export_s:.2f} s")
    log(f"replay {label} serving: 1- and 300-graph answers bit-equal to "
        f"serve_forward's {equal}, {REPLAY_THREADS} threads as serial "
        f"calls {threads}, {rec['graphs']} graphs; artifact ({exported}) "
        f"bit-equal to its programs run eagerly {artifact_equal}, "
        f"{card_graphs} graphs")
    if not (all(equal.values()) and threads
            and all(artifact_equal.values())):
        raise RuntimeError(f"replay {label}: the replayed Predictor or "
                           "artifact is not its eager twin's")
    return rec


def timed_requests(predictor, requests, repeats):
    """(graphs/s of the 3,000-graph request, median of `repeats`; the
    1-graph latency in ms, median of 20 after 5), host clock,
    synchronised."""
    def seconds(request):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        predictor(request)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    big = [seconds(requests[3000]) for _ in range(repeats)]
    one = [seconds(requests[1]) for _ in range(25)][5:]
    return 3000 / statistics.median(big), statistics.median(one) * 1e3


def replay_serving_timing(ckpt_dir):
    """Each of the seven variants at its default config and envelope
    (random weights; async at 40 substeps): the 3,000-graph throughput
    (median of 3; async 1) and the 1-graph latency (median of 20) of an
    eager twin and of the replayed Predictor, one turn each (eager,
    replayed), each after a 1-graph warm-up request and the replayed one
    after a 3,000-graph one too, which captures its shapes."""
    from ggnn_tpu_torch.serving import Predictor

    requests = serving_requests()
    out = {}
    for variant in SERVED_VARIANTS:
        _, path = random_checkpoint(
            variant, ckpt_dir, ASYNC_SERVING if variant == "async" else None,
            tag="_replay")
        repeats = 1 if variant == "async" else 3
        rec = {}
        for kind in ("eager", "replayed"):
            predictor = Predictor.from_checkpoint(path, variant)
            # The replayed Predictor's warm-up captures its shapes.
            if kind == "eager":
                eager_twin(predictor)
                predictor(requests[1])
            else:
                for n in (1, 3000):
                    predictor(requests[n])
            rec[kind] = dict(zip(("graphs_per_s_3000", "latency_1_ms"),
                                 timed_requests(predictor, requests,
                                                repeats)))
            if kind == "replayed":
                rec["graphs"] = predictor.graph_count()
        out[variant] = rec
        log(f"replay serving timing {variant}: 3,000 graphs eager "
            f"{rec['eager']['graphs_per_s_3000']:.1f}, replayed "
            f"{rec['replayed']['graphs_per_s_3000']:.1f} graphs/s; 1-graph "
            f"latency eager {rec['eager']['latency_1_ms']:.3f}, replayed "
            f"{rec['replayed']['latency_1_ms']:.3f} ms; {rec['graphs']} "
            "graphs")
    return out


def replay_server_timing(ckpt_dir):
    """The default sparse model behind a `PredictionServer`, over an
    eager twin and over the replayed Predictor (one turn each): 16
    clients of one-graph requests for REPLAY_SERVER_SECONDS, requests/s,
    p50 and p99, every answer within TOL_SERVER of a card Predictor's."""
    from ggnn_tpu_torch.data.synthetic import synthetic_molecules
    from ggnn_tpu_torch.server import PredictionServer
    from ggnn_tpu_torch.serving import Predictor

    pool = synthetic_molecules(400, seed=52)
    _, path = random_checkpoint("sparse", ckpt_dir, tag="_replay_server")
    want = Predictor.from_checkpoint(path, "sparse")(pool)
    out = {}
    for kind in ("eager", "replayed"):
        predictor = Predictor.from_checkpoint(path, "sparse")
        if kind == "eager":
            eager_twin(predictor)
        server = PredictionServer(predictor, port=0)
        server.warmup()
        server.start()
        host, port = server.address
        try:
            load = load_clients(f"http://{host}:{port}", pool, want,
                                REPLAY_SERVER_SECONDS)
        finally:
            server.shutdown()
        if load["max_abs_err"] > TOL_SERVER:
            raise RuntimeError(f"replay server ({kind}): an answer is "
                               f"{load['max_abs_err']:.3e} off")
        out[kind] = load
    log(f"replay server timing, sparse, {SERVER_CLIENTS} clients: eager "
        f"{out['eager']['requests_per_s']:.1f} requests/s p99 "
        f"{out['eager']['p99_ms']:.3f} ms, replayed "
        f"{out['replayed']['requests_per_s']:.1f} requests/s p99 "
        f"{out['replayed']['p99_ms']:.3f} ms")
    return out


def replay_train_timing(runners):
    """`train()`'s training epoch (`run_epoch`, its packer thread
    included; the Runner's own graphs/s) of phase 6's, 11's, 12's and
    13's Runners, eagerly (`eager_steps`) and replayed, one turn each:
    graphs/s and ms a step, host clock, synchronised."""
    out = {}
    for label, runner in runners.items():
        rec = {}
        for kind in ("eager", "replayed"):
            context = (eager_steps(runner) if kind == "eager"
                       else contextlib.nullcontext())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with context:
                _, _, _, graphs_per_s, steps = runner.run_epoch(
                    f"{label} {kind}", runner.train_processed, True)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            rec[kind] = {"graphs_per_s": graphs_per_s, "steps": steps,
                         "ms_per_step": seconds * 1e3 / steps}
        rec["graphs"] = runner.graph_counts()
        out[label] = rec
        log(f"replay train timing {label} ({rec['eager']['steps']} steps): "
            f"eager {rec['eager']['graphs_per_s']:.1f} graphs/s "
            f"{rec['eager']['ms_per_step']:.3f} ms a step, replayed "
            f"{rec['replayed']['graphs_per_s']:.1f} graphs/s "
            f"{rec['replayed']['ms_per_step']:.3f} ms a step; graphs "
            f"{rec['graphs']}")
    return out


def graph_launch_floor(dev):
    """The launch floor inside a CUDA graph: graphs of 1 and of 100
    `ell_spmm.empty_launch` kernels captured on a side stream, each
    replay timed by `time_ms` (device and host ms), beside one empty
    kernel launched outside a graph."""
    from ggnn_tpu_torch.ops.kernels import ell_spmm

    ell_spmm.empty_launch(dev)
    stream = torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    graphs = {}
    for kernels in (1, 100):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            for _ in range(kernels):
                ell_spmm.empty_launch(dev)
        graphs[kernels] = graph
    torch.cuda.current_stream(dev).wait_stream(stream)
    rec = {"outside_us": time_ms(lambda: ell_spmm.empty_launch(dev))[0]
           * 1e3}
    for kernels, graph in graphs.items():
        ms, host_ms = time_ms(graph.replay)
        rec[f"graph_{kernels}_us"] = ms * 1e3
        rec[f"graph_{kernels}_host_us"] = host_ms * 1e3
    rec["in_graph_us_a_kernel"] = rec["graph_100_us"] / 100
    log(f"launch floor: an empty kernel {rec['outside_us']:.3f} us outside "
        f"a graph; a graph of 1 replayed in {rec['graph_1_us']:.3f} us "
        f"(host {rec['graph_1_host_us']:.3f}), of 100 in "
        f"{rec['graph_100_us']:.3f} us (host {rec['graph_100_host_us']:.3f}"
        f"): {rec['in_graph_us_a_kernel']:.3f} us a kernel inside a graph")
    return rec


def replay_phase(dev, step_corpus, runners, work_dir, async_artifact):
    """Phase 23 (see the module docstring). `async`'s artifact check
    replays phase 16's `async` artifact (`async_artifact`): an export of
    its 160 substeps takes a minute on the host."""
    start = time.perf_counter()
    card = gpu_name_and_power()
    checks, serving, seconds = {}, {}, {}
    for label, variant, config in graph_configs(keep={}):
        t0 = time.perf_counter()
        if variant == "dense":
            # The step corpus' 50 validation molecules fill no 256-graph
            # bucket: `dense` would drop them all.
            config = {**config, "drop_remainder": False}
        directory = os.path.join(work_dir, label.replace(" ", "_"))
        graph, checks[label] = replay_pair(label, variant, config,
                                           step_corpus, directory)
        t1 = time.perf_counter()
        # The artifacts of the variants and of attention; a route's
        # program is its forward's trace, which the live Predictor's
        # check already holds to eager.
        serving[label] = replay_serving(
            label, variant, graph, os.path.join(directory, "serving"),
            async_artifact if variant == "async" else None,
            export="(" not in label)
        seconds[label] = (t1 - t0, time.perf_counter() - t1)
    log(f"replay phase: seconds a configuration (train(), serving) "
        f"{({k: [round(x, 1) for x in v] for k, v in seconds.items()})}")
    checks_s = time.perf_counter() - start
    timing = {"train": replay_train_timing(runners),
              "serving": replay_serving_timing(work_dir),
              "server": replay_server_timing(work_dir),
              "launch_floor": graph_launch_floor(dev)}
    log(f"replay phase: {time.perf_counter() - start:.1f} s (checks "
        f"{checks_s:.1f}); {card}")
    return {"checks": checks, "serving": serving, "timing": timing,
            "card": card, "config_seconds": seconds,
            "seconds": time.perf_counter() - start}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    from ggnn_tpu_torch.data.synthetic import synthetic_molecules
    from ggnn_tpu_torch.ops.kernels import _build, ell_spmm
    from ggnn_tpu_torch.ops.messages import EdgeLanes

    script_start = time.perf_counter()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    log("tf32: matmul.allow_tf32=False cudnn.allow_tf32=False")

    sources = ("ell_spmm", "gather_floor", "edge_dot")
    start = time.perf_counter()
    # The host packer's g++ build runs beside the kernels' nvcc builds.
    with ThreadPoolExecutor(max_workers=2) as pool:
        native_future = pool.submit(native_build)
        zstd_future = pool.submit(zstd_build)
        _build.build_all(sources)
        native = native_future.result()
        zstd = zstd_future.result()
    log(f"build {', '.join(n + '.cu' for n in sources)} (one nvcc each, "
        f"in parallel), the native packer and the zstd decoder (g++ each): "
        f"{time.perf_counter() - start:.2f} s (the decoder "
        f"{zstd['seconds']:.2f} s, {zstd['path']})")
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
    if registers != B1_REGISTERS:
        raise RuntimeError(f"B1 and B2 compiled to {registers} registers, "
                           f"not {B1_REGISTERS}")
    one = torch.zeros(1, device=dev)
    launch_floor = {
        "zero_one_element_ms": time_ms(lambda: one.zero_())[0],
        "empty_kernel_ms": time_ms(lambda: ell_spmm.empty_launch(dev))[0]}
    log(f"launch floor: a one-element zero_ "
        f"{launch_floor['zero_one_element_ms'] * 1e3:.3f} us, an empty "
        "kernel through the kernels' ctypes path "
        f"{launch_floor['empty_kernel_ms'] * 1e3:.3f} us")
    probe = probe_phase(dev, batches)
    log(f"B1 at the 20k-node budget: {records[1]['ms'] * 1e3:.3f} us, "
        f"{records[1]['ms'] / probe['b1_output_zero_ms']:.3f} x the zero_ "
        "of its output")
    _, lane20k, t20k = batches[1]
    lane20k = lane20k.to(dev)
    n20k = lane20k.node_capacity
    off20k = EdgeLanes.combined(lane20k.edge_sources_all,
                                lane20k.edge_types_all,
                                lane20k.edge_targets_all, t20k, n20k).offsets
    h20k = torch.randn(n20k, HIDDEN, generator=gen, device=dev)
    weighted = weighted_kernel_phase(
        dev, gen, skewed, lambda: ell_spmm.gather_segment_sum(
            h20k, lane20k.edge_sources_all, off20k, n20k * t20k))
    async_kernels = async_kernel_phase(dev, gen, *async_batches())
    attention_kernels = attention_kernel_phase(dev, gen, batches)
    work_dir = os.path.join(REPO, "build", "chip_smoke")
    serving = serving_phase(work_dir)
    dense_serving = dense_serving_phase(work_dir)
    gcn_serving = gcn_serving_phase(work_dir)
    async_serving = async_serving_phase(work_dir)
    attention_serving = attention_serving_phase(work_dir)
    tf1 = tf1_phase(os.path.join(work_dir, "tf1"))
    server = server_phase(work_dir)
    exported = export_phase(os.path.join(work_dir, "export"))
    corpus = (synthetic_molecules(6000, seed=40),
              synthetic_molecules(600, seed=41))
    runner, training = training_phase(corpus,
                                      os.path.join(work_dir, "train"))
    dense_runners, dense_training = dense_training_phase(
        corpus, os.path.join(work_dir, "train_dense"))
    gcn_runners, gcn_training = gcn_training_phase(
        corpus, os.path.join(work_dir, "train_gcn"))
    async_runner, async_training = async_training_phase(
        corpus, os.path.join(work_dir, "train_async"))
    attention_runner, attention_training = attention_training_phase(
        corpus, os.path.join(work_dir, "train_attention"))
    step_corpus = (synthetic_molecules(1300, seed=42),
                   synthetic_molecules(50, seed=43))
    step_dir = os.path.join(work_dir, "step")
    card_vs_cpu = card_vs_cpu_phase("sparse", step_corpus, is_20k_batch,
                                    step_dir)
    dense_card_vs_cpu = {
        variant: card_vs_cpu_phase(variant, step_corpus, is_full_v32_batch,
                                   step_dir)
        for variant in DENSE_VARIANTS}
    gcn_card_vs_cpu = {
        variant: card_vs_cpu_phase(
            variant, step_corpus,
            is_20k_batch if variant == "gcn" else is_full_v32_batch,
            step_dir)
        for variant in GCN_VARIANTS}
    async_card_vs_cpu = card_vs_cpu_phase("async", step_corpus,
                                          is_async_10k_batch, step_dir)
    steps = sum(attention_runner.config["layer_timesteps"])
    attention_card_vs_cpu = card_vs_cpu_phase(
        "sparse", step_corpus, is_20k_batch, step_dir,
        config=attention_config({"num_epochs": 1}),
        want=route_launches("combined", True, steps, True),
        label="sparse_attention", repeat_forward=True)
    if not any(n.endswith(".attention")
               for n in attention_card_vs_cpu["parameters"]):
        raise RuntimeError("the attention factors got no gradient")
    routes = routes_phase(step_corpus, work_dir, step_dir)
    profile = profile_phase(runner, first_batch(runner, is_20k_batch))
    dense_forward = dense_forward_phase(dense_runners)
    dense_profile = {
        variant: profile_phase(runner, first_batch(runner,
                                                   is_full_v32_batch))
        for variant, runner in dense_runners.items()}
    gcn_profile = {
        variant: profile_phase(runner, first_batch(
            runner, is_20k_batch if variant == "gcn" else is_full_v32_batch))
        for variant, runner in gcn_runners.items()}
    async_profile = profile_phase(async_runner, first_batch(
        async_runner, is_async_10k_batch))
    attention_profile = profile_phase(attention_runner, first_batch(
        attention_runner, is_20k_batch), label="sparse_attention")

    # compute_dtype bfloat16 (A16): the kernels' bf16 instances, then the
    # bf16 config's main paths, each counted from 0 just before it.
    bf16_start = time.perf_counter()
    bf16_seconds = {}

    def bf16_timed(label, phase, *args):
        t0 = time.perf_counter()
        result = phase(*args)
        bf16_seconds[label] = time.perf_counter() - t0
        return result

    bf16_kernels = bf16_timed("kernels", bf16_kernel_phase, dev, gen,
                              batches, skewed)
    bf16_serving = bf16_timed("serving", bf16_serving_phase, work_dir)
    _, bf16_training = bf16_timed("training", bf16_training_phase, corpus,
                                  os.path.join(work_dir, "train_bf16"))
    bf16_routes = bf16_timed("routes", bf16_routes_phase, step_corpus,
                             work_dir, step_dir)
    bf16_dense = bf16_timed("dense", bf16_dense_phase, step_corpus,
                            work_dir, step_dir, dense_forward)
    bf16_export = bf16_timed("export", bf16_export_phase,
                             os.path.join(work_dir, "export"))
    log(f"bf16 phases: {time.perf_counter() - bf16_start:.1f} s "
        f"({', '.join(f'{k} {v:.1f} s' for k, v in bf16_seconds.items())})")
    extras = extras_phase(corpus, os.path.join(work_dir, "extras"))
    epoch_seconds = {"sparse": training["train_epoch_seconds_median"],
                     **{v: rec["train_epoch_seconds_median"]
                        for v, rec in {**dense_training,
                                       **gcn_training}.items()}}
    native = native_phase(native, corpus, epoch_seconds, async_runner,
                          os.path.join(work_dir, "native"))
    on_device = train_on_device_phase(
        step_corpus, corpus,
        {"sparse": runner, "gcn": gcn_runners["gcn"],
         "sparse_attention": attention_runner, "async": async_runner},
        {"sparse": profile, "dense": dense_profile["dense"],
         "gcn": gcn_profile["gcn"], "sparse_attention": attention_profile,
         "async": async_profile},
        os.path.join(work_dir, "on_device"))
    mesh = mesh_phase(corpus, step_corpus, os.path.join(work_dir, "mesh"))
    orbax = orbax_phase(corpus, mesh, os.path.join(work_dir, "orbax"))
    replayed = replay_phase(
        dev, step_corpus,
        {"sparse": runner, "dense": dense_runners["dense"],
         "gcn": gcn_runners["gcn"], "sparse_attention": attention_runner,
         "async": async_runner}, os.path.join(work_dir, "replay"),
        os.path.join(work_dir, "export", "async.ggnnx"))

    # Each kernel's `launches` sums the main paths' runs, each counted
    # from 0 just before it: every variant's serving requests and
    # training, the attention config's, and each route's served request
    # and train step (the probe's runs of B3 besides).
    runs = {"sparse serving": serving["launches"],
            "sparse training": [training[f"launches_{k}"] for k in COUNTERS],
            "sparse_attention serving": attention_serving["launches"],
            "sparse_attention training": [
                attention_training[f"launches_{k}"] for k in COUNTERS],
            "async serving": async_serving["launches"],
            "async training": [async_training[f"launches_{k}"]
                               for k in COUNTERS]}
    for variant in DENSE_VARIANTS + GCN_VARIANTS:
        served = (dense_serving if variant in DENSE_VARIANTS
                  else gcn_serving)[variant]
        trained = (dense_training if variant in DENSE_VARIANTS
                   else gcn_training)[variant]
        runs[f"{variant} serving"] = served["launches"]
        runs[f"{variant} training"] = [trained[f"launches_{k}"]
                                       for k in COUNTERS]
    for label, rec in routes.items():
        runs[f"sparse ({label}) serving"] = rec["serving"]["launches"]
        runs[f"sparse ({label}) train step"] = rec["train_step"]["launches"]
    for case, rec in tf1.items():
        runs[f"TF1 {case} serving"] = rec["launches"]
    for label in ("sparse", "sparse_attention"):
        runs[f"{label} server"] = [
            sum(c) for c in zip(server[label]["warmup_launches"],
                                server[label]["sequential_launches"],
                                server[label]["launches"])]
    for label in EXPORTED:
        runs[f"{label} artifact serving"] = [
            sum(c) for c in zip(*(r["launches"] for r in
                                  exported[label]["requests"].values()))]
    for label, rec in extras["resume"]["runs"].items():
        runs[f"extras {label} training"] = rec["launches"]
    runs["extras cli --profile"] = extras["profile"]["launches"]
    runs["extras Runner.predict"] = extras["evaluate"]["launches"]
    runs["extras cli --evaluate"] = extras["evaluate"]["cli_launches"]
    runs["extras QM9 cli"] = extras["ingestion"]["launches"]
    # The mesh Runners' launches, summed over their ranks.
    for label, rec in mesh["cases"].items():
        runs[f"mesh {label} training"] = [
            sum(c) for c in zip(*rec["runner_launches"])]
    runs["mesh nccl 1x1 training"] = mesh["nccl"]["launches"]["mesh"]
    for name, rec in orbax["sparse"]["runs"].items():
        runs[f"orbax sparse {name}"] = rec["launches"]
    runs["orbax JAX fixture serving"] = [
        a + b for a, b in zip(orbax["fixture"]["launches"],
                              orbax["fixture"]["pickle_launches"])]

    def by_path(*indices):
        return {path: sum(counts[i] for i in indices)
                for path, counts in runs.items()}

    def shape_numbers(rec):
        return {k: rec[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms")}

    def short(rec):
        return {"shape": rec["shape"], **shape_numbers(rec),
                "max_abs_err": rec["max_abs_err"]}

    b1_paths, b2_paths = by_path(0), by_path(1)
    b3_paths = {"probe": probe["launches"], **by_path(2)}
    w_paths, dot_paths = by_path(3, 4), by_path(5)
    w_shape = weighted["shapes"][1]   # the 20k-node GCN batch, forward
    b2_shape = b2_records[1]          # the training path's 20k-node shape
    # The JAX probe's shape at unroll 8.
    b3_shape = [r for r in probe["shapes"]["probe shape"]
                if r["unroll"] == 8][0]
    dot_shape = attention_kernels["edge_dot"][1]   # scores at 20k
    kernels = [{
        "name": "gather_segment_sum",
        "route": "cuda",
        "source": "ggnn_tpu_torch/csrc/ell_spmm.cu",
        "replaces": "ggnn_tpu/ops/pallas/ell_spmm.py:51",
        "launches": sum(b1_paths.values()),
        "launches_by_path": b1_paths,
        "max_abs_err": max([r["max_abs_err"] for r in records] + [ell_err]
                           + [async_kernels[k]["max_abs_err"]
                              for k in ("b1", "b1_serving")]
                           + [r["max_abs_err"]
                              for r in attention_kernels["per_type_b1"]]),
        "async_shapes": [short(async_kernels[k])
                         for k in ("b1", "b1_serving")],
        "per_type_shapes": [short(r)
                            for r in attention_kernels["per_type_b1"]],
        **shape_numbers(records[0]),
        "registers": registers,
    }, {
        "name": "segment_scatter_sum",
        "route": "cuda",
        "source": "ggnn_tpu_torch/csrc/ell_spmm.cu",
        "replaces": "ggnn_tpu/ops/pallas/ell_spmm.py:101",
        "launches": sum(b2_paths.values()),
        "launches_by_path": b2_paths,
        "max_abs_err": max([r["max_abs_err"] for r in b2_records]
                           + [b2_ell_err, async_kernels["b2"]["max_abs_err"]]),
        "async_shapes": [short(async_kernels["b2"])],
        **shape_numbers(b2_shape),
        "registers": registers,
    }, {
        "name": "gather_rows",
        "route": "cuda",
        "source": "ggnn_tpu_torch/csrc/gather_floor.cu",
        "replaces": "benchmarks/probes/gather_floor.py:52",
        "launches": sum(b3_paths.values()),
        "launches_by_path": b3_paths,
        "max_abs_err": max([r["max_abs_err"]
                            for recs in probe["shapes"].values()
                            for r in recs]
                           + [r["max_abs_err"]
                              for r in attention_kernels["gather_rows"]]),
        "per_edge_shapes": [short(r)
                            for r in attention_kernels["gather_rows"]],
        **shape_numbers(b3_shape),
    }, {
        "name": "weighted_gather_segment_sum",
        "route": "cuda",
        "source": "ggnn_tpu_torch/csrc/ell_spmm.cu",
        "replaces": "XLA segment_sum at ggnn_tpu/models/gcn.py:74 and "
                    "ggnn_tpu/ops/messages.py:121-131, :178-183, no Pallas "
                    "kernel",
        "launches": sum(w_paths.values()),
        "launches_forward": sum(by_path(3).values()),
        "launches_transpose": sum(by_path(4).values()),
        "launches_by_path": w_paths,
        "max_abs_err": max(r["max_abs_err"] for r in
                           weighted["shapes"] + weighted["transpose_shapes"]
                           + attention_kernels["weighted"]
                           + attention_kernels["weighted_transposes"]),
        "attention_shapes": [short(r) for r in attention_kernels["weighted"]],
        "attention_transpose_shapes": [
            short(r) for r in attention_kernels["weighted_transposes"]],
        **shape_numbers(w_shape),
        "registers": weighted["registers"],
    }, {
        "name": "edge_dot",
        "route": "cuda",
        "source": "ggnn_tpu_torch/csrc/edge_dot.cu",
        "replaces": "XLA gathers and sum at ggnn_tpu/ops/messages.py:56-70 "
                    "(scores) and the attention weights' gradient, no "
                    "Pallas kernel",
        "launches": sum(dot_paths.values()),
        "launches_by_path": dot_paths,
        "max_abs_err": max(r["max_abs_err"] for r in
                           attention_kernels["edge_dot"]
                           + attention_kernels["edge_dot_gradient"]),
        "gradient_shapes": [short(r)
                            for r in attention_kernels["edge_dot_gradient"]],
        **shape_numbers(dot_shape),
        "registers": attention_kernels["edge_dot_registers"],
    }]
    # The bf16 instances' launches on the bf16 main paths (their own
    # counters: the per-edge route's B1 and its transpose stay f32).
    bf16_runs = {
        "sparse_wide_bf16 serving": bf16_serving["bf16"]["launches"],
        "sparse_wide_bf16 training": [bf16_training[f"launches_{k}"]
                                      for k in COUNTERS],
        "sparse_wide_bf16 artifact serving": [
            sum(c) for c in zip(*(r["launches"] for r in
                                  bf16_export["requests"].values()))]}
    for name, rec in orbax["sparse_wide_bf16"]["runs"].items():
        bf16_runs[f"orbax sparse_wide_bf16 {name}"] = rec["launches"]
    for label, rec in bf16_routes.items():
        if "serving" in rec:
            bf16_runs[f"sparse_wide_bf16 ({label}) serving"] = \
                rec["serving"]["launches"]
        bf16_runs[f"sparse_wide_bf16 ({label}) train step"] = \
            rec["train_step"]["launches"]

    def bf16_by_path(*indices):
        return {path: sum(counts[i] for i in indices)
                for path, counts in bf16_runs.items()}

    def bf16_entry(name, f32_entry, records, shape, paths):
        return {
            "name": f"{name}[bf16]", "route": "cuda",
            "source": f32_entry["source"], "replaces": f32_entry["replaces"],
            "launches": sum(paths.values()), "launches_by_path": paths,
            "max_abs_err": max(r["max_abs_err"] for r in records),
            "max_ulp_err": max(r.get("max_ulp_err", 0.0) for r in records),
            "library_refused": shape["library_refused"],
            "shapes": [short(r) for r in records], **shape_numbers(shape)}

    f32_by_name = {k["name"]: k for k in kernels}
    kernels += [
        bf16_entry("gather_segment_sum", f32_by_name["gather_segment_sum"],
                   bf16_kernels["b1"], bf16_kernels["b1"][1],
                   bf16_by_path(0)),
        bf16_entry("segment_scatter_sum",
                   f32_by_name["segment_scatter_sum"], bf16_kernels["b2"],
                   bf16_kernels["b2"][1], bf16_by_path(1)),
        bf16_entry("gather_rows", f32_by_name["gather_rows"],
                   bf16_kernels["gather_rows"],
                   bf16_kernels["gather_rows"][0], bf16_by_path(2)),
        bf16_entry("weighted_gather_segment_sum",
                   f32_by_name["weighted_gather_segment_sum"],
                   bf16_kernels["weighted"], bf16_kernels["weighted"][0],
                   bf16_by_path(3, 4)),
        bf16_entry("edge_dot", f32_by_name["edge_dot"],
                   bf16_kernels["edge_dot"], bf16_kernels["edge_dot"][0],
                   bf16_by_path(5)),
    ]
    for k in kernels[-5:]:
        k["registers"] = bf16_kernels["registers"]
    for k in kernels:
        if k["launches"] == 0:
            raise RuntimeError(f"{k['name']} launched no time on the main "
                               "paths")
    device_line = gpu_name_and_power()
    log(f"chip_smoke: {time.perf_counter() - script_start:.1f} s from the "
        "build to the end")
    log(json.dumps({"shapes": records, "backward_shapes": b2_records,
                    "split_edges": ell_spmm.split_edges(),
                    "registers": registers, "launch_floor": launch_floor,
                    "probe": probe, "serving": serving,
                    "dense_serving": dense_serving, "training": training,
                    "dense_training": dense_training,
                    "card_vs_cpu": card_vs_cpu,
                    "dense_card_vs_cpu": dense_card_vs_cpu,
                    "dense_forward": dense_forward,
                    "profile": profile, "dense_profile": dense_profile,
                    "weighted": weighted, "gcn_serving": gcn_serving,
                    "gcn_training": gcn_training,
                    "gcn_card_vs_cpu": gcn_card_vs_cpu,
                    "gcn_profile": gcn_profile,
                    "async_kernels": async_kernels,
                    "async_serving": async_serving,
                    "async_training": async_training,
                    "async_card_vs_cpu": async_card_vs_cpu,
                    "async_profile": async_profile,
                    "attention_kernels": attention_kernels,
                    "attention_serving": attention_serving,
                    "attention_training": attention_training,
                    "attention_card_vs_cpu": attention_card_vs_cpu,
                    "attention_profile": attention_profile,
                    "routes": routes, "tf1": tf1, "server": server,
                    "export": exported, "launches_by_run": runs,
                    "bf16_kernels": bf16_kernels,
                    "bf16_serving": bf16_serving,
                    "bf16_training": bf16_training,
                    "bf16_routes": bf16_routes, "bf16_dense": bf16_dense,
                    "bf16_export": bf16_export,
                    "bf16_launches_by_run": bf16_runs,
                    "bf16_phase_seconds": bf16_seconds,
                    "extras": extras, "native": native,
                    "train_on_device": on_device,
                    "mesh": {k: v for k, v in mesh.items()
                             if k != "runner_corpus"},
                    "orbax": orbax, "replay": replayed,
                    "zstd_build": zstd}))
    log(device_line)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
