#!/usr/bin/env python3
"""The port's mesh over nccl, one rank a card, on a machine with four
NVIDIA GPUs: the multi-card counterpart of `chip_smoke.py` phase 21, whose
gloo ranks share one card.

    python3 tools/torch_mesh_nccl.py

Four nccl ranks (`parallel/launch.py:RankPool`, rank r on cuda:r) run
each case of CASES with phase 21's functions and checks, every keep
probability 1.0: `sparse` at configs/sparse_tpu.json's 20,000-node budget
node-sharded at (2,2) under the alltoall, shift and ragged exchanges and
at (1,4) under ragged, data-parallel at (4,1) and type-TP at (2,2);
configs/sparse_attention.json node-sharded at (1,4) (shift); `gcn`
node-sharded at (2,2) (ragged); `async` at (4,1). Each case: one train
step of `make_parallel_steps` over the step corpus' first batches
against the single-device step on cuda:0 (loss rtol 1e-5, every gradient
leaf rtol 2e-4 / atol 1e-6) with the launches each rank's batches
predict; 2 epochs of `synthetic_molecules(6000, seed=40)` through
`Runner(mesh=)`: the weights bit-equal across ranks after each epoch, the
validation loss below the initial weights', each rank's launches equal
to the prediction. Nothing is staged through the host: nccl moves every
CUDA tensor, point-to-point sends included.

It prints a line a case and, last, one JSON object with each case's
kind, exchange, devices, losses and launches and the cards' name and
power limit (nvidia-smi). It fails without four cards, and on any check.
It measures agreement across cards, not speed: it reports no step time.
"""

import itertools
import json
import os
import sys
import time
from types import SimpleNamespace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

WORLD = 4
CASES = [(f"sparse 2x2 {x}", "sparse", {"boundary_exchange": x}, 2, 2)
         for x in ("alltoall", "shift", "ragged")] + [
    ("sparse 1x4 ragged", "sparse", {"boundary_exchange": "ragged"}, 1, 4),
    ("sparse 4x1", "sparse", {}, 4, 1),
    ("sparse 2x2 type_tp", "sparse", {"edge_parallelism": "type_tp"}, 2, 2),
    ("sparse_attention 1x4", cs.MESH_ATTENTION,
     {"boundary_exchange": "shift"}, 1, 4),
    ("gcn 2x2", "gcn", {"boundary_exchange": "ragged"}, 2, 2),
    ("async 4x1", "async", {}, 4, 1)]


def nccl_mesh(n_data, n_edge):
    """This rank's mesh: nccl, on card `rank`."""
    from ggnn_tpu_torch.parallel.mesh import make_mesh
    cs._tf32_off()
    mesh = make_mesh(n_data, n_edge)
    if mesh.backend != "nccl" or mesh.device != torch.device("cuda",
                                                             mesh.rank):
        raise RuntimeError(f"rank {mesh.rank} runs {mesh.backend} on "
                           f"{mesh.device}")
    return mesh


def step_rank(*args):
    cs.rank_mesh = nccl_mesh
    return cs.mesh_step_rank(*args)


def runner_rank(*args):
    cs.rank_mesh = nccl_mesh
    return cs.mesh_runner_rank(*args)


def main() -> int:
    if not torch.cuda.is_available() or torch.cuda.device_count() < WORLD:
        print(f"torch_mesh_nccl: needs {WORLD} CUDA devices",
              file=sys.stderr)
        return 1
    # The ranks import the rank functions by this module's name.
    import torch_mesh_nccl as me
    from ggnn_tpu_torch.data.loader import infer_metadata
    from ggnn_tpu_torch.data.synthetic import synthetic_molecules
    from ggnn_tpu_torch.models.base import ModelParams, init_output_heads
    from ggnn_tpu_torch.ops.kernels import _build
    from ggnn_tpu_torch.parallel.launch import RankPool
    from ggnn_tpu_torch.training.runner import mesh_kind
    from ggnn_tpu_torch.training.variants import make_adapter
    start = time.perf_counter()
    cs._tf32_off()
    _build.build_all(("ell_spmm", "gather_floor", "edge_dot"))
    cs.native_build()
    corpus = (synthetic_molecules(6000, seed=40),
              synthetic_molecules(600, seed=41))
    train, valid = (synthetic_molecules(1300, seed=42),
                    synthetic_molecules(50, seed=43))
    single = torch.device("cuda:0")
    work_dir = os.path.join(REPO, "build", "mesh_nccl")
    cases = {}
    with RankPool(WORLD, "nccl", timeout=600, python_path=[
            REPO, os.path.dirname(os.path.abspath(__file__))]) as pool:
        for label, variant, over, n_data, n_edge in CASES:
            t0 = time.perf_counter()
            config = cs.mesh_config(variant, over)
            meta = infer_metadata([train, valid], config["tie_fwd_bkwd"])
            adapter = make_adapter(cs.model_variant(variant), config, meta)
            processed = adapter.preprocess(train, False)
            adapter.plan(processed)
            batches = list(itertools.islice(
                adapter.batches(processed, False), WORLD))
            gen = torch.Generator().manual_seed(0)
            weights = {n: p.detach().numpy() for n, p in ModelParams(
                adapter.build_model(gen), init_output_heads(
                    gen, config["hidden_size"],
                    config["task_ids"])).named_parameters()}
            kind = mesh_kind(cs.model_variant(variant), config,
                             SimpleNamespace(shape={"data": n_data,
                                                    "edge": n_edge}),
                             meta.num_edge_types)
            oracle = cs.single_step(variant, config, meta, weights,
                                    batches, single)
            steps = pool.run(me.step_rank, variant, config, meta, weights,
                             batches, n_data, n_edge, kind,
                             config.get("boundary_exchange", "alltoall"))
            worst = cs.check_mesh_step(label, steps, oracle)
            runs = pool.run(me.runner_rank, variant, config, corpus, n_data,
                            n_edge,
                            os.path.join(work_dir, label.replace(" ", "_")))
            devices = [f"cuda:{r}" for r in range(WORLD)]
            cs.check_mesh_runner(label, runs, devices)
            first = runs[0]
            cases[label] = {
                "kind": kind, "exchange": first["exchange"],
                "devices": devices, "step_loss": steps[0]["loss"],
                "single_loss": oracle[0], "step_max_rel_grad_err": worst,
                "launches": [r["launches"] for r in runs],
                "valid_losses": [first["initial_valid_loss"]]
                + first["valid_losses"],
                "weights_equal_across_ranks": True,
                "seconds": time.perf_counter() - t0}
            print(f"{label}: {json.dumps(cases[label])}", flush=True)
    print(cs.gpu_name_and_power())
    print(json.dumps({"cases": cases, "world": WORLD, "backend": "nccl",
                      "seconds": time.perf_counter() - start}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
