#!/usr/bin/env python3
"""The weighted segment-sum and `edge_dot` of a parent tree of the port and
of one or more changes, on one GPU, in one call: times, bits, and the
train steps' device-busy time.

    python3 tools/torch_kernel_compare.py --parent DIR [--change DIR ...]
        [--only REGEX] [--no-steps] [--repeats 3]

`--parent` names the other checkout (an earlier commit unpacked with `git
archive` into a directory that .gitignore lists, such as `build/parent`);
the change is this checkout, or each tree that a `--change` names (a copy
of a tree with one design choice of a kernel changed, say). The script
runs one process a tree in the order parent, each change, the changes
again in reverse, parent, each importing its tree's `ggnn_tpu_torch` and
building its tree's kernels, on the same inputs (made from fixed seeds).
Each process times, with `utils/timing.py:time_ms` (CUDA events around
each call, median of 50), `--repeats` times, of the cases below those
whose name `kernel [shape]` matches `--only` (every case without it):

  * the weighted instance (`weighted_gather_segment_sum`, over a transpose
    `weighted_segment_scatter_sum`), f32 at H 100: the GCN serving
    envelope and the 20,000-node GCN batch, each forward and over its
    transpose; the skewed 160,000-edge lane and a 5,000-edge hub, each
    forward and over its transpose (rows and weights of eighths); the
    attention weights over target*T + type at the envelope and at the
    20k-node budget; and the three weighted transposes of an attention
    train step at 20k: `EdgeDot` backward by a (the pairs by source,
    reading the targets' rows), by b (by target, reading the sources'
    rows) and the aggregation's by source (reading the [N*T, H]
    gradient). bf16 at H 512: the attention weights at 20k and the
    aggregation's transpose;
  * `edge_dot`, f32 at H 100: the scores and the weights' gradient at the
    envelope and at 20k; bf16 at H 512 both at 20k;
  * B1 and B2 (f32, H 100) at the envelope, 20k, the hub and the skewed
    lane, which share the weighted instance's source;
  * the launch floor: a one-element `zero_`;

and, unless `--no-steps`, profiles (`torch.profiler`, 5 steps after 3)
one train step of configs/sparse_attention.json and one of `gcn` on the
first 20,000-node batch of synthetic_molecules(2400, seed=22):
device-busy ms a step.

It then compares each change with the parent: for each shape the times of each tree (all
repeats of both of its runs), their medians and spreads, and whether the
change is faster by more than the larger spread; for the weighted
instance the max abs difference of the change's output against the
parent's on every shape, f32 and bf16, which must be 0 (the script
fails otherwise); for `edge_dot` the same difference, for the record.
The last line of standard output is one JSON object with every number
of each change and the card's name and power limit. Without CUDA the script fails.
"""

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HIDDEN = 100
BF16_HIDDEN = 512


def _args():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--parent", help="the other checkout (the parent tree)")
    p.add_argument("--change", action="append",
                   help="a tree to compare with the parent (repeatable; "
                   "default: this checkout)")
    p.add_argument("--only", default="",
                   help="time only the cases whose `kernel [shape]` "
                   "matches this regular expression")
    p.add_argument("--no-steps", action="store_true",
                   help="leave out the train steps' profiles")
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--root", help=argparse.SUPPRESS)   # a child's tree
    p.add_argument("--save", help=argparse.SUPPRESS)   # a child's outputs
    return p.parse_args()


def run_order(changes):
    """The trees in the order they run: the parent, each change, the
    changes again in reverse, the parent."""
    return ["parent", *changes, *reversed(changes), "parent"]


def selected(cases, only):
    """The cases [(kernel, label, call)] whose `kernel [label]` matches
    the regular expression `only` (all of them when it is empty)."""
    return [c for c in cases if re.search(only, f"{c[0]} [{c[1]}]")]


# ------------------------------------------------------------- one tree

def _cases(dev):
    """[(kernel, label, call)]: each case's call on fixed inputs."""
    import torch

    import chip_smoke as cs
    from ggnn_tpu_torch.models.gcn import gcn_edges
    from ggnn_tpu_torch.ops.kernels import edge_dot, ell_spmm
    from ggnn_tpu_torch.ops.messages import EdgeLanes
    from ggnn_tpu_torch.ops.segment import segment_offsets

    gen = torch.Generator(device=dev).manual_seed(0)
    fwd = ell_spmm.weighted_gather_segment_sum
    bwd = ell_spmm.weighted_segment_scatter_sum
    cases = []

    def weighted(label, kernel, *args):
        cases.append(("weighted", label, lambda: kernel(*args)))

    def dots(label, *args):
        cases.append(("edge_dot", label, lambda: edge_dot.edge_dot(*args)))

    def rows(n, h_dim=HIDDEN, dtype=torch.float32):
        return torch.randn(n, h_dim, generator=gen, device=dev).to(dtype)

    def eighths(n, count):
        return torch.randint(-8, 9, (count,), generator=gen,
                             device=dev).float() / 8, cs.eighths(gen, dev, n)

    for label, batch in cs.gcn_batches():
        b = batch.to(dev)
        n = b.node_capacity
        src, w, offsets, transpose = gcn_edges(b, n, True, True)
        weighted(label, fwd, rows(n), src, w, offsets, n)
        weighted(f"transpose of the {label}", bwd, rows(n), *transpose, n)
    skewed = cs.skewed_lane(dev)
    src, _, tgt = skewed
    w, x = eighths(cs.SKEWED_NODES, src.shape[0])
    weighted("skewed in-degree", fwd, x, src, w,
             segment_offsets(tgt, cs.SKEWED_NODES), cs.SKEWED_NODES)
    bgather, bweights, boff = ell_spmm.weighted_transpose_layout(
        src, tgt, w, cs.SKEWED_NODES)
    weighted("transpose of the skewed in-degree", bwd,
             cs.eighths(gen, dev, cs.SKEWED_NODES), bgather, bweights, boff,
             cs.SKEWED_NODES)
    for seed, kernel, label in ((28, fwd, "hub"), (29, bwd, "hub, transpose")):
        x, idx, offsets = cs.hub_case(dev, gen, seed, 4096, 6000, 1234)
        w = torch.randint(-8, 9, (idx.shape[0],), generator=gen,
                          device=dev).float() / 8
        weighted(label, kernel, x, idx, w, offsets, 4096)
    batches = cs.lane_batches()
    for label, batch, t_dim in batches:
        b = batch.to(dev)
        n = b.node_capacity
        lanes = EdgeLanes.combined(b.edge_sources_all, b.edge_types_all,
                                   b.edge_targets_all, t_dim, n)
        h, g = rows(n), rows(n * t_dim)
        att = torch.rand(lanes.src.shape[0], generator=gen, device=dev)
        weighted(f"attention weights, {label}", fwd, h, b.edge_sources_all,
                 att, lanes.offsets, n * t_dim)
        dots(f"scores, {label}", h, b.edge_sources_all, h,
             b.edge_targets_all)
        dots(f"weights' gradient, {label}", h, b.edge_sources_all, g,
             lanes.segments)
        if n < 20000:
            continue
        ds = torch.randn(lanes.src.shape[0], generator=gen, device=dev)
        for name, order, table in (
                ("EdgeDot backward by a", lanes.source_pairs, h),
                ("EdgeDot backward by b", lanes.target_pairs, h),
                ("aggregation's by source", lanes.segment_transpose, g)):
            ws = ds if order.perm is None else ds[order.perm].contiguous()
            weighted(f"{name}, {label}", bwd, table, order.ids, ws,
                     order.offsets, order.offsets.shape[0] - 1)
        bf16 = torch.bfloat16
        hb, gb = rows(n, BF16_HIDDEN, bf16), rows(n * t_dim, BF16_HIDDEN,
                                                   bf16)
        weighted(f"bf16 H 512 attention weights, {label}", fwd, hb,
                 b.edge_sources_all, att.to(bf16), lanes.offsets, n * t_dim)
        order = lanes.segment_transpose
        weighted(f"bf16 H 512 aggregation's by source, {label}", bwd, gb,
                 order.ids, att.to(bf16)[order.perm].contiguous(),
                 order.offsets, n)
        dots(f"bf16 H 512 scores, {label}", hb, b.edge_sources_all, hb,
             b.edge_targets_all)
        dots(f"bf16 H 512 weights' gradient, {label}", hb,
             b.edge_sources_all, gb, lanes.segments)
    # B1 and B2, which share the weighted instance's source.
    for label, batch, t_dim in batches:
        b = batch.to(dev)
        n = b.node_capacity
        lanes = EdgeLanes.combined(b.edge_sources_all, b.edge_types_all,
                                   b.edge_targets_all, t_dim, n)
        h, g = rows(n), rows(n * t_dim)
        _, bgather, boff = lanes.segment_transpose
        cases.append(("B1", label, lambda h=h, b=b, lanes=lanes, n=n, t=t_dim:
                      ell_spmm.gather_segment_sum(h, b.edge_sources_all,
                                                  lanes.offsets, n * t)))
        cases.append(("B2", f"backward of the {label}",
                      lambda g=g, i=bgather, o=boff, n=n:
                      ell_spmm.segment_scatter_sum(g, i, o, n)))
    x, idx, offsets = cs.hub_case(dev, gen, 23, 4096, 6000, 1234)
    cases.append(("B1", "hub", lambda: ell_spmm.gather_segment_sum(
        x, idx, offsets, 4096)))
    lanes = EdgeLanes.combined(*skewed, cs.EDGE_TYPES, cs.SKEWED_NODES)
    xs = cs.eighths(gen, dev, cs.SKEWED_NODES)
    gs = cs.eighths(gen, dev, cs.SKEWED_NODES * cs.EDGE_TYPES)
    _, bgather, boff = lanes.segment_transpose
    cases.append(("B1", "skewed in-degree", lambda: ell_spmm.gather_segment_sum(
        xs, skewed[0], lanes.offsets, cs.SKEWED_NODES * cs.EDGE_TYPES)))
    cases.append(("B2", "backward of the skewed in-degree",
                  lambda: ell_spmm.segment_scatter_sum(gs, bgather, boff,
                                                       cs.SKEWED_NODES)))
    return cases


def _busy_ms(runner, batch, steps=5):
    """Device-busy ms a train step: the CUDA kernels' time under
    torch.profiler over `steps` steps, after 3."""
    import torch
    from torch.autograd import DeviceType

    for _ in range(3):
        runner.train_step(batch)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(steps):
            runner.train_step(batch)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    return {"busy_ms": sum(e.self_device_time_total for e in events)
            / 1e3 / steps,
            "kernels": sum(e.count for e in events) / steps}


def _steps():
    import chip_smoke as cs
    from ggnn_tpu_torch.data.synthetic import synthetic_molecules
    from ggnn_tpu_torch.training.runner import Runner

    corpus = (synthetic_molecules(2400, seed=22),
              synthetic_molecules(50, seed=23))
    out = {}
    for label, variant, config in (
            ("sparse_attention", "sparse",
             cs.attention_config({"num_epochs": 1})),
            ("gcn", "gcn", cs.train_config("gcn", {"num_epochs": 1}))):
        with tempfile.TemporaryDirectory() as log_dir:
            runner = Runner(variant, config, train_data=corpus[0],
                            valid_data=corpus[1], log_dir=log_dir,
                            quiet=True)
        batch = cs.first_batch(runner, cs.is_20k_batch).to(runner.device)
        out[label] = _busy_ms(runner, batch)
    return out


def child(root, save, repeats, only, steps) -> int:
    sys.path.insert(0, os.path.abspath(root))
    sys.path.insert(1, REPO)
    import torch

    import ggnn_tpu_torch
    from ggnn_tpu_torch.ops.kernels import _build
    from ggnn_tpu_torch.utils.timing import time_ms

    if not os.path.abspath(ggnn_tpu_torch.__file__).startswith(
            os.path.abspath(root)):
        raise RuntimeError(f"imported {ggnn_tpu_torch.__file__}, not {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    _build.build_all(("ell_spmm", "gather_floor", "edge_dot"))
    cases = selected(_cases(dev), only)
    outputs = {}
    for kernel, label, call in cases:
        first, second = call(), call()
        torch.cuda.synchronize()
        if not torch.equal(first, second):
            raise RuntimeError(f"{kernel} [{label}]: two calls differ")
        outputs[f"{kernel} [{label}]"] = first.cpu()
    one = torch.zeros(1, device=dev)
    times = {"zero_ [one element]": []}
    for _ in range(repeats):
        times["zero_ [one element]"].append(time_ms(lambda: one.zero_())[0])
        for kernel, label, call in cases:
            times.setdefault(f"{kernel} [{label}]", []).append(
                time_ms(call)[0])
    torch.save(outputs, save + ".pt")
    with open(save + ".json", "w") as f:
        json.dump({"tree": os.path.abspath(root), "times_ms": times,
                   "steps": _steps() if steps else {}}, f)
    return 0


# ------------------------------------------------------------ both trees

def summarize(runs):
    """(shapes, differences, steps, unequal) of the runs [(tree, result,
    outputs)] of the parent and one change, tree "parent" or "change",
    the first a parent's: per shape the times of each
    tree over all its runs and repeats, their median and spread, the
    change's median over the parent's and whether the change is faster
    by more than the larger spread; per output the largest abs
    difference of a later run from the first (a parent run); the steps'
    records of each tree; and the weighted outputs that differ."""
    by_tree = {"parent": [r for r in runs if r[0] == "parent"],
               "change": [r for r in runs if r[0] == "change"]}
    shapes = {}
    for key in runs[0][1]["times_ms"]:
        rec = {}
        for name, tree_runs in by_tree.items():
            values = [t for _, result, _ in tree_runs
                      for t in result["times_ms"][key]]
            rec[name] = {"ms": values, "median_ms": statistics.median(values),
                         "spread_ms": max(values) - min(values)}
        gain = rec["parent"]["median_ms"] - rec["change"]["median_ms"]
        rec["change_over_parent"] = (rec["change"]["median_ms"]
                                     / rec["parent"]["median_ms"])
        rec["faster_beyond_spread"] = gain > max(rec["parent"]["spread_ms"],
                                                 rec["change"]["spread_ms"])
        shapes[key] = rec
    differences = {}
    for key, parent_out in runs[0][2].items():
        worst = 0.0
        for _, _, outputs in runs[1:]:
            got = outputs[key].float()
            if got.numel():
                worst = max(worst,
                            float((got - parent_out.float()).abs().max()))
        differences[key] = worst
    steps = {name: [result["steps"] for _, result, _ in tree_runs]
             for name, tree_runs in by_tree.items()}
    unequal = {k: v for k, v in differences.items()
               if k.startswith("weighted") and v != 0.0}
    return shapes, differences, steps, unequal


def main() -> int:
    args = _args()
    if args.root is not None:
        return child(args.root, args.save, args.repeats, args.only,
                     not args.no_steps)
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_compare: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    if args.parent is None:
        raise SystemExit("--parent is required")
    sys.path.insert(0, REPO)
    from ggnn_tpu_torch.utils.timing import gpu_name_and_power

    parent = os.path.abspath(args.parent)
    changes = [os.path.abspath(c) for c in args.change or [REPO]]
    work = tempfile.mkdtemp(prefix="kernel_compare_")
    runs = []
    for k, tree in enumerate(run_order(changes)):
        save = os.path.join(work, f"run{k}")
        cmd = [sys.executable, os.path.abspath(__file__), "--root",
               parent if tree == "parent" else tree, "--save", save,
               "--repeats", str(args.repeats), "--only", args.only]
        subprocess.run(cmd + ["--no-steps"] * args.no_steps, check=True)
        with open(save + ".json") as f:
            runs.append((tree, json.load(f), torch.load(save + ".pt")))
        print(f"run {k} ({tree}) done", flush=True)

    report, unequal = {}, {}
    for change in changes:
        shapes, differences, steps, bad = summarize(
            [("parent" if tree == "parent" else "change", result, out)
             for tree, result, out in runs if tree in ("parent", change)])
        print(f"change {change}:", flush=True)
        for key, rec in shapes.items():
            print(f"  {key}: parent {rec['parent']['median_ms'] * 1e3:.3f} "
                  f"us, change {rec['change']['median_ms'] * 1e3:.3f} us "
                  f"({rec['change_over_parent']:.3f}x, spreads "
                  f"{rec['parent']['spread_ms'] * 1e3:.3f} / "
                  f"{rec['change']['spread_ms'] * 1e3:.3f} us)", flush=True)
        for name, recs in steps.items():
            print(f"  {name} steps: {recs}", flush=True)
        report[change] = {"shapes": shapes,
                          "max_abs_difference_vs_parent": differences,
                          "steps": steps, "weighted_bit_equal": not bad}
        if bad:
            unequal[change] = bad
    print(json.dumps({"parent": parent, "changes": report,
                      "device": gpu_name_and_power()}))
    if unequal:
        print(f"the weighted instance differs from the parent's: {unequal}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
