#!/usr/bin/env python3
"""The ragged exchange's kernels of this tree and of other trees on one
GPU, with one process standing in for the 4 ranks of an edge axis
(`standin_exchange` / `standin_backward`), in one call: µs a group's
forward and reverse transfer, and the tables and packs bit-equal to the
plain version.

    python3 tools/torch_ragged_compare.py --parent DIR [--parent DIR ...]
        [--repeats 2]

Each `--parent DIR` is another tree of the repository (an earlier commit
unpacked with `git archive` where .gitignore lists it, or a copy of
`ggnn_tpu_torch/csrc/ragged_exchange.cu` and
`ggnn_tpu_torch/ops/kernels/ragged_exchange.py` with one design choice
changed, under `DIR/ggnn_tpu_torch/`), named by its directory; its
kernels are built from its own source under another library name
(`tools/torch_mesh_nccl.py:parent_kernels`). On `chip_smoke.py` phase
24's first 20k batch, its first wide batch and an exchange that moves
nothing at the same caps (f32, H 100, S 4, from phase 6's corpus), each
design runs in turns (the trees, this one as "change", then the same in
reverse, `--repeats` times): a forward then a reverse transfer checked
against the plain version bit for bit, then each direction timed by
`utils/timing.py:time_ms` (CUDA events around each call, median of 50)
and inside a CUDA graph of 20 calls (`chip_smoke.replayed_ms`). The
last line of standard output is one JSON object with every time in µs
and the card's name and power limit. Without CUDA it fails.
"""

import argparse
import dataclasses
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

FIELDS = ("gather", "input_offsets", "send_sizes", "output_offsets",
          "recv_sizes")


def shapes(dev):
    """(label, every rank's rows on the card, node states) of phase 24's
    first 20k batch, its first wide one and an empty exchange."""
    from ggnn_tpu_torch.data.synthetic import synthetic_molecules
    batches = cs.ragged_batches((synthetic_molecules(6000, seed=40),
                                 synthetic_molecules(600, seed=41)))
    out = [(label, cs.ragged_rank_rows(spec, dev), states)
           for label, spec, states in (batches[0],
                                       batches[cs.RAGGED_BATCHES])]
    _, rows, states = out[0]
    out.append(("empty", [dataclasses.replace(r, **{
        f: torch.zeros_like(getattr(r, f)) for f in FIELDS}) for r in rows],
        states))
    return out


def stand_in(rx, routed, hs, gs, rows, regions):
    """(forward, backward) of a tree's stand-in group: the tables, then
    the packs of a reverse transfer pushed by the routes of the latest
    forward where the tree's wrapper hands them over (`routed`)."""
    received = {}

    def forward():
        out = rx.standin_exchange(hs, rows, regions)
        if not routed:
            return out
        tables, received["routes"] = out
        return tables

    def backward():
        if routed:
            return rx.standin_backward(gs, rows, received["routes"],
                                       regions)
        return rx.standin_backward(gs, rows, regions)
    return forward, backward


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--parent", action="append", required=True,
                   help="another tree whose kernels are timed (repeatable)")
    p.add_argument("--repeats", type=int, default=2)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("torch_ragged_compare: needs a CUDA device", file=sys.stderr)
        return 1
    import torch_mesh_nccl as tm
    from ggnn_tpu_torch.ops.kernels import _build
    from ggnn_tpu_torch.ops.kernels import ragged_exchange as rx
    trees = [os.path.abspath(t) for t in args.parent]
    _build.build_all(("ragged_exchange",))
    for tree in trees:
        _build.build("ragged_exchange", source=tm.parent_source(tree))
    modules = {os.path.basename(os.path.normpath(t)): tm.parent_kernels(t)
               for t in trees}
    modules["change"] = rx
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(5)
    out = {}
    for label, rows, states in shapes(dev):
        hs = [torch.from_numpy(x).to(dev) for x in states]
        gs = [torch.randn(rows[0].recv_cap, cs.HIDDEN, generator=gen,
                          device=dev) for _ in hs]
        want = (rx.exchange_reference(hs, rows),
                rx.exchange_backward_reference(gs, rows))
        calls = {}
        for name, mod in modules.items():
            regions = mod.standin_regions(len(hs), mod.buffer_bytes_for(
                rx.buffer_rows(rows[0]), 4 * cs.HIDDEN), dev)
            calls[name] = stand_in(mod, tm.takes_routes(mod), hs, gs, rows,
                                   regions)
        times = {}
        order = list(calls)
        for name in (order + order[::-1]) * args.repeats:
            fwd, bwd = calls[name]
            got = (fwd(), bwd())
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in
                       zip(got[0] + got[1], want[0] + want[1])):
                raise RuntimeError(f"{name} at {label}: not the plain "
                                   "version's tables and packs")
            # The forward before the backward: a reverse transfer pushes
            # by what its forward left (routes, or an older tree's state).
            for way, call in (("forward", fwd), ("backward", bwd)):
                ms, _ = cs.time_ms(call)
                rec = times.setdefault(name, {}).setdefault(
                    way, {"us": [], "graph_us": []})
                rec["us"].append(ms * 1e3)
                rec["graph_us"].append(cs.replayed_ms(call) * 1e3)
        out[label] = times
        print(f"{label}: " + "; ".join(
            f"{name} {way} {min(r['us']):.3f} us (graph "
            f"{min(r['graph_us']):.3f})" for name, ways in times.items()
            for way, r in ways.items()), flush=True)
    card = cs.gpu_name_and_power()
    print(card)
    print(json.dumps({"us": out, "trees": args.parent, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
