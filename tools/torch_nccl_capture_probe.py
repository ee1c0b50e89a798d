#!/usr/bin/env python3
"""Whether a CUDA graph holds the mesh's nccl collectives, on a machine
with four NVIDIA GPUs.

    python3 tools/torch_nccl_capture_probe.py

Four nccl ranks (`parallel/launch.py:RankPool`, rank r on cuda:r) make a
(2, 2) mesh, run one eager all-reduce on each of its groups (as
`Runner._setup_mesh` does before any capture), then for each of the
edge axis' ring shift (`Axis.shift`: `batch_isend_irecv`, the `shift`
exchange), its all-to-all (the `alltoall` exchange) and an all-reduce
over the world: one eager call on a side stream under
`set_sync_debug_mode("error")`, a capture into a CUDA graph on that
stream, three replays, and the replayed result against the eager one,
bit for bit. It prints each rank's results and, last, "capture probe
OK" or "capture probe FAILED" (exit code 1).
"""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

WORLD = 4


def rank_results():
    """This rank's {collective: ("ok", replay equals eager) or ("fail",
    the error)}."""
    import torch
    from ggnn_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(2, 2)
    dev = mesh.device
    out = {"rank": mesh.rank, "device": str(dev)}
    for axis in (mesh.world, mesh.data, mesh.edge):
        axis.all_reduce(torch.zeros(1, device=dev))
    torch.cuda.synchronize()
    x = torch.arange(16., device=dev) + 100 * mesh.rank
    stream = torch.cuda.Stream(dev)
    for name, call in (
            ("edge shift", lambda: mesh.edge.shift(x * 2, 1)),
            ("edge all-to-all",
             lambda: mesh.edge.all_to_all(x * 2, [8, 8], [8, 8])),
            ("world all-reduce", lambda: mesh.world.all_reduce(x * 2))):
        try:
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                torch.cuda.set_sync_debug_mode("error")
                try:
                    want = call().clone()
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            torch.cuda.current_stream(dev).wait_stream(stream)
            torch.cuda.synchronize()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=stream,
                                  capture_error_mode="thread_local"):
                got = call()
            for _ in range(3):
                got.zero_()
                graph.replay()
            torch.cuda.synchronize()
            out[name] = ("ok", bool(torch.equal(got, want)))
        except Exception as err:
            out[name] = ("fail", repr(err)[:300])
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < WORLD:
        print(f"torch_nccl_capture_probe: needs {WORLD} CUDA devices",
              file=sys.stderr)
        return 1
    # The ranks import the rank function by this module's name.
    import torch_nccl_capture_probe as me
    from ggnn_tpu_torch.parallel.launch import RankPool
    with RankPool(WORLD, "nccl", timeout=300, python_path=[
            REPO, os.path.dirname(os.path.abspath(__file__))]) as pool:
        results = pool.run(me.rank_results)
    ok = True
    for res in results:
        print(res, flush=True)
        ok &= all(v == ("ok", True) for k, v in res.items()
                  if k not in ("rank", "device"))
    print("capture probe", "OK" if ok else "FAILED", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
