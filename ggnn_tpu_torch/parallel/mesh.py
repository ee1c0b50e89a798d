"""The (data, edge) mesh over `torch.distributed`: the port of
`ggnn_tpu/parallel/mesh.py`.

JAX runs one controller over a `jax.sharding.Mesh` of devices. Here every
mesh position is a process, one rank of a `torch.distributed` group, and
rank = data index * n_edge + edge index (the edge axis trails, as in
JAX, where it gets the shortest links). Each rank holds:

  * its coordinates along both axes;
  * the process group of its data row (the `edge` axis: the ranks that
    share its data index, in edge order) and of its edge column (the
    `data` axis), each made once by `make_mesh`, and the world;
  * the device it computes on.

`process_aligned_data_rows` has no counterpart: each rank is its own
process and packs only what it feeds, so every mesh is process-aligned
by construction. `overlap_compiler_options` (XLA:TPU's async-collective
flags) has none either: a collective here runs when it is called.

Ranks that share one card run over the `gloo` backend (NCCL refuses two
ranks on one GPU). Gloo moves CUDA tensors in its all-reduce,
all-to-all (uneven splits too) and all-gather, but not in point-to-point
sends (measured on an H100 with torch 2.11: the send fails with "Bad
address"). `make_mesh(host_staged=("p2p",))` copies those sends through
host tensors instead; the copy is never chosen silently, a gloo P2P of
a CUDA tensor without it raises, and the `nccl` backend refuses it.

The ragged boundary exchange of an nccl axis goes through peer memory
instead (`Axis.ragged_exchange`, the kernels of
`ops/kernels/ragged_exchange.py`): each rank of the axis allocates one
region, and the ranks swap its CUDA IPC handle over the axis' group, once
a group and again when a capacity regrow needs larger buffers
(`Axis.reserve_peer_buffers`), always outside a CUDA graph's capture.
"""

import dataclasses
import struct
from typing import Dict, FrozenSet, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ggnn_tpu_torch.ops.kernels import ragged_exchange
from ggnn_tpu_torch.utils.device import resolve_device

DATA_AXIS = "data"
EDGE_AXIS = "edge"
WORLD_AXIS = "world"
# The collectives that `host_staged` may copy through the host: gloo's
# point-to-point sends, the one collective it refuses CUDA tensors in.
STAGEABLE = ("p2p",)


@dataclasses.dataclass(frozen=True, eq=False)
class Axis:
    """One mesh axis as this rank sees it: `size` ranks (`ranks`, the
    global ranks in index order), this rank at `index`, their process
    group (None where the axis has one rank and the world more: its
    collectives are the identity and run nothing), the collectives that
    copy CUDA tensors through the host (of `STAGEABLE`) and the
    backend. `peer_buffers` holds the ragged exchange's peer regions
    (`reserve_peer_buffers`): "regions", the current `PeerRegions`, and
    "held", every one made, kept for the process's life because CUDA
    graphs captured over them hold their addresses."""
    name: str
    size: int
    index: int
    ranks: Tuple[int, ...]
    group: Optional[object] = None
    host_staged: FrozenSet[str] = frozenset()
    backend: Optional[str] = None
    peer_buffers: Dict = dataclasses.field(default_factory=dict, init=False,
                                           repr=False, compare=False)

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """`t` reduced in place over the axis (op "sum" or "max")."""
        if self.group is None:
            return t
        reduce_op = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        dist.all_reduce(t, reduce_op, group=self.group)
        return t

    def all_to_all(self, x: torch.Tensor, out_splits: Sequence[int],
                   in_splits: Sequence[int]) -> torch.Tensor:
        """Rows of `x` sent to each index of the axis (`in_splits[i]`
        rows to index i, in order), the rows received (`out_splits[i]`
        from index i) concatenated in index order."""
        out = x.new_empty((sum(out_splits),) + tuple(x.shape[1:]))
        if self.group is None:
            return out.copy_(x)
        dist.all_to_all_single(out, x.contiguous(), list(out_splits),
                               list(in_splits), group=self.group)
        return out

    def shift(self, x: torch.Tensor, k: int) -> torch.Tensor:
        """`x` sent to index (i + k) mod size; returns what index
        (i - k) mod size sent, of x's shape (a ring shift, one P2P
        pair)."""
        if self.group is None or k % self.size == 0:
            return x.clone()
        staged = "p2p" in self.host_staged and x.is_cuda
        if not staged and self.backend == "gloo" and x.is_cuda:
            raise ValueError(
                "gloo sends no CUDA tensor point to point; make the mesh "
                "with host_staged=('p2p',) to copy through the host")
        send, recv = x.contiguous(), torch.empty_like(x)
        out = recv
        if staged:
            send, recv = send.cpu(), recv.cpu()
        to = self.ranks[(self.index + k) % self.size]
        frm = self.ranks[(self.index - k) % self.size]
        ops = [dist.P2POp(dist.isend, send, to, group=self.group),
               dist.P2POp(dist.irecv, recv, frm, group=self.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out if recv is out else out.copy_(recv)

    def reserve_peer_buffers(self, rows: int, row_bytes: int,
                             device) -> "ragged_exchange.PeerRegions":
        """The axis' peer regions, grown first where their buffers hold
        fewer than `rows` rows of `row_bytes` (`ragged_exchange.
        buffer_rows`: the larger of recv_cap and SEND_CAP): a collective
        over the axis that every rank makes at the same call (the whole
        stack's shape decides it alike on every rank, and the ranks'
        sizes are checked equal). It refuses to run inside a CUDA graph's
        capture: the Runner reserves before a new key's warm-up and
        capture."""
        held = self.peer_buffers.get("regions")
        if held is not None and held.fits(rows, row_bytes):
            return held
        if self.backend != "nccl":
            raise ValueError(f"peer buffers need an nccl axis, not "
                             f"{self.backend}")
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "the ragged exchange's peer buffers must grow outside a "
                "CUDA graph's capture (Axis.reserve_peer_buffers before "
                "the step)")
        need = ragged_exchange.buffer_bytes_for(rows, row_bytes)
        size = max(need, 2 * held.buffer_bytes if held is not None else 0)
        device = torch.device(device)
        address, handle = ragged_exchange.allocate(size, device)
        mine = np.frombuffer(handle + struct.pack("<q", size), np.uint8)
        parts = [torch.empty(len(mine), dtype=torch.uint8, device=device)
                 for _ in range(self.size)]
        dist.all_gather(parts, torch.from_numpy(mine.copy()).to(device),
                        group=self.group)
        got = [bytes(p.cpu().numpy()) for p in parts]
        sizes = [struct.unpack("<q", g[-8:])[0] for g in got]
        if len(set(sizes)) != 1:
            raise RuntimeError(f"the ranks of the {self.name} axis grew "
                               f"their peer buffers to {sizes} bytes: a "
                               "regrow must happen on every rank alike")
        addresses = [address if i == self.index
                     else ragged_exchange.open_peer(g[:-8], device)
                     for i, g in enumerate(got)]
        regions = ragged_exchange.regions_of(addresses, size, device)
        self.peer_buffers["regions"] = regions
        self.peer_buffers.setdefault("held", []).append(regions)
        return regions

    def ragged_exchange(self, h: torch.Tensor, spec):
        """This rank's received table [recv_cap, H] of the ragged
        exchange of `h`'s rows (`spec`: this rank's `RaggedSendSpec`
        rows, int32 on the card), through the axis' peer regions, and
        the routes it received, which the exchange's reverse transfer
        takes."""
        regions = self.reserve_peer_buffers(
            ragged_exchange.buffer_rows(spec),
            h.shape[1] * h.element_size(), h.device)
        return ragged_exchange.exchange(h, spec, regions, self.index)

    def ragged_exchange_backward(self, g: torch.Tensor, spec,
                                 routes: torch.Tensor) -> torch.Tensor:
        """The reverse transfer of a `ragged_exchange` (`routes`, what it
        returned beside its table): this rank's pack cotangent [SEND_CAP,
        H] from the table cotangents `g`."""
        regions = self.reserve_peer_buffers(
            ragged_exchange.buffer_rows(spec),
            g.shape[1] * g.element_size(), g.device)
        return ragged_exchange.exchange_backward(g, spec, routes, regions,
                                                 self.index)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every index's `x` (of one shape) concatenated along dim 0 in
        index order."""
        if self.group is None:
            return x.clone()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        return torch.cat(parts)


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's view of an (n_data, n_edge) mesh. `shape` maps each
    axis name to its size (`mesh.shape[EDGE_AXIS]` reads as in JAX);
    `axis(name)` gives the `Axis` of DATA_AXIS (this rank's edge
    column), EDGE_AXIS (its data row) or WORLD_AXIS (every rank)."""
    shape: Dict[str, int]
    rank: int
    device: torch.device
    backend: Optional[str]
    data: Axis
    edge: Axis
    world: Axis

    @property
    def size(self) -> int:
        return self.world.size

    def axis(self, name: str) -> Axis:
        axes = {DATA_AXIS: self.data, EDGE_AXIS: self.edge,
                WORLD_AXIS: self.world}
        if name not in axes:
            raise ValueError(f"no mesh axis {name!r}; the axes are "
                             f"{sorted(axes)}")
        return axes[name]


def initialize_distributed(backend: str, **kwargs) -> None:
    """`torch.distributed.init_process_group(backend, **kwargs)`: call
    once in every rank before `make_mesh()`. The backend is the caller's
    (`"nccl"` for one card a rank, `"gloo"` for ranks on the CPU or
    sharing a card); nothing chooses or replaces it, and a failed
    initialisation raises. Nothing on a machine tells a program of its
    cluster, so pass `init_method` (`"tcp://localhost:<port>"`),
    `world_size` and `rank`."""
    dist.init_process_group(backend=backend, **kwargs)


def _groups(lists):
    """One `new_group` a rank list; every rank calls this for every list,
    in the same order, as `new_group` requires."""
    return [dist.new_group(list(ranks)) for ranks in lists]


def make_mesh(n_data: Optional[int] = None, n_edge: int = 1, *,
              device=None, host_staged: Sequence[str] = ()) -> Mesh:
    """This rank's `Mesh` with axes ("data", "edge") over the
    `torch.distributed` world (one rank and no group when it is not
    initialised). With `n_data=None`, the world size divided by
    `n_edge`. The mesh must cover the world: each rank is one position.

    `device` is where this rank computes: by default the GPU, card
    `rank % device_count` (it raises without CUDA; pass "cpu" to run
    on the CPU). `host_staged` names the collectives (of `STAGEABLE`) that
    copy CUDA tensors through the host: gloo ranks sharing a card pass
    ("p2p",), since gloo sends no CUDA tensor point to point."""
    initialized = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    rank = dist.get_rank() if initialized else 0
    if n_data is None:
        if world % n_edge != 0:
            raise ValueError(
                f"{world} devices not divisible by n_edge={n_edge}")
        n_data = world // n_edge
    need = n_data * n_edge
    if need > world:
        raise ValueError(f"mesh {n_data}x{n_edge} needs {need} devices, "
                         f"have {world}")
    if need < world:
        raise ValueError(f"mesh {n_data}x{n_edge} covers {need} of the "
                         f"{world} ranks; each rank is one position of "
                         "the mesh")
    backend = dist.get_backend() if initialized else None
    staged = frozenset(host_staged)
    unknown = staged - set(STAGEABLE)
    if unknown:
        raise ValueError(f"unknown collectives {sorted(unknown)}; "
                         f"host_staged takes {STAGEABLE}")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    if staged and (backend != "gloo" or dev.type != "cuda"):
        raise ValueError(
            "host staging copies CUDA tensors through the host for gloo "
            f"ranks; this mesh runs {backend} on {dev.type}")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("the nccl backend needs a CUDA device")
        torch.cuda.set_device(dev)
    d_idx, e_idx = divmod(rank, n_edge)
    rows = [tuple(d * n_edge + e for e in range(n_edge))
            for d in range(n_data)]
    cols = [tuple(d * n_edge + e for d in range(n_data))
            for e in range(n_edge)]

    def axis_groups(size, lists):
        # An axis over the whole world runs on the world's group (so a
        # one-rank world still runs its collectives through the
        # backend); one of a single rank in a larger world needs none.
        # new_group is collective over the world: every rank makes every
        # group, in one order.
        if not initialized:
            return [None] * len(lists)
        if size == world:
            return [dist.group.WORLD] * len(lists)
        if size == 1:
            return [None] * len(lists)
        return _groups(lists)

    edge = Axis(EDGE_AXIS, n_edge, e_idx, rows[d_idx],
                axis_groups(n_edge, rows)[d_idx], staged, backend)
    data = Axis(DATA_AXIS, n_data, d_idx, cols[e_idx],
                axis_groups(n_data, cols)[e_idx], staged, backend)
    everyone = Axis(WORLD_AXIS, world, rank, tuple(range(world)),
                    dist.group.WORLD if initialized else None, staged,
                    backend)
    return Mesh(shape={DATA_AXIS: n_data, EDGE_AXIS: n_edge}, rank=rank,
                device=dev, backend=backend, data=data, edge=edge,
                world=everyone)
