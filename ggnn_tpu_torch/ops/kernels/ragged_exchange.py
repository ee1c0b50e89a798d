"""Ragged all-to-all of boundary rows over peer memory: the hand-written
CUDA kernels (`csrc/ragged_exchange.cu`), their wrappers, the plain
PyTorch version and the launch counters.

The node-sharded mesh's "ragged" exchange (parallel/node_shard.py) moves
the true per-pair boundary rows between the ranks of an edge axis, as
XLA's `jax.lax.ragged_all_to_all` does at
`ggnn_tpu/parallel/node_shard.py:508`; there is no Pallas kernel. For a
rank `me` of S, with its rows of a `RaggedSendSpec` (int32 tensors on
its card):

    forward   table_d[output_offsets[d] + i] = h[gather[input_offsets[d]
              + i]] for i < send_sizes[d], every peer d; this rank's
              table zero past sum(recv_sizes);
    backward  pack[input_offsets[d] + i] = g_d[output_offsets[d] + i],
              the pack zero elsewhere (the reverse transfer; h's
              gradient is then the pack summed over `gather`, in
              parallel/collectives.py).

The split sizes stay on the card, so a CUDA graph of a step replays any
batch of its stack shape. Each rank owns a region of peer memory
(`allocate`, shared with its peers through CUDA IPC handles by
`parallel/mesh.py`), its buffers sized by `buffer_rows`; a `PeerRegions`
is the S regions of a group as one process sees them. `exchange` and
`exchange_backward` launch one kernel each for one rank's side, which
pushes its rows into its peers' buffers as flagged lines and copies its
own buffer out as the peers' lines arrive. The forward also returns the
routes its peers sent (`routes`: int32 [MAX_RANKS, 3] on the card, where
each owner's rows for this rank sit in its pack and in this table),
which the backward of the same exchange takes and pushes by. They raise
on a tensor that is not on a card: a collective has no single-rank plain
version. `standin_exchange` and `standin_backward` run all S ranks of a
group in one process, as one launch whose grid holds every rank (on one
card), or on CPU tensors the plain version `exchange_reference` /
`exchange_backward_reference`, which is the oracle of the tests.
`launch_plan` sizes a launch's grid from the caps.

Not a `torch.library` op: a call writes into its peers' memory and bumps
round counters on the card, effects that an op's schema cannot state,
and no exported program holds a mesh step.

`launches` counts forward kernel launches (one a rank's exchange, one a
stand-in group's), `backward_launches` reverse transfers'.
"""

import ctypes
import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ggnn_tpu_torch.ops.kernels import _build

# A group's ranks at most (a host's NVLink domain); csrc kMaxRanks.
MAX_RANKS = 8
# A wait's budget before it reports and traps: longer than any host work
# one rank may do while its peers wait in an exchange (a checkpoint, a
# capture, the kernels' build).
WAIT_SECONDS = 120.0
# Buffer sizes round up to this, so that every buffer starts aligned.
_ALIGN = 256
# Threads a block (csrc kThreads); copy units a thread the launch plan
# aims at, and blocks a rank at most.
THREADS = 256
UNITS_A_THREAD = 4
MAX_BLOCKS = 64
# A buffer line (csrc Line): 8 data bytes, each 4 beside the round's
# flag; each buffer starts with MAX_RANKS x ROUTE_LINES route lines.
LINE_BYTES = 16
ROUTE_LINES = 2

launches = 0
backward_launches = 0

_entries = {}
_resident = {}
_P = ctypes.c_void_p
_I = ctypes.c_int
_PP = ctypes.POINTER(_P)
_ARGTYPES = {
    # (buffer_bytes, device, *ptr, handle)
    "rx_region_alloc": [ctypes.c_size_t, _I, _PP, _P],
    # (handle, device, *ptr)
    "rx_region_open": [_P, _I, _PP],
    "rx_handle_bytes": [],
    "rx_status": [],
    # (unit, device, *out)
    "rx_resident_blocks": [_I, _I, ctypes.POINTER(_I)],
    # (src[], out[], gather[], in_off[], send[], out_off[], recv[],
    #  routes[], peers, me0, ranks, S, row_bytes, unit, blocks, cap,
    #  buffer_bytes, seconds, device, stream)
    "rx_forward": [_PP] * 8 + [_P] + [_I] * 7 + [ctypes.c_size_t,
                                                  ctypes.c_double, _I, _P],
    "rx_backward": [_PP] * 8 + [_P] + [_I] * 7 + [ctypes.c_size_t,
                                                   ctypes.c_double, _I, _P],
}


def _kernel(name: str):
    """The C entry point `name` of csrc/ragged_exchange.cu, built at first
    use."""
    fn = _entries.get(name)
    if fn is None:
        fn = getattr(_build.load("ragged_exchange"), name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _entries[name] = fn
    return fn


def _ok(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed: CUDA error {rc}")


def buffer_bytes_for(rows: int, row_bytes: int) -> int:
    """The bytes of one exchange buffer for `rows` rows of `row_bytes`:
    the route lines, then a line for each 8 bytes of a row."""
    need = LINE_BYTES * (MAX_RANKS * ROUTE_LINES
                         + int(rows) * -(-int(row_bytes) // 8))
    return -(-need // _ALIGN) * _ALIGN


def handle_bytes() -> int:
    """The bytes of a region's IPC handle."""
    return _kernel("rx_handle_bytes")()


def allocate(buffer_bytes: int, device: torch.device,
             exportable: bool = True):
    """(address, IPC handle bytes or None) of a new zeroed region of four
    buffers of `buffer_bytes` on `device`, held for the process's life
    (CUDA graphs captured over it keep its address)."""
    ptr = _P()
    handle = (ctypes.create_string_buffer(handle_bytes()) if exportable
              else None)
    _ok(_kernel("rx_region_alloc")(
        buffer_bytes, _index(device), ctypes.byref(ptr),
        None if handle is None else ctypes.cast(handle, _P)),
        "allocating the ragged exchange's peer region")
    return ptr.value, (handle.raw if exportable else None)


def open_peer(handle: bytes, device: torch.device) -> int:
    """The address in this process of a peer's region, from its handle."""
    ptr = _P()
    raw = ctypes.create_string_buffer(bytes(handle), len(handle))
    _ok(_kernel("rx_region_open")(ctypes.cast(raw, _P), _index(device),
                                  ctypes.byref(ptr)),
        "opening a peer's ragged exchange region")
    return ptr.value


def status() -> int:
    """The code a failed kernel left, 0 when none: 1 << 16 (a wait timed
    out) or 2 << 16 (a peer's backward pushed by another route than this
    rank's rows: the route of a forward of other rows) | channel (0
    forward, 1 backward) << 8 | the rank << 4 | the peer."""
    return _kernel("rx_status")()


@dataclasses.dataclass(frozen=True, eq=False)
class PeerRegions:
    """The regions of a group of `size` ranks as this process sees them:
    `table`, their addresses (int64 [size] on the card, by rank), and the
    bytes of each of their buffers."""
    table: torch.Tensor
    buffer_bytes: int
    size: int

    def fits(self, rows: int, row_bytes: int) -> bool:
        return buffer_bytes_for(rows, row_bytes) <= self.buffer_bytes


def regions_of(addresses: Sequence[int], buffer_bytes: int,
               device: torch.device) -> PeerRegions:
    if not 1 <= len(addresses) <= MAX_RANKS:
        raise ValueError(f"a ragged exchange group has 1 to {MAX_RANKS} "
                         f"ranks, got {len(addresses)}")
    return PeerRegions(torch.tensor(list(addresses), dtype=torch.int64,
                                    device=device), buffer_bytes,
                       len(addresses))


def standin_regions(size: int, buffer_bytes: int,
                    device: torch.device) -> PeerRegions:
    """`size` regions on one card, for one process standing in for a
    group's ranks (`standin_exchange`)."""
    return regions_of([allocate(buffer_bytes, device, False)[0]
                       for _ in range(size)], buffer_bytes, device)


def _index(device) -> int:
    device = torch.device(device)
    return device.index if device.index is not None else \
        torch.cuda.current_device()


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _check_rows(spec, size: int, device) -> None:
    for name in ("gather", "input_offsets", "send_sizes", "output_offsets",
                 "recv_sizes"):
        t = getattr(spec, name)
        if not isinstance(t, torch.Tensor) or t.dtype != torch.int32:
            raise TypeError(f"the spec's {name} must be an int32 tensor, "
                            f"got {type(t).__name__} "
                            f"{getattr(t, 'dtype', '')}")
        if t.device != device or not t.is_contiguous() or t.dim() != 1:
            raise ValueError(f"the spec's {name} must be a contiguous 1-D "
                             f"tensor on {device}, got {tuple(t.shape)} on "
                             f"{t.device}")
        if name != "gather" and t.shape[0] != size:
            raise ValueError(f"the spec's {name} has {t.shape[0]} entries "
                             f"for a group of {size}")


def buffer_rows(spec) -> int:
    """Rows a region's buffers must hold for a rank's `spec`: the table's
    recv_cap forward, the pack's SEND_CAP backward (the backward pushes
    at the rows of the owner's pack)."""
    return max(int(spec.recv_cap), int(spec.gather.shape[-1]))


def copy_unit(row_bytes: int, pointers: Sequence[int]) -> int:
    """The unit in bytes the kernels read and write rows in: 8 (a line's
    data) where the row length and every row start allow it, else 4,
    else 2."""
    for unit in (8, 4):
        if row_bytes % unit == 0 and all(p % unit == 0 for p in pointers):
            return unit
    return 2


def launch_plan(send_cap: int, recv_cap: int, row_bytes: int, unit: int,
                ranks: int, resident: int) -> int:
    """Blocks a rank of one launch over `ranks` grid rows: enough that a
    thread copies about UNITS_A_THREAD units of the larger buffer (the
    put and the copy-out are block-stride loops over the flattened rows),
    at most MAX_BLOCKS, within the `resident` blocks the card holds at
    once (every block of a launch must be resident: each waits for the
    puts of all). From the caps alone, so one graph replays every batch
    of a stack shape."""
    units = max(int(send_cap), int(recv_cap)) * (row_bytes // unit)
    want = -(-units // (THREADS * UNITS_A_THREAD))
    fits = resident // ranks
    if fits < 1:
        raise ValueError(f"{ranks} ranks of the ragged exchange do not fit "
                         f"the {resident} blocks the card holds at once")
    return max(1, min(want, MAX_BLOCKS, fits))


def resident_blocks(unit: int, device) -> int:
    """Blocks of the unit's kernels the card holds at once (the
    occupancy API), read once a card."""
    key = (unit, _index(device))
    got = _resident.get(key)
    if got is None:
        out = _I()
        _ok(_kernel("rx_resident_blocks")(unit, key[1], ctypes.byref(out)),
            "the ragged exchange's occupancy query")
        got = _resident[key] = out.value
    return got


def routes(specs: Sequence) -> np.ndarray:
    """[S, MAX_RANKS, 3] int32: the routes each rank's forward returns,
    given every rank's rows (`specs[o]`, host or device): route[d, o] =
    (input_offsets[o, d], send_sizes[o, d], output_offsets[o, d]) for
    each owner o but d, zeros elsewhere."""
    size = len(specs)
    out = np.zeros((size, MAX_RANKS, 3), np.int32)
    for o, spec in enumerate(specs):
        rows = [np.asarray(torch.as_tensor(getattr(spec, f)).cpu()) for f in
                ("input_offsets", "send_sizes", "output_offsets")]
        for d in range(size):
            if d != o:
                out[d, o] = [int(r[d]) for r in rows]
    return out


def _check_rank(x: torch.Tensor, spec, regions: PeerRegions,
                me: int) -> None:
    if x.device.type != "cuda":
        raise ValueError(
            "the ragged exchange kernels run on a card; on the CPU the "
            "group's exchange is `exchange_reference` (or, on a mesh, "
            "gloo's all_to_all_single)")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"rows must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"rows must be a contiguous [N, H] tensor, got "
                         f"{tuple(x.shape)}")
    if not 0 <= me < regions.size:
        raise ValueError(f"rank {me} outside a group of {regions.size}")
    if regions.table.device != x.device:
        raise ValueError(f"the regions lie on {regions.table.device}, the "
                         f"rows on {x.device}")
    _check_rows(spec, regions.size, x.device)
    row_bytes = x.shape[1] * x.element_size()
    if not regions.fits(buffer_rows(spec), row_bytes):
        raise ValueError(f"{buffer_rows(spec)} rows of {row_bytes} bytes do "
                         f"not fit the peer buffers of "
                         f"{regions.buffer_bytes} bytes")


def _launch(entry: str, xs: Sequence[torch.Tensor], specs: Sequence,
            regions: PeerRegions, me0: int, routes=None):
    """One kernel for ranks me0 .. me0 + len(xs) - 1 (their rows `xs`
    and `specs`): forward, their tables and the routes each received;
    backward (given the routes of their forward), their packs."""
    backward = routes is not None
    for i, (x, spec) in enumerate(zip(xs, specs)):
        _check_rank(x, spec, regions, me0 + i)
        if backward and x.shape[0] != spec.recv_cap:
            raise ValueError(f"the table's cotangent has {x.shape[0]} "
                             f"rows, not recv_cap {spec.recv_cap}")
    first = xs[0]
    if any(x.shape[1] != first.shape[1] or x.dtype != first.dtype or
           x.device != first.device for x in xs):
        raise ValueError("a launch's ranks hold rows of one width, dtype "
                         "and card")
    caps = {(int(s.gather.shape[0]), int(s.recv_cap)) for s in specs}
    if len(caps) != 1:
        raise ValueError(f"a launch's ranks share their caps, got {caps}")
    (send_cap, recv_cap), = caps
    if backward:
        if len(routes) != len(xs) or any(
                r.dtype != torch.int32 or r.device != first.device or
                tuple(r.shape) != (MAX_RANKS, 3) or not r.is_contiguous()
                for r in routes):
            raise ValueError("a reverse transfer takes the routes its "
                             "forward returned: int32 [MAX_RANKS, 3] on "
                             "the card, one a rank")
    else:
        routes = [first.new_empty((MAX_RANKS, 3), dtype=torch.int32)
                  for _ in xs]
    outs = [x.new_empty((send_cap if backward else recv_cap, x.shape[1]))
            for x in xs]
    row_bytes = first.shape[1] * first.element_size()
    unit = copy_unit(row_bytes, [t.data_ptr() for t in list(xs) + outs])
    blocks = launch_plan(send_cap, recv_cap, row_bytes, unit, len(xs),
                         resident_blocks(unit, first.device))

    def pointers(ts):
        return (_P * len(ts))(*[t.data_ptr() for t in ts])

    fields = [pointers(xs), pointers(outs)] + [
        pointers([getattr(s, f) for s in specs]) for f in (
            "gather", "input_offsets", "send_sizes", "output_offsets",
            "recv_sizes")] + [pointers(routes)]
    _ok(_kernel(entry)(
        *fields, regions.table.data_ptr(), me0, len(xs), regions.size,
        row_bytes, unit, blocks, send_cap if backward else recv_cap,
        regions.buffer_bytes, WAIT_SECONDS, _index(first.device),
        _stream(first.device)), f"{entry} kernel launch")
    return outs if backward else (outs, routes)


def exchange(h: torch.Tensor, spec, regions: PeerRegions,
             me: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One rank's forward exchange, one kernel: its table [recv_cap, H]
    and the routes it received (int32 [MAX_RANKS, 3]), for the backward
    of this exchange."""
    global launches
    (table,), (route,) = _launch("rx_forward", [h], [spec], regions, me)
    launches += 1
    return table, route


def exchange_backward(g: torch.Tensor, spec, routes: torch.Tensor,
                      regions: PeerRegions, me: int) -> torch.Tensor:
    """One rank's reverse transfer, one kernel: its pack cotangent
    [SEND_CAP, H], pushed by the `routes` its forward returned (another
    exchange's routes trap)."""
    global backward_launches
    (pack,) = _launch("rx_backward", [g], [spec], regions, me, [routes])
    backward_launches += 1
    return pack


def exchange_reference(hs: Sequence[torch.Tensor],
                       specs: Sequence) -> List[torch.Tensor]:
    """The plain version of the group's forward, in one process: S ranks'
    node rows and spec rows in, their S tables out (JAX's
    `ragged_all_to_all`, on any device)."""
    size = len(hs)
    tables = [h.new_zeros((spec.recv_cap, h.shape[1]))
              for h, spec in zip(hs, specs)]
    for o, (h, spec) in enumerate(zip(hs, specs)):
        operand = h[spec.gather.long()]
        for d in range(size):
            n = int(spec.send_sizes[d])
            if d == o or n == 0:
                continue
            first, at = int(spec.input_offsets[d]), int(
                spec.output_offsets[d])
            tables[d][at:at + n] = operand[first:first + n]
    return tables


def exchange_backward_reference(gs: Sequence[torch.Tensor],
                                specs: Sequence) -> List[torch.Tensor]:
    """The plain version of the reverse transfer: S ranks' table
    cotangents in, their S pack cotangents [SEND_CAP, H] out."""
    size = len(gs)
    packs = []
    for o, spec in enumerate(specs):
        pack = gs[o].new_zeros((spec.gather.shape[0], gs[o].shape[1]))
        for d in range(size):
            n = int(spec.send_sizes[d])
            if d == o or n == 0:
                continue
            first, at = int(spec.input_offsets[d]), int(
                spec.output_offsets[d])
            pack[first:first + n] = gs[d][at:at + n]
        packs.append(pack)
    return packs


def standin_exchange(hs: Sequence[torch.Tensor], specs: Sequence,
                     regions: PeerRegions = None):
    """The group's forward with one process standing in for its S ranks:
    (their tables, the routes each received). On the card one kernel
    whose grid holds every rank, over `regions` (`standin_regions`); on
    CPU tensors the plain version and the routes of `routes`."""
    global launches
    if hs[0].device.type != "cuda":
        return exchange_reference(hs, specs), [
            torch.from_numpy(r) for r in routes(specs)]
    tables, received = _launch("rx_forward", hs, specs, regions, 0)
    launches += 1
    return tables, received


def standin_backward(gs: Sequence[torch.Tensor], specs: Sequence,
                     received: Sequence[torch.Tensor],
                     regions: PeerRegions = None) -> List[torch.Tensor]:
    """The group's reverse transfer, standing in for its S ranks, pushed
    by the routes its forward returned (one kernel); on CPU tensors the
    plain version."""
    global backward_launches
    if gs[0].device.type != "cuda":
        return exchange_backward_reference(gs, specs)
    packs = _launch("rx_backward", gs, specs, regions, 0, list(received))
    backward_launches += 1
    return packs
