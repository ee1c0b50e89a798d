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
`parallel/mesh.py`); a `PeerRegions` is the S regions of a group as one
process sees them. `exchange` (a put and a wait kernel) and
`exchange_backward` (a publish and a pull kernel) run one rank's side and
raise on a tensor that is not on a card: a collective has no
single-rank plain version. `standin_exchange` and `standin_backward` run
all S ranks of a group in one process (S puts then S waits, on one card),
or on CPU tensors the plain version `exchange_reference` /
`exchange_backward_reference`, which is the oracle of the tests.

Not a `torch.library` op: a call writes into its peers' memory and bumps
round counters on the card, effects that an op's schema cannot state,
and no exported program holds a mesh step.

`launches` counts forward exchanges (a put and a wait of one rank; a
stand-in call counts S), `backward_launches` reverse transfers.
"""

import ctypes
import dataclasses
from typing import List, Sequence

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

launches = 0
backward_launches = 0

_entries = {}
_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    # (buffer_bytes, device, *ptr, handle)
    "rx_region_alloc": [ctypes.c_size_t, _I, ctypes.POINTER(_P), _P],
    # (handle, device, *ptr)
    "rx_region_open": [_P, _I, ctypes.POINTER(_P)],
    "rx_handle_bytes": [],
    "rx_status": [],
    # (h, gather, in_off, send, out_off, peers, me, S, row_bytes,
    #  buffer_bytes, device, stream)
    "rx_put": [_P] * 6 + [_I] * 3 + [ctypes.c_size_t, _I, _P],
    # (out, recv_sizes, recv_cap, peers, me, S, row_bytes, buffer_bytes,
    #  seconds, device, stream)
    "rx_wait": [_P, _P, _I, _P, _I, _I, _I, ctypes.c_size_t,
                ctypes.c_double, _I, _P],
    # (g, recv_sizes, peers, me, S, row_bytes, buffer_bytes, device,
    #  stream)
    "rx_publish": [_P, _P, _P, _I, _I, _I, ctypes.c_size_t, _I, _P],
    # (pack, send_cap, in_off, send, out_off, peers, me, S, row_bytes,
    #  buffer_bytes, seconds, device, stream)
    "rx_pull": [_P, _I, _P, _P, _P, _P, _I, _I, _I, ctypes.c_size_t,
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
    """The bytes of one exchange buffer for `rows` rows of `row_bytes`."""
    need = max(int(rows) * int(row_bytes), 1)
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
    """The code a timed-out wait left, 0 when none: 1 << 16 | channel
    (0 forward, 1 backward) << 8 | the waiting rank << 4 | the peer it
    waited for."""
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
    if not regions.fits(spec.recv_cap, row_bytes):
        raise ValueError(f"{spec.recv_cap} rows of {row_bytes} bytes do not "
                         f"fit the peer buffers of {regions.buffer_bytes} "
                         "bytes")


def put(h: torch.Tensor, spec, regions: PeerRegions, me: int) -> None:
    """Rank `me`'s rows for every peer into the peer's buffer, and its
    signal to each (the forward's first kernel)."""
    _check_rank(h, spec, regions, me)
    _ok(_kernel("rx_put")(
        h.data_ptr(), spec.gather.data_ptr(), spec.input_offsets.data_ptr(),
        spec.send_sizes.data_ptr(), spec.output_offsets.data_ptr(),
        regions.table.data_ptr(), me, regions.size,
        h.shape[1] * h.element_size(), regions.buffer_bytes,
        _index(h.device), _stream(h.device)), "rx_put kernel launch")


def wait(h: torch.Tensor, spec, regions: PeerRegions,
         me: int) -> torch.Tensor:
    """Rank `me`'s table [recv_cap, H] of h's dtype, once every peer's put
    of the round arrived (the forward's second kernel)."""
    _check_rank(h, spec, regions, me)
    out = h.new_empty((spec.recv_cap, h.shape[1]))
    _ok(_kernel("rx_wait")(
        out.data_ptr(), spec.recv_sizes.data_ptr(), spec.recv_cap,
        regions.table.data_ptr(), me, regions.size,
        h.shape[1] * h.element_size(), regions.buffer_bytes, WAIT_SECONDS,
        _index(h.device), _stream(h.device)), "rx_wait kernel launch")
    return out


def publish(g: torch.Tensor, spec, regions: PeerRegions, me: int) -> None:
    """Rank `me`'s table cotangent into its own backward buffer, and its
    signal to every peer (the backward's first kernel)."""
    _check_rank(g, spec, regions, me)
    if g.shape[0] != spec.recv_cap:
        raise ValueError(f"the table's cotangent has {g.shape[0]} rows, "
                         f"not recv_cap {spec.recv_cap}")
    _ok(_kernel("rx_publish")(
        g.data_ptr(), spec.recv_sizes.data_ptr(), regions.table.data_ptr(),
        me, regions.size, g.shape[1] * g.element_size(),
        regions.buffer_bytes, _index(g.device), _stream(g.device)),
        "rx_publish kernel launch")


def pull(g: torch.Tensor, spec, regions: PeerRegions,
         me: int) -> torch.Tensor:
    """Rank `me`'s pack cotangent [SEND_CAP, H] of g's dtype, pulled from
    its peers' backward buffers once all published (the backward's second
    kernel)."""
    _check_rank(g, spec, regions, me)
    send_cap = spec.gather.shape[0]
    pack = g.new_empty((send_cap, g.shape[1]))
    _ok(_kernel("rx_pull")(
        pack.data_ptr(), send_cap, spec.input_offsets.data_ptr(),
        spec.send_sizes.data_ptr(), spec.output_offsets.data_ptr(),
        regions.table.data_ptr(), me, regions.size,
        g.shape[1] * g.element_size(), regions.buffer_bytes, WAIT_SECONDS,
        _index(g.device), _stream(g.device)), "rx_pull kernel launch")
    return pack


def exchange(h: torch.Tensor, spec, regions: PeerRegions,
             me: int) -> torch.Tensor:
    """One rank's forward exchange: its table [recv_cap, H]."""
    global launches
    put(h, spec, regions, me)
    out = wait(h, spec, regions, me)
    launches += 1
    return out


def exchange_backward(g: torch.Tensor, spec, regions: PeerRegions,
                      me: int) -> torch.Tensor:
    """One rank's reverse transfer: its pack cotangent [SEND_CAP, H]."""
    global backward_launches
    publish(g, spec, regions, me)
    pack = pull(g, spec, regions, me)
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
                     regions: PeerRegions = None) -> List[torch.Tensor]:
    """The group's forward with one process standing in for its S ranks:
    on the card S puts, then S waits, over `regions` (`standin_regions`);
    on CPU tensors the plain version."""
    if hs[0].device.type != "cuda":
        return exchange_reference(hs, specs)
    for me, (h, spec) in enumerate(zip(hs, specs)):
        put(h, spec, regions, me)
    tables = [wait(h, spec, regions, me)
              for me, (h, spec) in enumerate(zip(hs, specs))]
    global launches
    launches += len(hs)
    return tables


def standin_backward(gs: Sequence[torch.Tensor], specs: Sequence,
                     regions: PeerRegions = None) -> List[torch.Tensor]:
    """The group's reverse transfer, standing in for its S ranks: S
    publishes, then S pulls; on CPU tensors the plain version."""
    if gs[0].device.type != "cuda":
        return exchange_backward_reference(gs, specs)
    for me, (g, spec) in enumerate(zip(gs, specs)):
        publish(g, spec, regions, me)
    packs = [pull(g, spec, regions, me)
             for me, (g, spec) in enumerate(zip(gs, specs))]
    global backward_launches
    backward_launches += len(gs)
    return packs
