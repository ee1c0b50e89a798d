"""The ragged boundary exchange of the node-sharded mesh (ROADMAP A22) on
the CPU: the plain version of the hand-written peer-memory kernels
(`ops/kernels/ragged_exchange.py`), which `chip_smoke.py` and
tests/test_torch_cuda.py hold the kernels to on the card, against the
JAX package's ragged exchange (`exchange_boundary` of a
"ragged_emulated" layout, `_ragged_emulated`, under `jax.shard_map` on
the virtual CPU devices of tests/conftest.py); the reverse transfer and
the gather's transpose against autograd of the plain version and JAX's
VJP; the zero tail of a table; the device copy's routing rows; one
graph key for stacks of one shape whose per-pair sizes differ; and the
host side of the one-kernel design: the launch plan from the caps, the
copy unit, the routes a forward returns for its backward, the buffers'
lines, the reverse
transfer pushed by those routes (an emulation of the kernels' data
movement) against the plain version and JAX's VJP, a stale route caught
by the owner, and the buffers sized by max(recv_cap, SEND_CAP).

Tolerances: the tables and the packs exactly (copies of rows); h's
gradient at 1e-6 (several pack rows that name one row of h are summed,
in another order than JAX's).
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

from ggnn_tpu.parallel import make_mesh as jax_make_mesh
from ggnn_tpu.parallel import node_shard as jax_node_shard
from ggnn_tpu.parallel.mesh import EDGE_AXIS
from ggnn_tpu_torch.data.synthetic import synthetic_molecules
from ggnn_tpu_torch.ops import segment
from ggnn_tpu_torch.ops.kernels import ragged_exchange
from ggnn_tpu_torch.parallel import node_shard
from ggnn_tpu_torch.parallel.mesh import Axis
from ggnn_tpu_torch.parallel.step import local_rows
from ggnn_tpu_torch.training.config import resolve_config
from ggnn_tpu_torch.training.variants import make_adapter
from ggnn_tpu_torch.data.loader import infer_metadata
from ggnn_tpu_torch.utils.timing import graph_key

torch.set_num_threads(1)

NL = 24          # node rows a shard
SIZES = (2, 3, 4)


def _pair_rows(n_shards, seed, most=9):
    """Random send lists: each ordered pair 0..`most` distinct rows of the
    owner, so that one row often goes to several peers (the gather then
    names it more than once)."""
    rng = np.random.RandomState(seed)
    return {(o, d): sorted(rng.choice(NL, rng.randint(0, most + 1),
                                      replace=False).tolist())
            for o in range(n_shards) for d in range(n_shards) if o != d}


def _spec(n_shards, seed, most=9, slack=5):
    rows = _pair_rows(n_shards, seed, most)
    sizes = np.zeros((n_shards, n_shards), np.int64)
    for (o, d), r in rows.items():
        sizes[o, d] = len(r)
    send_cap = int(sizes.sum(1).max()) + slack
    recv_cap = int(sizes.sum(0).max()) + slack
    return node_shard.ragged_spec(rows, n_shards, send_cap, recv_cap)


def _rank_rows(spec, n_shards):
    """Each rank's rows of a host spec as torch tensors (its device
    copy)."""
    return [node_shard._to(node_shard._shard_of(spec, s), "cpu")
            for s in range(n_shards)]


def _states(n_shards, h_dim, seed):
    rng = np.random.RandomState(seed)
    return rng.randn(n_shards, NL, h_dim).astype(np.float32)


def _jax_exchange(spec, n_shards, h_dim):
    """JAX's exchange of every shard's [NL, H] rows under the spec, as a
    function of the stacked states [S, NL, H] -> tables [S, recv_cap, H]
    (`shard_map` over an edge axis of S virtual CPU devices)."""
    jspec = jax_node_shard.RaggedSendSpec(
        **{f: jnp.asarray(np.asarray(getattr(spec, f)), jnp.int32)
           for f in ("gather", "input_offsets", "send_sizes",
                     "output_offsets", "recv_sizes")},
        recv_cap=spec.recv_cap, emulate=True)
    mesh = jax_make_mesh(n_data=1, n_edge=n_shards)
    edge = PartitionSpec(EDGE_AXIS)

    def body(h, rows):
        local = jax.tree_util.tree_map(lambda x: x[0], rows)
        return jax_node_shard.exchange_boundary(h[0], local, EDGE_AXIS,
                                                h_dim)[None]

    return jax.shard_map(body, mesh=mesh, in_specs=(edge, edge),
                         out_specs=edge, check_vma=False), jspec


@pytest.mark.parametrize("n_shards", SIZES)
def test_plain_version_matches_jax_ragged_exchange(n_shards):
    """The plain version's S tables equal JAX's ragged exchange of the
    same rows under the same layout, bit for bit."""
    h_dim = 8 if n_shards < 4 else 16
    spec = _spec(n_shards, seed=n_shards)
    states = _states(n_shards, h_dim, seed=10 + n_shards)
    got = ragged_exchange.exchange_reference(
        [torch.from_numpy(h) for h in states], _rank_rows(spec, n_shards))
    fn, jspec = _jax_exchange(spec, n_shards, h_dim)
    want = np.asarray(jax.jit(fn)(jnp.asarray(states), jspec))
    for s in range(n_shards):
        np.testing.assert_array_equal(got[s].numpy(), want[s])
    # A stand-in for the group on CPU tensors is the plain version.
    again, _ = ragged_exchange.standin_exchange(
        [torch.from_numpy(h) for h in states], _rank_rows(spec, n_shards))
    for a, b in zip(again, got):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n_shards", SIZES)
def test_reverse_transfer_matches_autograd_and_jax_vjp(n_shards):
    """The reverse transfer (each owner pulls its slices' cotangents into
    its pack) followed by the gather's transpose (a sorted sum, as the
    card's backward takes it) gives h's gradient of autograd through the
    plain version and of JAX's VJP at 1e-6; a row sent to several peers
    sums their cotangents."""
    h_dim = 8
    spec = _spec(n_shards, seed=20 + n_shards)
    rows = _rank_rows(spec, n_shards)
    states = _states(n_shards, h_dim, seed=30 + n_shards)
    rng = np.random.RandomState(40 + n_shards)
    cot = rng.randn(n_shards, spec.recv_cap, h_dim).astype(np.float32)
    gather = np.asarray(spec.gather)
    # Past two shards some row goes to two peers; the pads name row 0.
    assert n_shards == 2 or any(
        len(set(g)) < len(g) for g in
        (gather[s][:int(np.asarray(spec.send_sizes)[s].sum())]
         for s in range(n_shards))), "no row sent twice"

    packs = ragged_exchange.exchange_backward_reference(
        [torch.from_numpy(g) for g in cot], rows)
    got = [segment.sorted_segment_sum(
        pack, segment.sorted_segments(r.gather, NL)).numpy()
        for pack, r in zip(packs, rows)]

    hs = [torch.from_numpy(h).requires_grad_() for h in states]
    tables = ragged_exchange.exchange_reference(hs, rows)
    sum((t * torch.from_numpy(g)).sum()
        for t, g in zip(tables, cot)).backward()
    fn, jspec = _jax_exchange(spec, n_shards, h_dim)
    want_jax = jax.jit(lambda h, c: jax.vjp(lambda x: fn(x, jspec), h)[1](
        c)[0])(jnp.asarray(states), jnp.asarray(cot))
    for s in range(n_shards):
        np.testing.assert_allclose(got[s], hs[s].grad.numpy(), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(got[s], np.asarray(want_jax[s]), rtol=0,
                                   atol=1e-6)
    # The packs are the slices' cotangents themselves.
    for o, pack in enumerate(packs):
        for d in range(n_shards):
            n = int(np.asarray(spec.send_sizes)[o, d])
            first = int(np.asarray(spec.input_offsets)[o, d])
            at = int(np.asarray(spec.output_offsets)[o, d])
            if o != d and n:
                np.testing.assert_array_equal(pack[first:first + n].numpy(),
                                              cot[d][at:at + n])


@pytest.mark.parametrize("n_shards", SIZES)
def test_table_rows_past_the_received_are_zero(n_shards):
    """Rows [sum recv_sizes, recv_cap) of every table are zero, as JAX's
    `out = jnp.zeros(...)` leaves them; the rows before are the peers'
    rows (none of them zero here)."""
    spec = _spec(n_shards, seed=50 + n_shards, slack=7)
    states = np.abs(_states(n_shards, 8, seed=60)) + 1.0
    tables = ragged_exchange.exchange_reference(
        [torch.from_numpy(h) for h in states], _rank_rows(spec, n_shards))
    for s, table in enumerate(tables):
        n = int(np.asarray(spec.recv_sizes)[s].sum())
        assert n < spec.recv_cap
        assert torch.count_nonzero(table[n:]) == 0
        assert bool((table[:n] >= 1.0).all())


def _sparse_batches(n, seed=0):
    config = resolve_config("sparse", config_json='{"hidden_size": 8, '
                            '"batch_size": 150, "native_pack": false}')
    data = synthetic_molecules(n, seed=seed)
    meta = infer_metadata([data], config["tie_fwd_bkwd"])
    adapter = make_adapter("sparse", config, meta)
    processed = adapter.preprocess(data, False)
    adapter.plan(processed)
    return list(adapter.batches(processed, False))


def test_device_copy_holds_routing_rows_as_int32_tensors():
    """A shard's device copy holds every routing row as an int32 tensor
    (the host layout's int64 `recv_sizes`, as JAX's, cast), for the
    sparse and the GCN layouts; a graph's input buffers keep the host
    dtype, and the exchange casts them on the device."""
    batches = _sparse_batches(40)
    caps = node_shard.plan_node_shard_caps(batches, 3)
    sharded = node_shard.shard_batch(batches[0], caps, "ragged")
    assert np.asarray(sharded.send_idx.recv_sizes).dtype == np.int64
    for s in range(3):
        spec = sharded.local_view(s).to("cpu").send_idx
        for f in ("gather", "input_offsets", "send_sizes", "output_offsets",
                  "recv_sizes"):
            row = getattr(spec, f)
            assert isinstance(row, torch.Tensor)
            assert row.dtype == torch.int32, f
            np.testing.assert_array_equal(
                row.numpy(), np.asarray(getattr(sharded.send_idx, f))[s])
    wide = dataclasses.replace(spec, recv_sizes=spec.recv_sizes.long())
    assert node_shard._int32_rows(wide).recv_sizes.dtype == torch.int32


def test_one_graph_key_for_stacks_whose_pair_sizes_differ():
    """Two stacks of one shape whose per-pair sizes differ share one
    `graph_key`, and so do a rank's rows of them: no value of the spec
    reaches a key."""
    batches = _sparse_batches(120, seed=5)
    caps = node_shard.plan_node_shard_caps(batches, 4)
    stacks = [node_shard.shard_and_stack([b], caps, 1, "ragged")
              for b in batches[:2]]
    sizes = [np.asarray(s[0].send_idx.send_sizes) for s in stacks]
    assert not np.array_equal(*sizes)
    assert graph_key(tuple(stacks[0])) == graph_key(tuple(stacks[1]))
    mesh = type("Mesh", (), {"shape": {"data": 1, "edge": 4},
                             "data": Axis("data", 1, 0, (0,)),
                             "edge": Axis("edge", 4, 1, (0, 1, 2, 3))})()
    rows = [local_rows(s, mesh, "sparse") for s in stacks]
    assert graph_key(rows[0]) == graph_key(rows[1])


def test_rank_kernels_refuse_cpu_tensors_and_gloo_axes():
    """One rank's exchange runs on a card only (a collective has no
    single-rank plain version); peer buffers need an nccl axis."""
    spec = _rank_rows(_spec(2, seed=1), 2)[0]
    regions = ragged_exchange.PeerRegions(torch.zeros(2, dtype=torch.int64),
                                          1024, 2)
    with pytest.raises(ValueError, match="on a card"):
        ragged_exchange.exchange(torch.zeros(NL, 8), spec, regions, 0)
    axis = Axis("edge", 2, 0, (0, 1), backend="gloo")
    with pytest.raises(ValueError, match="nccl"):
        axis.reserve_peer_buffers(8, 32, "cpu")


class _ThreadAxis:
    """An nccl edge axis as `exchange_boundary` sees it, with threads of
    one process standing in for its ranks: its ragged exchange and
    reverse transfer are the group's plain versions, every rank's inputs
    met at a barrier (the kernels' put and wait, pull and publish)."""

    backend = "nccl"

    def __init__(self, index, shared):
        self.index, self.shared = index, shared

    def _group(self, fn, x, spec):
        self.shared["x"][self.index] = x.detach()
        self.shared["spec"][self.index] = spec
        self.shared["barrier"].wait()
        out = fn(self.shared["x"], self.shared["spec"])[self.index]
        self.shared["barrier"].wait()
        return out

    def ragged_exchange(self, h, spec):
        table = self._group(ragged_exchange.exchange_reference, h, spec)
        return table, ("routes of", spec)

    def ragged_exchange_backward(self, g, spec, routes):
        assert routes == ("routes of", spec)   # its own forward's
        return self._group(ragged_exchange.exchange_backward_reference, g,
                           spec)


@pytest.mark.parametrize("n_shards", SIZES)
def test_nccl_branch_gradient_with_threads_for_ranks(n_shards):
    """`exchange_boundary` on an nccl axis (threads standing in for its
    ranks and the plain version for the kernels) takes the ragged
    Function: its tables are JAX's and h's gradient (the reverse
    transfer, then the gather's transpose in a fixed order) is JAX's VJP
    at 1e-6, from rows whose `recv_sizes` are int64, as a captured step's
    input buffers hold them."""
    import threading
    h_dim = 8
    spec = _spec(n_shards, seed=70 + n_shards)
    states = _states(n_shards, h_dim, seed=80 + n_shards)
    cot = np.random.RandomState(90).randn(
        n_shards, spec.recv_cap, h_dim).astype(np.float32)
    shared = {"x": [None] * n_shards, "spec": [None] * n_shards,
              "barrier": threading.Barrier(n_shards, timeout=60)}
    tables, grads, errors = [None] * n_shards, [None] * n_shards, []

    def rank(r):
        try:
            host = node_shard._shard_of(spec, r)
            rows = dataclasses.replace(host, **{
                f: torch.from_numpy(np.asarray(getattr(host, f)))
                for f in ("gather", "input_offsets", "send_sizes",
                          "output_offsets", "recv_sizes")})
            h = torch.from_numpy(states[r]).requires_grad_()
            table = node_shard.exchange_boundary(
                h, rows, _ThreadAxis(r, shared), h_dim)
            (table * torch.from_numpy(cot[r])).sum().backward()
            tables[r], grads[r] = table.detach(), h.grad
        except Exception as err:    # reported by the main thread
            errors.append(err)
            shared["barrier"].abort()

    threads = [threading.Thread(target=rank, args=(r,))
               for r in range(n_shards)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert np.asarray(spec.recv_sizes).dtype == np.int64
    fn, jspec = _jax_exchange(spec, n_shards, h_dim)
    want = np.asarray(jax.jit(fn)(jnp.asarray(states), jspec))
    want_grad = jax.jit(lambda h, c: jax.vjp(lambda x: fn(x, jspec), h)[1](
        c)[0])(jnp.asarray(states), jnp.asarray(cot))
    for r in range(n_shards):
        np.testing.assert_array_equal(tables[r].numpy(), want[r])
        np.testing.assert_allclose(grads[r].numpy(),
                                   np.asarray(want_grad[r]), rtol=0,
                                   atol=1e-6)


# ------------------------------------------------ the one-kernel design

@pytest.mark.parametrize("send_cap,recv_cap,row_bytes,unit,ranks,resident,"
                         "blocks", [
                             # the 20k stand-in's caps, f32 H 100: 64,450
                             # 8-byte units over 1,024 a block
                             (1241, 1289, 400, 8, 4, 792, 63),
                             (1241, 1289, 400, 8, 1, 792, 63),
                             # bf16 H 100: 32,225 units
                             (1241, 1289, 200, 8, 4, 792, 32),
                             # bf16 of odd width at 2-byte units
                             (1241, 1289, 74, 2, 4, 792, 47),
                             # a molecular layout at 1x4: one block
                             (16, 16, 400, 8, 1, 792, 1),
                             # empty caps still launch (the route lines)
                             (0, 0, 400, 8, 2, 792, 1),
                             # many units: MAX_BLOCKS a rank
                             (100000, 10, 2048, 8, 1, 792, 64),
                             # what the card holds at once bounds a grid
                             (100000, 10, 2048, 8, 8, 300, 37),
                         ])
def test_launch_plan_from_the_caps(send_cap, recv_cap, row_bytes, unit,
                                   ranks, resident, blocks):
    """Blocks a rank: about UNITS_A_THREAD units a thread of the larger
    buffer, at least 1, at most MAX_BLOCKS and what the card holds at
    once over the grid's ranks; from the caps alone."""
    got = ragged_exchange.launch_plan(send_cap, recv_cap, row_bytes, unit,
                                      ranks, resident)
    assert got == blocks
    assert got * ranks <= resident


def test_launch_plan_refuses_a_grid_the_card_cannot_hold():
    """Every block of a launch must be resident (each waits for the puts
    of all): a grid of more ranks than resident blocks raises."""
    with pytest.raises(ValueError, match="do not fit"):
        ragged_exchange.launch_plan(8, 8, 32, 16, 8, 7)


@pytest.mark.parametrize("row_bytes,pointers,unit", [
    (400, [0, 256, 4096], 8), (148, [0, 256], 4), (400, [0, 4], 4),
    (74, [0, 256], 2), (200, [0, 16], 8), (128, [0, 2], 2)])
def test_copy_unit(row_bytes, pointers, unit):
    """8 bytes (a line's data) where the row and every row start allow
    it, else 4, else 2: f32 and bf16 rows of any width."""
    assert ragged_exchange.copy_unit(row_bytes, pointers) == unit


@pytest.mark.parametrize("n_shards", SIZES)
def test_forward_returns_each_owners_route(n_shards):
    """The routes a rank's forward returns for its backward: int32
    [MAX_RANKS, 3], row o = (input_offsets[o, me], send_sizes[o, me],
    output_offsets[o, me]) of each owner o, zero for itself and past S;
    the stand-in on CPU tensors returns them beside the plain tables."""
    spec = _spec(n_shards, seed=100 + n_shards)
    rows = _rank_rows(spec, n_shards)
    got = ragged_exchange.routes(rows)
    assert got.shape == (n_shards, ragged_exchange.MAX_RANKS, 3)
    assert got.dtype == np.int32
    for me in range(n_shards):
        for o in range(ragged_exchange.MAX_RANKS):
            want = ([int(np.asarray(getattr(spec, f))[o, me]) for f in (
                "input_offsets", "send_sizes", "output_offsets")]
                if o < n_shards and o != me else [0, 0, 0])
            assert got[me, o].tolist() == want
    _, received = ragged_exchange.standin_exchange(
        [torch.from_numpy(h) for h in _states(n_shards, 8, 3)], rows)
    for me, r in enumerate(received):
        assert r.dtype == torch.int32
        np.testing.assert_array_equal(r.numpy(), got[me])


@pytest.mark.parametrize("rows,row_bytes,lines", [
    (1289, 400, 1289 * 50), (1241, 200, 1241 * 25), (16, 74, 16 * 10),
    (0, 400, 0)])
def test_buffer_holds_route_lines_then_a_line_a_row_chunk(rows, row_bytes,
                                                          lines):
    """A buffer holds MAX_RANKS x ROUTE_LINES route lines, then a
    16-byte line for each 8 bytes of each row (a bf16 row of odd width
    padded to its last line), rounded up to keep buffers aligned."""
    got = ragged_exchange.buffer_bytes_for(rows, row_bytes)
    need = ragged_exchange.LINE_BYTES * (
        ragged_exchange.MAX_RANKS * ragged_exchange.ROUTE_LINES + lines)
    assert need <= got < need + 256
    assert got % 256 == 0


def _pushed_backward(gs, rows, forward_rows):
    """The kernels' reverse transfer emulated on the host: each rank
    pushes its table cotangent's slice of each owner into the owner's
    backward buffer (max(recv_cap, SEND_CAP) rows) by the routes the
    forward of `forward_rows` returned, after that route (its route
    lines); each owner copies its rows of the buffer into its pack, zero
    elsewhere. Returns (packs, the owners to whom a pusher's route
    differs from their own rows)."""
    size = len(rows)
    routes = ragged_exchange.routes(forward_rows)
    cap = ragged_exchange.buffer_rows(rows[0])
    buffers = [gs[0].new_full((cap, gs[0].shape[1]), float("nan"))
               for _ in range(size)]
    pushed = np.zeros((size, ragged_exchange.MAX_RANKS, 3), np.int32)
    for me in range(size):
        for o in range(size):
            if o == me:
                continue
            first, count, at = routes[me, o].tolist()
            pushed[o, me] = routes[me, o]
            buffers[o][first:first + count] = gs[me][at:at + count]
    packs, stale = [], []
    for me, spec in enumerate(rows):
        own = np.stack([spec.input_offsets.numpy(), spec.send_sizes.numpy(),
                        spec.output_offsets.numpy()], 1)
        if any(not np.array_equal(pushed[me, d], own[d])
               for d in range(size) if d != me):
            stale.append(me)
        pack = torch.zeros(spec.gather.shape[0], gs[me].shape[1])
        for d in range(size):
            first, count = own[d, 0], own[d, 1]
            if d != me:
                pack[first:first + count] = buffers[me][first:first + count]
        packs.append(pack)
    return packs, stale


@pytest.mark.parametrize("n_shards", SIZES)
def test_pushed_reverse_transfer_equals_the_plain_version(n_shards):
    """Pushed by the routes of the forward of the same rows (one more
    pack row than the table has, so the buffers need SEND_CAP), the
    reverse transfer's packs are the plain version's bit for bit, no
    buffer row a pack takes is left unwritten, and every pusher's route
    is the owner's."""
    spec = _spec(n_shards, seed=110 + n_shards)
    spec = dataclasses.replace(
        spec, gather=np.pad(np.asarray(spec.gather),
                            ((0, 0), (0, spec.recv_cap + 1
                                      - np.asarray(spec.gather).shape[1]))))
    rows = _rank_rows(spec, n_shards)
    assert ragged_exchange.buffer_rows(rows[0]) == spec.recv_cap + 1
    cot = np.random.RandomState(120).randn(
        n_shards, spec.recv_cap, 8).astype(np.float32)
    gs = [torch.from_numpy(g) for g in cot]
    packs, stale = _pushed_backward(gs, rows, rows)
    assert stale == []
    for got, want in zip(packs,
                         ragged_exchange.exchange_backward_reference(gs,
                                                                     rows)):
        assert not torch.isnan(got).any()
        assert torch.equal(got, want)
    routes = ragged_exchange.routes(rows)
    sizes = np.asarray(spec.send_sizes)
    for d in range(n_shards):
        assert routes[d, d].tolist() == [0, 0, 0]
        assert routes[d, :n_shards, 1].tolist() == [
            0 if o == d else int(sizes[o, d]) for o in range(n_shards)]


@pytest.mark.parametrize("n_shards", SIZES)
def test_a_stale_route_is_caught_by_the_owner(n_shards):
    """A reverse transfer of other rows than its forward's (the routes of
    another exchange) pushes by routes that differ from the owners' own
    rows (the kernel traps there, code 2 << 16)."""
    rows = _rank_rows(_spec(n_shards, seed=130 + n_shards), n_shards)
    other = _rank_rows(_spec(n_shards, seed=140 + n_shards), n_shards)
    gs = [torch.zeros(rows[0].recv_cap, 4) for _ in rows]
    _, stale = _pushed_backward(gs, rows, other)
    assert stale, "no owner saw the stale route"


def test_buffers_hold_the_larger_of_table_and_pack():
    """A region's buffers hold max(recv_cap, SEND_CAP) rows, the pack's
    when it is the larger: the rank check refuses buffers of recv_cap
    rows alone, and the Runner reserves by `buffer_rows` before a new
    key's capture."""
    from ggnn_tpu_torch.training.runner import Runner
    spec = _spec(2, seed=150)
    wide = dataclasses.replace(spec, gather=np.zeros(
        (2, spec.recv_cap + 9), np.int32))
    rows = _rank_rows(wide, 2)
    need = ragged_exchange.buffer_rows(rows[0])
    assert need == spec.recv_cap + 9
    assert ragged_exchange.buffer_rows(wide) == need   # the host layout
    small = ragged_exchange.PeerRegions(
        torch.zeros(2, dtype=torch.int64),
        ragged_exchange.buffer_bytes_for(spec.recv_cap, 32), 2)
    assert not small.fits(need, 32)
    asked = []
    edge = SimpleNamespace(reserve_peer_buffers=lambda *a: asked.append(a))
    runner = SimpleNamespace(
        mesh=SimpleNamespace(backend="nccl", edge=edge),
        config={"hidden_size": 8}, device="cpu")
    stack = [SimpleNamespace(send_idx=wide,
                             node_features=np.zeros((2, 4, 5)))]
    Runner._reserve_peer_buffers(runner, stack)
    assert asked == [(need, 32, "cpu")]
