"""The CUDA kernels of ggnn_tpu_torch (B1, the aggregation, B2, its
transpose, B3, the gather-floor probe's row gather and the per-edge
route's, the weighted instance of B1's body, the GCN's Â·H and the
attention-weighted aggregation, and `edge_dot`, the attention scores and
their weights' gradient) against their plain PyTorch versions, the
autograd Functions and one training step, on the card, at the sparse,
attention, per-type, per-edge, GCN and async shapes (an async substep's
sum and transpose, its serving forward and its train step, remat on and
off); the
dense family (cuBLAS products, no hand kernel), whose forward and train
step must match the CPU and launch none of the kernels; and `time_ms`.
The weighted instance and `edge_dot` are held at their edge cases too:
widths 1 to 512, views off alignment, no edge, empty segments, a hub, the
skewed lane, lanes whose b repeats, alternates or is all pads.
`train_on_device`'s CUDA graphs are held to the same steps run eagerly
(sparse, gcn, async; dense with dropout), with the launches they hold,
the B1/B2 scratch a graph keeps across a larger capture, the refusal of
a step that synchronises, fresh dropout draws each replay, and the
spans of its captures and replays. The ragged
exchange's peer-memory kernels (csrc/ragged_exchange.cu, one kernel a
direction) with one process standing in for four ranks as one grid,
eager and replayed, f32 and bf16 rows, bit for bit, the routes the
forward returns, forwards run before their reverse transfers, a wait
whose peer never arrives and a backward of other rows than its
forward's, each of which traps. The GRU cell's kernels (csrc/gru.cu,
K1-K4) against their plain versions at the sparse and dense shapes and
on the scalar path, bit-equal repeats, a graph replay, and their
launches in a sparse and a dense train step. Every test
here needs an NVIDIA GPU and skips without one. The file
imports nothing of JAX, so it runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerances: rtol = atol = 1e-5 for a kernel against its plain version
(f32 sums in another order), 0 for B3 (a gather copies bits); 1e-4 for
a model forward or a gradient, which chain 8 GRU steps of f32 products
in another order.
"""

import collections
import dataclasses
import json

import numpy as np
import pytest
import torch

from ggnn_tpu_torch.data import packing
from ggnn_tpu_torch.data.synthetic import synthetic_molecules
from ggnn_tpu_torch.models.base import ModelParams, init_output_heads
from ggnn_tpu_torch.models.dense_ggnn import DenseGGNN
from ggnn_tpu_torch.models.gcn import GCN, BlockedGCN, gcn_edges
from ggnn_tpu_torch.models.sparse_ggnn import SparseGGNN
from ggnn_tpu_torch.ops import attention
from ggnn_tpu_torch.ops.kernels import edge_dot, ell_spmm, gather_floor
from ggnn_tpu_torch.ops.messages import (EdgeLanes,
                                         aggregate_then_transform_combined)
from ggnn_tpu_torch.ops.segment import segment_offsets
from ggnn_tpu_torch.training.config import (default_params_for,
                                            resolve_config)
from ggnn_tpu_torch.training.runner import Runner
from ggnn_tpu_torch.utils.timing import time_ms

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _envelope_batch(n_graphs=200, seed=3):
    caps = packing.PackCapacities(nodes=2048, edges_per_type=16384,
                                  graphs=256, edges_all=16384)
    proc = packing.preprocess_sparse(synthetic_molecules(n_graphs, seed),
                                     4, True, [0], {}, False)
    return next(packing.pack_sparse_batches(proc, 4, caps.nodes + 1, caps,
                                            100, 5, False, None))


def _lane(batch, device):
    src, typ, tgt = (torch.from_numpy(a).to(device) for a in (
        batch.edge_sources_all, batch.edge_types_all,
        batch.edge_targets_all))
    return src, EdgeLanes.combined(src, typ, tgt, 4,
                                   batch.node_capacity).offsets


@pytest.mark.parametrize("h_dim,aligned", [(100, True), (37, True),
                                           (100, False)])
def test_gather_segment_sum_kernel_matches_plain(cuda, h_dim, aligned):
    batch = _envelope_batch()
    n_cap = batch.node_capacity
    src, offsets = _lane(batch, cuda)
    gen = torch.Generator(device=cuda).manual_seed(h_dim)
    flat = torch.randn(n_cap * h_dim + 1, generator=gen, device=cuda)
    # A view one float into its buffer is not 16-byte aligned: the
    # kernel must take its scalar loads.
    h = (flat[:-1] if aligned else flat[1:]).view(n_cap, h_dim)
    before = ell_spmm.launches
    got = ell_spmm.gather_segment_sum(h, src, offsets, n_cap * 4)
    torch.cuda.synchronize()
    assert ell_spmm.launches == before + 1
    want = ell_spmm.gather_segment_sum_reference(h, src, offsets, n_cap * 4)
    torch.testing.assert_close(got, want, **TOL)


def test_long_and_empty_segments_sum_exactly(cuda):
    rng = np.random.default_rng(0)
    counts = np.zeros(512, np.int64)
    counts[7], counts[300] = 3000, 9        # a hub, a batch and a tail
    offsets = torch.from_numpy(np.concatenate(
        [[0], np.cumsum(counts)]).astype(np.int32)).to(cuda)
    src = torch.from_numpy(rng.integers(0, 1000, int(counts.sum()))
                           .astype(np.int32)).to(cuda)
    # Multiples of 1/8: every partial sum is exact in f32.
    h = torch.from_numpy(rng.integers(-16, 17, (1000, 64))
                         .astype(np.float32) / 8).to(cuda)
    got = ell_spmm.gather_segment_sum(h, src, offsets, 512)
    want = ell_spmm.gather_segment_sum_reference(h, src, offsets, 512)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert not got[counts == 0].any()


def test_ell_aggregate_by_type_kernel_matches_plain(cuda):
    rng = np.random.default_rng(1)
    np_total, t_dim, block, ke = 256, 3, 32, 24
    fwd_src = rng.integers(0, np_total, (t_dim, np_total // block, ke))
    fwd_tgt = np.full_like(fwd_src, np_total)
    for t in range(t_dim):
        for b in range(np_total // block):
            k = int(rng.integers(0, ke + 1))
            fwd_tgt[t, b, :k] = np.sort(rng.integers(b * block,
                                                     (b + 1) * block, k))
    h = torch.randn(np_total, 50, device=cuda)
    args = (h, torch.from_numpy(fwd_src.astype(np.int32)).to(cuda),
            torch.from_numpy(fwd_tgt.astype(np.int32)).to(cuda))
    torch.testing.assert_close(ell_spmm.ell_aggregate_by_type(*args),
                               ell_spmm.ell_aggregate_by_type_reference(*args),
                               **TOL)


@pytest.mark.parametrize("block", [64, 256])
def test_ell_ops_over_packed_ell_batches_match_plain(cuda, block):
    """B1 and B2 through `ell_aggregate_by_type` (its gradient too) and
    `ell_scatter_sum` over the layouts the packer attaches with
    `ell_block`, each call one launch."""
    from ggnn_tpu_torch.data.ell import plan_ell_k

    proc = packing.preprocess_sparse(synthetic_molecules(400, seed=9), 4,
                                     True, [0], {}, False)
    caps = packing.plan_capacities(proc, 4, 2000)
    plain = list(packing.pack_sparse_batches(proc, 4, 2000, caps, 100, 5,
                                             False, None))
    ell_k = max(plan_ell_k(b.edge_targets, b.edge_mask, block,
                           edge_sources=b.edge_sources) for b in plain)
    batches = list(packing.pack_sparse_batches(
        proc, 4, 2000, caps, 100, 5, False, None, ell_block=block,
        ell_k=ell_k))
    assert len(batches) == len(plain) > 1
    gen = torch.Generator(device=cuda).manual_seed(0)
    for b in batches:
        layout = [torch.from_numpy(getattr(b, n)).to(cuda) for n in (
            "ell_fwd_src", "ell_fwd_tgt", "ell_bwd_tgt", "ell_bwd_src")]
        np_total = layout[0].shape[1] * block
        h = torch.randn(np_total, 100, generator=gen, device=cuda,
                        requires_grad=True)
        g = torch.randn(4, np_total, 100, generator=gen, device=cuda)
        before = (ell_spmm.launches, ell_spmm.scatter_launches)
        out = ell_spmm.ell_aggregate_by_type(h, *layout)
        (got_dh,) = torch.autograd.grad(out, h, g)
        got_scatter = ell_spmm.ell_scatter_sum(g, *layout[2:])
        torch.cuda.synchronize()
        assert (ell_spmm.launches, ell_spmm.scatter_launches) == (
            before[0] + 1, before[1] + 2)
        want = ell_spmm.ell_aggregate_by_type_reference(h, *layout[:2])
        (want_dh,) = torch.autograd.grad(want, h, g)
        torch.testing.assert_close(out, want, **TOL)
        torch.testing.assert_close(got_dh, want_dh, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(
            got_scatter, ell_spmm.ell_scatter_sum_reference(g, *layout[2:]),
            **TOL)


def test_mixed_devices_raise(cuda):
    h = torch.randn(4, 8, device=cuda)
    src = torch.zeros(2, dtype=torch.int32)
    offsets = torch.tensor([0, 2], dtype=torch.int32)
    with pytest.raises(ValueError, match="different devices"):
        ell_spmm.gather_segment_sum(h, src, offsets, 1)


def test_sparse_ggnn_forward_on_the_card_matches_cpu(cuda):
    config = default_params_for("sparse")
    gen = torch.Generator().manual_seed(0)
    params = ModelParams(SparseGGNN(config, 4, gen),
                         init_output_heads(gen, 100, [0])).eval()
    batch = _envelope_batch(seed=4)
    with torch.no_grad():
        want = params.graph(batch.to("cpu"))
        params.to(cuda)
        before = ell_spmm.launches
        got = params.graph(batch.to(cuda))
        torch.cuda.synchronize()
    assert ell_spmm.launches - before == sum(config["layer_timesteps"])
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


def _transpose(batch, device):
    lane = [torch.from_numpy(a).to(device) for a in (
        batch.edge_sources_all, batch.edge_types_all,
        batch.edge_targets_all)]
    lanes = EdgeLanes.combined(*lane, 4, batch.node_capacity)
    _, bgather, boff = lanes.segment_transpose
    return bgather, boff


@pytest.mark.parametrize("h_dim,aligned", [(100, True), (37, True),
                                           (100, False)])
def test_segment_scatter_sum_kernel_matches_plain(cuda, h_dim, aligned):
    batch = _envelope_batch()
    n_cap = batch.node_capacity
    bgather, boff = _transpose(batch, cuda)
    gen = torch.Generator(device=cuda).manual_seed(h_dim)
    flat = torch.randn(n_cap * 4 * h_dim + 1, generator=gen, device=cuda)
    # A view one float into its buffer is not 16-byte aligned.
    g = (flat[:-1] if aligned else flat[1:]).view(n_cap * 4, h_dim)
    before = ell_spmm.scatter_launches
    got = ell_spmm.segment_scatter_sum(g, bgather, boff, n_cap)
    torch.cuda.synchronize()
    assert ell_spmm.scatter_launches == before + 1
    want = ell_spmm.segment_scatter_sum_reference(g, bgather, boff, n_cap)
    torch.testing.assert_close(got, want, **TOL)


def test_segment_scatter_sum_hub_sums_exactly(cuda):
    rng = np.random.default_rng(2)
    counts = np.zeros(600, np.int64)
    counts[11], counts[400] = 5000, 7       # a hub and a short segment
    boff = torch.from_numpy(np.concatenate(
        [[0], np.cumsum(counts)]).astype(np.int32)).to(cuda)
    bgather = torch.from_numpy(rng.integers(0, 2400, int(counts.sum()))
                               .astype(np.int32)).to(cuda)
    # Multiples of 1/8: every partial sum is exact in f32.
    g = torch.from_numpy(rng.integers(-16, 17, (2400, 100))
                         .astype(np.float32) / 8).to(cuda)
    got = ell_spmm.segment_scatter_sum(g, bgather, boff, 600)
    want = ell_spmm.segment_scatter_sum_reference(g, bgather, boff, 600)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert not got[counts == 0].any()


KERNELS = ("gather_segment_sum", "segment_scatter_sum")
# An id no table has: the kernel must never read the slots that hold it.
POISON = 2**30


def _eighths(rng, rows, h_dim, device, aligned=True):
    """[rows, h_dim] multiples of 1/8 in [-2, 2], so every partial sum is
    exact in f32 and any summation order gives the same bits; a view one
    float into its buffer (not 16-byte aligned) unless `aligned`."""
    flat = rng.integers(-16, 17, rows * h_dim + 1).astype(np.float32) / 8
    flat = torch.from_numpy(flat).to(device)
    return (flat[:-1] if aligned else flat[1:]).view(rows, h_dim)


def _csr(rng, counts, rows, device, before=0, after=0):
    """(idx, clean, offsets) of segments with `counts` edges whose ids
    index `rows` rows, behind `before` slots and ahead of `after` slots
    outside [off[0], off[S]) that hold POISON in `idx` and a valid id in
    `clean` (for the plain version, which reads every slot)."""
    counts = np.asarray(counts, np.int64)
    offsets = before + np.concatenate([[0], np.cumsum(counts)])
    ids = rng.integers(0, rows, before + int(counts.sum()) + after)
    poisoned = ids.copy()
    poisoned[:before] = POISON
    poisoned[before + int(counts.sum()):] = POISON
    return tuple(torch.from_numpy(a.astype(np.int32)).to(device)
                 for a in (poisoned, ids, offsets))


def _check_exact(name, x, idx, clean, offsets, num_segments):
    kernel = getattr(ell_spmm, name)
    plain = getattr(ell_spmm, name + "_reference")
    got = kernel(x, idx, offsets, num_segments)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, plain(x, clean, offsets, num_segments),
                               rtol=0, atol=0)
    return got


@pytest.mark.parametrize("h_dim,aligned", [(100, True), (37, True),
                                           (100, False)])
@pytest.mark.parametrize("copies", [1, 150])
@pytest.mark.parametrize("length", ["0", "1", "c-1", "c", "c+1", "2c+1",
                                    "17c"])
@pytest.mark.parametrize("name", KERNELS)
def test_segment_lengths_around_the_split(cuda, name, length, copies, h_dim,
                                          aligned):
    """Segments of 0, 1, c - 1, c, c + 1, 2c + 1 and 17c edges, c the
    edges past which the kernel cuts a segment: 3c of them (times
    `copies`), each behind a run of 0-2 one-edge segments and 0-1 empty
    ones, so they start at many places of a chunk of c edges and of a
    segment warp's group (one segment a warp for a few hundred segments,
    several for the thousands of 150 copies). Segments of c edges or
    fewer are never cut; one of 17c edges is cut into more than one group
    of pieces."""
    c = ell_spmm.split_edges()
    n = {"0": 0, "1": 1, "c-1": c - 1, "c": c, "c+1": c + 1,
         "2c+1": 2 * c + 1, "17c": 17 * c}[length]
    rng = np.random.default_rng(n * 1000 + h_dim + copies)
    counts = []
    for k in range(3 * c):
        counts += [1] * (k % 3) + [0] * (k % 2) + [n]
    counts *= copies
    rows = 500
    x = _eighths(rng, rows, h_dim, cuda, aligned)
    idx, clean, offsets = _csr(rng, counts, rows, cuda, after=7)
    _check_exact(name, x, idx, clean, offsets, len(counts))


@pytest.mark.parametrize("layout", ["one segment holds every edge",
                                    "all segments empty", "E = 0",
                                    "off[0] > 0"])
@pytest.mark.parametrize("name", KERNELS)
def test_awkward_layouts(cuda, name, layout):
    rng = np.random.default_rng(len(layout))
    before = 0
    if layout == "one segment holds every edge":
        counts = [0] * 300 + [5000] + [0] * 300
    elif layout == "all segments empty":
        counts = [0] * 1000
    elif layout == "E = 0":
        counts = [0] * 70
    else:
        counts, before = rng.integers(0, 150, 400), 333
    rows = 700
    x = _eighths(rng, rows, 100, cuda)
    after = 0 if layout == "E = 0" else 9
    idx, clean, offsets = _csr(rng, counts, rows, cuda, before, after)
    got = _check_exact(name, x, idx, clean, offsets, len(counts))
    assert got.shape == (len(counts), 100)


@pytest.mark.parametrize("name", KERNELS)
def test_calls_of_other_sizes_in_turn_sum_exactly(cuda, name):
    """Calls with few and with many warps, and of two widths, in turn on
    one stream without a synchronisation, each with segments cut across
    warps: the scratch one call leaves must not corrupt the next."""
    rng = np.random.default_rng(11)
    calls = []
    for num_segments, long_every, h_dim in ((50, 5, 100), (3000, 40, 37),
                                            (300, 7, 100), (5000, 25, 100)):
        counts = rng.integers(0, 3, num_segments)
        counts[::long_every] = rng.integers(100, 400,
                                            len(counts[::long_every]))
        x = _eighths(rng, 900, h_dim, cuda)
        idx, clean, offsets = _csr(rng, counts, 900, cuda, after=3)
        calls.append((x, idx, clean, offsets, num_segments))
    kernel = getattr(ell_spmm, name)
    plain = getattr(ell_spmm, name + "_reference")
    for _ in range(2):
        got = [kernel(x, idx, offsets, s)
               for x, idx, _, offsets, s in calls]
        for out, (x, _, clean, offsets, s) in zip(got, calls):
            torch.testing.assert_close(out, plain(x, clean, offsets, s),
                                       rtol=0, atol=0)


def _twenty_k_lane(device):
    """A lane shaped like the 20k-node training batch's: 40,514 edges
    over N = 20,000 nodes and T = 4 types, sorted by composite id, and
    its transpose; returns (B1's src, offsets, S) and (B2's bgather,
    boff, N)."""
    rng = np.random.default_rng(20000)
    n, t_dim, edges = 20000, 4, 40514
    src = rng.integers(0, n, edges)
    composite = np.sort(rng.integers(0, n * t_dim, edges))
    offsets = np.searchsorted(composite, np.arange(n * t_dim + 1))
    order = np.argsort(src, kind="stable")
    boff = np.searchsorted(src[order], np.arange(n + 1))
    src, offsets, bgather, boff = (
        torch.from_numpy(a.astype(np.int32)).to(device)
        for a in (src, offsets, composite[order], boff))
    return (src, offsets, n * t_dim), (bgather, boff, n)


@pytest.mark.parametrize("shape", ["20k-node lane", "hub"])
@pytest.mark.parametrize("name", KERNELS)
def test_two_calls_give_the_same_bits(cuda, name, shape):
    """randn inputs, whose sums round differently in another order: two
    calls must agree bit for bit (the exact tests above hold the values
    against the plain version)."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    if shape == "hub":
        rng = np.random.default_rng(8)
        counts = [0] * 2000 + [5000] + [3] * 100 + [0] * 1000
        idx, _, offsets = _csr(rng, counts, 3000, cuda)
        rows, num_segments = 3000, len(counts)
    else:
        b1, b2 = _twenty_k_lane(cuda)
        idx, offsets, num_segments = b1 if name == KERNELS[0] else b2
        rows = 20000 if name == KERNELS[0] else 80000
    x = torch.randn(rows, 100, generator=gen, device=cuda)
    kernel = getattr(ell_spmm, name)
    first = kernel(x, idx, offsets, num_segments)
    second = kernel(x, idx, offsets, num_segments)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_segment_kernels_count_one_launch_per_call_and_none_when_empty(
        cuda):
    h = torch.randn(64, 100, device=cuda)
    src = torch.randint(0, 64, (40,), device=cuda, dtype=torch.int32)
    offsets = torch.tensor([0, 10, 40], dtype=torch.int32, device=cuda)
    before = (ell_spmm.launches, ell_spmm.scatter_launches)
    ell_spmm.gather_segment_sum(h, src, offsets, 2)
    ell_spmm.segment_scatter_sum(h, src, offsets, 2)
    assert (ell_spmm.launches, ell_spmm.scatter_launches) == (
        before[0] + 1, before[1] + 1)
    no_segments = torch.zeros(1, dtype=torch.int32, device=cuda)
    for kernel in (ell_spmm.gather_segment_sum,
                   ell_spmm.segment_scatter_sum):
        empty = kernel(h, src, no_segments, 0)
        narrow = kernel(h[:, :0], src, offsets, 2)
        assert empty.shape == (0, 100) and narrow.shape == (2, 0)
        assert empty.device.type == narrow.device.type == "cuda"
    torch.cuda.synchronize()
    assert (ell_spmm.launches, ell_spmm.scatter_launches) == (
        before[0] + 1, before[1] + 1)


def test_segment_kernel_registers_are_reported(cuda):
    for vec in (True, False):
        regs = ell_spmm.registers(vec, cuda)
        # __launch_bounds__ pins 4 blocks of 256 threads an SM.
        assert 0 < regs <= 64


def test_aggregation_gradient_on_the_card_matches_plain_autograd(cuda):
    """The autograd Function (B1 forward, B2 backward) against PyTorch's
    autograd of the plain version, on the card."""
    batch = _envelope_batch(seed=5)
    n_cap = batch.node_capacity
    src, offsets = _lane(batch, cuda)
    lane = [torch.from_numpy(a).to(cuda) for a in (
        batch.edge_sources_all, batch.edge_types_all,
        batch.edge_targets_all)]
    gen = torch.Generator(device=cuda).manual_seed(0)
    h = torch.randn(n_cap, 100, generator=gen, device=cuda,
                    requires_grad=True)
    w = (0.1 * torch.randn(4, 100, 100, generator=gen, device=cuda)
         ).requires_grad_(True)
    before = (ell_spmm.launches, ell_spmm.scatter_launches)
    out = aggregate_then_transform_combined(
        h, *lane, w, n_cap, lanes=EdgeLanes.combined(*lane, 4, n_cap))
    got_h, got_w = torch.autograd.grad(torch.tanh(out).sum(), (h, w))
    torch.cuda.synchronize()
    assert (ell_spmm.launches, ell_spmm.scatter_launches) == (
        before[0] + 1, before[1] + 1)
    per = ell_spmm.gather_segment_sum_reference(h, src, offsets, n_cap * 4)
    plain = torch.matmul(per.view(n_cap, -1), w.reshape(-1, 100))
    want_h, want_w = torch.autograd.grad(torch.tanh(plain).sum(), (h, w))
    torch.testing.assert_close(got_h, want_h, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got_w, want_w, rtol=1e-4, atol=1e-4)


def test_train_step_on_the_card_matches_cpu(cuda, tmp_path):
    """One Runner train step, keep probabilities 1.0, from the same
    initial weights on the card and on the CPU: loss at rtol 1e-5, every
    gradient at a relative L2 error <= 1e-4, 8 B1 and 7 B2 launches."""
    config = resolve_config("sparse", config_json=json.dumps({
        "batch_size": 2000, "edge_weight_dropout_keep_prob": 1.0}))
    train = synthetic_molecules(120, seed=7)
    valid = synthetic_molecules(20, seed=8)
    runners = {dev: Runner("sparse", dict(config), train_data=train,
                           valid_data=valid, log_dir=str(tmp_path / dev),
                           quiet=True, device=dev)
               for dev in ("cuda", "cpu")}
    batch = next(iter(runners["cpu"].adapter.batches(
        runners["cpu"].train_processed, False)))
    results = {}
    for dev, runner in runners.items():
        before = (ell_spmm.launches, ell_spmm.scatter_launches)
        results[dev] = runner.loss_and_grads(batch.to(dev))
        if dev == "cuda":
            torch.cuda.synchronize()
            assert (ell_spmm.launches - before[0],
                    ell_spmm.scatter_launches - before[1]) == (8, 7)
    loss_gpu, _, grads_gpu = results["cuda"]
    loss_cpu, _, grads_cpu = results["cpu"]
    torch.testing.assert_close(loss_gpu.cpu(), loss_cpu, rtol=1e-5, atol=0)
    for name, g_cpu in grads_cpu.items():
        g_gpu = grads_gpu[name].cpu()
        rel = float((g_gpu - g_cpu).norm() / g_cpu.norm().clamp_min(1e-30))
        assert rel <= 1e-4, f"{name}: relative L2 error {rel:.3e}"


@pytest.mark.parametrize("streaming", [False, True])
@pytest.mark.parametrize("h_dim", [128, 100, 37])
@pytest.mark.parametrize("unroll", [1, 4, 8])
def test_gather_rows_kernel_equals_plain(cuda, unroll, h_dim, streaming):
    gen = torch.Generator(device=cuda).manual_seed(unroll * 1000 + h_dim)
    h = torch.randn(3000, h_dim, generator=gen, device=cuda)
    # 75 blocks of 40 rows: the last warp's 32-row tile is partly empty.
    src = torch.randint(0, 3000, (75, 40), generator=gen, device=cuda,
                        dtype=torch.int32)
    got = gather_floor.gather_rows(h, src, unroll, streaming)
    want = gather_floor.gather_rows_reference(h, src)
    torch.cuda.synchronize()
    assert gather_floor.vectorized(h, got) == (h_dim % 4 == 0)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("unroll", [1, 8])
def test_gather_rows_unaligned_view_takes_the_scalar_path(cuda, unroll):
    flat = torch.randn(500 * 100 + 1, device=cuda)
    # A view one float into its buffer is not 16-byte aligned.
    h = flat[1:].view(500, 100)
    src = torch.randint(0, 500, (33, 16), device=cuda, dtype=torch.int32)
    got = gather_floor.gather_rows(h, src, unroll)
    assert not gather_floor.vectorized(h, got)
    torch.testing.assert_close(got, gather_floor.gather_rows_reference(
        h, src), rtol=0, atol=0)


def test_gather_rows_counts_one_launch_per_call_and_none_when_empty(cuda):
    h = torch.randn(64, 128, device=cuda)
    src = torch.randint(0, 64, (5, 8), device=cuda, dtype=torch.int32)
    before = gather_floor.launches
    for i, unroll in enumerate((1, 4, 8)):
        gather_floor.gather_rows(h, src, unroll)
        assert gather_floor.launches == before + i + 1
    empty = gather_floor.gather_rows(
        h, torch.zeros(0, 8, device=cuda, dtype=torch.int32), 8)
    torch.cuda.synchronize()
    assert empty.shape == (0, 8, 128) and empty.device.type == "cuda"
    assert gather_floor.launches == before + 3


def test_gather_rows_registers_are_reported(cuda):
    for vec in (True, False):
        for streaming in (False, True):
            for unroll in gather_floor.UNROLLS:
                regs = gather_floor.registers(unroll, vec, streaming, cuda)
                assert 0 < regs <= 255


def _launch_counts():
    return (ell_spmm.launches, ell_spmm.scatter_launches,
            gather_floor.launches, ell_spmm.weighted_launches,
            ell_spmm.weighted_scatter_launches)


def _dense_batch(variant, n_graphs=256, seed=9):
    """One full 256-graph batch of the V = 32 bucket."""
    config = default_params_for(variant)
    data = [g for g in synthetic_molecules(3 * n_graphs, seed=seed)
            if len(g["node_features"]) > 16][:n_graphs]
    bucketed, sizes = packing.preprocess_dense(
        data, 4, True, [0], {}, False, bucket_sizes=np.asarray([16, 32]))
    batch = next(packing.pack_dense_batches(bucketed, sizes, 256, 100, 5,
                                            False))
    assert int(batch.num_graphs) == 256 and batch.num_vertices == 32
    return config, batch


@pytest.mark.parametrize("variant", ["dense", "blocked"])
def test_dense_forward_on_the_card_matches_cpu(cuda, variant):
    config, batch = _dense_batch(variant)
    gen = torch.Generator().manual_seed(0)
    params = ModelParams(DenseGGNN(config, 4, gen),
                         init_output_heads(gen, 100, [0])).eval()
    with torch.no_grad():
        want = params.graph.readout(params.heads, [0], params.graph(
            batch.to("cpu")), batch.to("cpu"))
        params.to(cuda)
        before = _launch_counts()
        on_card = batch.to(cuda)
        got = params.graph.readout(params.heads, [0],
                                   params.graph(on_card), on_card)
        torch.cuda.synchronize()
    assert _launch_counts() == before
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("variant", ["dense", "blocked"])
def test_dense_train_step_on_the_card_matches_cpu(cuda, variant, tmp_path):
    """One Runner train step on a 256-graph batch, keep probabilities
    1.0, from the same initial weights on the card and on the CPU: loss
    at rtol 1e-5, every gradient at a relative L2 error <= 1e-4, and no
    launch of B1, B2 or B3."""
    config, batch = _dense_batch(variant)
    config.update({"edge_weight_dropout_keep_prob": 1.0,
                   "dense_bucket_sizes": [16, 32]})
    train = synthetic_molecules(40, seed=7)
    valid = synthetic_molecules(20, seed=8)
    runners = {dev: Runner(variant, dict(config), train_data=train,
                           valid_data=valid, log_dir=str(tmp_path / dev),
                           quiet=True, device=dev)
               for dev in ("cuda", "cpu")}
    results = {}
    for dev, runner in runners.items():
        before = _launch_counts()
        results[dev] = runner.loss_and_grads(batch.to(dev))
        if dev == "cuda":
            torch.cuda.synchronize()
            assert _launch_counts() == before
    loss_gpu, _, grads_gpu = results["cuda"]
    loss_cpu, _, grads_cpu = results["cpu"]
    torch.testing.assert_close(loss_gpu.cpu(), loss_cpu, rtol=1e-5, atol=0)
    for name, g_cpu in grads_cpu.items():
        g_gpu = grads_gpu[name].cpu()
        rel = float((g_gpu - g_cpu).norm() / g_cpu.norm().clamp_min(1e-30))
        assert rel <= 1e-4, f"{name}: relative L2 error {rel:.3e}"


def test_time_ms_of_a_call_of_hundreds_of_kernels_does_not_depend_on_iters(
        cuda):
    """A `dense` inference forward and readout (hundreds of kernels a
    call): 50 calls fill the launch queue, so time_ms queues them in
    groups behind their own sleeps; the device time must agree with that
    of 5 calls within 20%."""
    config, batch = _dense_batch("dense")
    gen = torch.Generator().manual_seed(0)
    params = ModelParams(DenseGGNN(config, 4, gen),
                         init_output_heads(gen, 100, [0])).to(cuda).eval()
    on_card = batch.to(cuda)

    def forward():
        with torch.inference_mode():
            return params.graph.readout(params.heads, [0],
                                        params.graph(on_card), on_card)

    ms_50, _ = time_ms(forward)
    ms_5, _ = time_ms(forward, iters=5)
    assert abs(ms_50 - ms_5) <= 0.2 * ms_5, (ms_50, ms_5)


# ------------------------------------------------ the weighted instance

W_KERNELS = ("weighted_gather_segment_sum", "weighted_segment_scatter_sum")


def _gcn_batch(n_graphs=300, seed=3, nodes=2048):
    """A GCN batch packed as Predictor packs a request at the default
    envelope (N 2048, COO capacity 16,384)."""
    caps = packing.PackCapacities(nodes=nodes, edges_per_type=8 * nodes,
                                  graphs=256, edges_all=8 * nodes)
    proc = packing.preprocess_gcn(synthetic_molecules(n_graphs, seed), [0],
                                  {}, False)
    return next(packing.pack_gcn_batches(proc, nodes + 1, caps, 100, 5,
                                         False, None))


@pytest.mark.parametrize("h_dim,aligned", [(100, True), (37, True),
                                           (100, False)])
@pytest.mark.parametrize("name", W_KERNELS)
def test_weighted_kernel_matches_plain(cuda, name, h_dim, aligned):
    """The forward over the envelope batch's target-sorted COO list and
    the transpose over its source-sorted one, against the plain version;
    each call counts one launch of its own counter and none of B1's or
    B2's."""
    b = _gcn_batch().to(cuda)
    n_cap = b.node_capacity
    src, weights, offsets, transpose = gcn_edges(b, n_cap, True, True)
    idx, w, off = ((src, weights, offsets) if name == W_KERNELS[0]
                   else transpose)
    gen = torch.Generator(device=cuda).manual_seed(h_dim)
    flat = torch.randn(n_cap * h_dim + 1, generator=gen, device=cuda)
    x = (flat[:-1] if aligned else flat[1:]).view(n_cap, h_dim)
    before = _launch_counts()
    got = getattr(ell_spmm, name)(x, idx, w, off, n_cap)
    torch.cuda.synchronize()
    after = _launch_counts()
    counter = 3 if name == W_KERNELS[0] else 4
    assert [a - b for a, b in zip(after, before)] == [
        int(i == counter) for i in range(5)]
    torch.testing.assert_close(
        got, ell_spmm.weighted_gather_segment_sum_reference(x, idx, w, off, n_cap), **TOL)


def _eighth_weights(rng, n, device):
    return torch.from_numpy(rng.integers(-8, 9, n).astype(np.float32)
                            / 8).to(device)


@pytest.mark.parametrize("layout", ["hub", "lengths around the split",
                                    "one segment holds every edge",
                                    "all segments empty", "off[0] > 0"])
@pytest.mark.parametrize("name", W_KERNELS)
def test_weighted_kernel_sums_exactly(cuda, name, layout):
    """Rows and weights in multiples of 1/8, so every product and partial
    sum is exact in f32: the weighted kernel must equal its plain version
    bit for bit on hubs (cut into pieces across warps), segments around
    the split, empty segments, and with pads poisoned outside
    [off[0], off[S])."""
    c = ell_spmm.split_edges()
    rng = np.random.default_rng(len(layout) * 7 + len(name))
    before = 0
    if layout == "hub":
        counts = [0] * 2000 + [5000] + [3] * 100 + [0] * 1000
    elif layout == "lengths around the split":
        counts = [n for k in range(3 * c)
                  for n in (0, 1, c - 1, c, c + 1, 2 * c + 1, 17 * c)][:400]
    elif layout == "one segment holds every edge":
        counts = [0] * 300 + [5000] + [0] * 300
    elif layout == "all segments empty":
        counts = [0] * 1000
    else:
        counts, before = rng.integers(0, 150, 400), 333
    rows = 3000
    x = _eighths(rng, rows, 100, cuda)
    idx, clean, offsets = _csr(rng, counts, rows, cuda, before, after=9)
    w = _eighth_weights(rng, idx.shape[0], cuda)
    got = getattr(ell_spmm, name)(x, idx, w, offsets, len(counts))
    torch.cuda.synchronize()
    want = ell_spmm.weighted_gather_segment_sum_reference(x, clean, w, offsets, len(counts))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    empty = torch.from_numpy(np.asarray(counts) == 0).to(cuda)
    assert not got[empty].any()


@pytest.mark.parametrize("shape", ["envelope", "hub"])
@pytest.mark.parametrize("name", W_KERNELS)
def test_weighted_kernel_two_calls_give_the_same_bits(cuda, name, shape):
    gen = torch.Generator(device=cuda).manual_seed(11)
    if shape == "hub":
        rng = np.random.default_rng(12)
        counts = [0] * 2000 + [5000] + [3] * 100 + [0] * 1000
        idx, _, off = _csr(rng, counts, 3000, cuda)
        w = torch.rand(idx.shape[0], generator=gen, device=cuda)
        rows, num_segments = 3000, len(counts)
    else:
        b = _gcn_batch(seed=13).to(cuda)
        src, weights, offsets, transpose = gcn_edges(b, b.node_capacity,
                                                     True, True)
        idx, w, off = ((src, weights, offsets) if name == W_KERNELS[0]
                       else transpose)
        rows = num_segments = b.node_capacity
    x = torch.randn(rows, 100, generator=gen, device=cuda)
    kernel = getattr(ell_spmm, name)
    first = kernel(x, idx, w, off, num_segments)
    second = kernel(x, idx, w, off, num_segments)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_segment_kernel_registers_of_every_instance(cuda):
    """B1's and B2's instances keep the registers they had before the
    weighted instance joined the body (float4 62, scalar 51); the
    weighted instances stay within the 64 that 4 blocks of 256 allow."""
    assert ell_spmm.registers(True, cuda) == 62
    assert ell_spmm.registers(False, cuda) == 51
    for vec in (True, False):
        assert 0 < ell_spmm.registers(vec, cuda, weighted=True) <= 64


def test_weighted_aggregation_gradient_on_the_card_matches_plain(cuda):
    """WeightedGatherSegmentSum (the weighted kernel forward, over the
    transpose backward) against PyTorch's autograd of the plain version,
    on the card."""
    b = _gcn_batch(seed=5).to(cuda)
    n_cap = b.node_capacity
    src, weights, offsets, transpose = gcn_edges(b, n_cap, True, True)
    gen = torch.Generator(device=cuda).manual_seed(0)
    h = torch.randn(n_cap, 100, generator=gen, device=cuda,
                    requires_grad=True)
    probe = torch.randn(n_cap, 100, generator=gen, device=cuda)
    before = _launch_counts()
    out = ell_spmm.WeightedGatherSegmentSum.apply(h, src, weights, offsets,
                                                  n_cap, *transpose)
    (got,) = torch.autograd.grad((torch.tanh(out) * probe).sum(), h)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_launch_counts(), before)] == [
        0, 0, 0, 1, 1]
    plain = ell_spmm.weighted_gather_segment_sum_reference(
        h, src, weights, offsets, n_cap)
    (want,) = torch.autograd.grad((torch.tanh(plain) * probe).sum(), h)
    torch.testing.assert_close(out, plain, **TOL)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("variant", ["gcn", "gcn_blocked"])
def test_gcn_forward_on_the_card_matches_cpu(cuda, variant):
    """`gcn` launches the weighted forward once a layer and nothing
    else; `gcn_blocked` launches no hand kernel."""
    config = default_params_for(variant)
    gen = torch.Generator().manual_seed(0)
    model = (GCN(config, gen) if variant == "gcn"
             else BlockedGCN(config, gen))
    params = ModelParams(model, init_output_heads(gen, 100, [0])).eval()
    if variant == "gcn":
        batch = _gcn_batch(seed=4)
    else:
        data = synthetic_molecules(300, seed=4)
        bucketed, sizes = packing.preprocess_gcn_dense(
            data, [0], {}, False, bucket_sizes=np.asarray([16, 32]))
        batch = next(packing.pack_dense_batches(bucketed, sizes, 256, 100,
                                                5, False,
                                                drop_remainder=False))
    with torch.no_grad():
        want = params.graph.readout(params.heads, [0], params.graph(
            batch.to("cpu")), batch.to("cpu"))
        params.to(cuda)
        before = _launch_counts()
        on_card = batch.to(cuda)
        got = params.graph.readout(params.heads, [0], params.graph(on_card),
                                   on_card)
        torch.cuda.synchronize()
    layers = config["num_timesteps"]
    assert [a - b for a, b in zip(_launch_counts(), before)] == (
        [0, 0, 0, layers, 0] if variant == "gcn" else [0] * 5)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("variant", ["gcn", "gcn_blocked"])
def test_gcn_train_step_on_the_card_matches_cpu(cuda, variant, tmp_path):
    """One Runner train step from the same initial weights on the card
    and on the CPU: loss at rtol 1e-5, every gradient at a relative L2
    error <= 1e-4; `gcn` launches the weighted forward once a layer and
    its transpose once a layer but the first (whose input needs no
    gradient), `gcn_blocked` no hand kernel."""
    config = default_params_for(variant)
    config.update({"batch_size": 2000} if variant == "gcn" else
                  {"dense_bucket_sizes": [16, 32]})
    train = synthetic_molecules(120, seed=7)
    valid = synthetic_molecules(20, seed=8)
    runners = {dev: Runner(variant, dict(config), train_data=train,
                           valid_data=valid, log_dir=str(tmp_path / dev),
                           quiet=True, device=dev)
               for dev in ("cuda", "cpu")}
    batch = next(iter(runners["cpu"].adapter.batches(
        runners["cpu"].train_processed, False)))
    results = {}
    for dev, runner in runners.items():
        before = _launch_counts()
        results[dev] = runner.loss_and_grads(batch.to(dev))
        if dev == "cuda":
            torch.cuda.synchronize()
            layers = config["num_timesteps"]
            assert [a - b for a, b in zip(_launch_counts(), before)] == (
                [0, 0, 0, layers, layers - 1] if variant == "gcn"
                else [0] * 5)
    loss_gpu, _, grads_gpu = results["cuda"]
    loss_cpu, _, grads_cpu = results["cpu"]
    torch.testing.assert_close(loss_gpu.cpu(), loss_cpu, rtol=1e-5, atol=0)
    for name, g_cpu in grads_cpu.items():
        g_gpu = grads_gpu[name].cpu()
        rel = float((g_gpu - g_cpu).norm() / g_cpu.norm().clamp_min(1e-30))
        assert rel <= 1e-4, f"{name}: relative L2 error {rel:.3e}"


# ------------------------------------------------------------- async

ASYNC_SMALL = {"propagation_substeps": 40, "num_nodes": 2000}


def _async_runners(tmp_path, overrides=None):
    """A Runner of `async` on the card and one on the CPU, same config,
    same seed, so the same initial weights; 2,000-node batches."""
    config = resolve_config("async", config_json=json.dumps(
        {**ASYNC_SMALL, **(overrides or {})}))
    train = synthetic_molecules(240, seed=7)
    valid = synthetic_molecules(20, seed=8)
    return {dev: Runner("async", dict(config), train_data=train,
                        valid_data=valid, log_dir=str(tmp_path / dev),
                        quiet=True, device=dev)
            for dev in ("cuda", "cpu")}


def _substeps(batch):
    return sum(seg.old_compact.shape[0] for segs in batch.seg_rounds
               for seg in segs)


def test_async_substep_kernels_match_plain_and_repeat_bit_for_bit(cuda,
                                                                   tmp_path):
    """B1 and B2 at the widest substep of an async training batch: its
    compact buffer, its (target, type)-sorted send lane and the layouts
    the model builds once per batch."""
    from ggnn_tpu_torch.models.async_ggnn import (compact_dump_row,
                                                  segment_layouts)

    runner = _async_runners(tmp_path)["cpu"]
    batch = next(iter(runner.adapter.batches(runner.train_processed,
                                             False))).to(cuda)
    t_dim = runner.model.num_edge_types
    m_dump = compact_dump_row(batch)
    layouts = segment_layouts(batch, t_dim, True)
    (r, i), seg = max(
        (((r, i), seg) for r, segs in enumerate(batch.seg_rounds)
         for i, seg in enumerate(segs)),
        key=lambda item: item[1].send_compact.shape[1])
    offsets, bgather, boff = layouts[r][i]
    k = int(torch.argmax(offsets[:, -1]))
    num_segments = seg.old_compact.shape[1] * t_dim
    gen = torch.Generator(device=cuda).manual_seed(5)
    buf = torch.randn(m_dump + 1, 100, generator=gen, device=cuda)
    args = (buf, seg.send_compact[k], offsets[k], num_segments)
    got = ell_spmm.gather_segment_sum(*args)
    torch.testing.assert_close(got, ell_spmm.gather_segment_sum_reference(
        *args), **TOL)
    assert torch.equal(got, ell_spmm.gather_segment_sum(*args))
    g = torch.randn(num_segments, 100, generator=gen, device=cuda)
    back = (g, bgather[k], boff[k], m_dump + 1)
    got = ell_spmm.segment_scatter_sum(*back)
    torch.testing.assert_close(
        got, ell_spmm.segment_scatter_sum_reference(*back), **TOL)
    assert torch.equal(got, ell_spmm.segment_scatter_sum(*back))


def test_async_train_step_on_the_card_matches_cpu(cuda, tmp_path):
    """One Runner train step from the same initial weights on the card
    and on the CPU (the segmented path): loss at rtol 1e-5, every
    gradient at a relative L2 error <= 1e-4; B1 once a substep, B2 once a
    substep but the first of round 0, whose buffer holds only features;
    and the step with `async_remat` on, whose gradients equal it at 1e-6
    (B1 again in the backward, where each substep is recomputed)."""
    runners = _async_runners(tmp_path)
    batch = next(iter(runners["cpu"].adapter.batches(
        runners["cpu"].train_processed, False)))
    substeps = _substeps(batch)
    results = {}
    for dev, runner in runners.items():
        before = _launch_counts()
        results[dev] = runner.loss_and_grads(batch.to(runner.device))
        if dev == "cuda":
            torch.cuda.synchronize()
            assert [a - b for a, b in zip(_launch_counts(), before)] == [
                substeps, substeps - 1, 0, 0, 0]
    loss_gpu, _, grads_gpu = results["cuda"]
    loss_cpu, _, grads_cpu = results["cpu"]
    torch.testing.assert_close(loss_gpu.cpu(), loss_cpu, rtol=1e-5, atol=0)
    for name, g_cpu in grads_cpu.items():
        g_gpu = grads_gpu[name].cpu()
        rel = float((g_gpu - g_cpu).norm() / g_cpu.norm().clamp_min(1e-30))
        assert rel <= 1e-4, f"{name}: relative L2 error {rel:.3e}"
    remat = runners["cuda"]
    remat.model.config["async_remat"] = True
    before = _launch_counts()
    loss, _, grads = remat.loss_and_grads(batch.to(remat.device))
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_launch_counts(), before)] == [
        2 * substeps, substeps - 1, 0, 0, 0]
    torch.testing.assert_close(loss, loss_gpu, rtol=1e-6, atol=0)
    for name, g in grads_gpu.items():
        torch.testing.assert_close(grads[name], g, rtol=1e-6, atol=1e-6)


def test_async_serving_forward_on_the_card_matches_cpu(cuda):
    """The plain path of a served async batch: B1 once a substep of every
    round, no B2; the answers at 1e-4."""
    from ggnn_tpu_torch.data import async_schedule
    from ggnn_tpu_torch.models.async_ggnn import AsyncGGNN

    config = resolve_config("async", config_json=json.dumps(ASYNC_SMALL))
    gen = torch.Generator().manual_seed(0)
    params = ModelParams(AsyncGGNN(config, 4, gen),
                         init_output_heads(gen, 100, [0])).eval()
    caps = async_schedule.AsyncCapacities(
        nodes=512, graphs=64, initial_nodes=512, sending_edges=4096,
        receiving_nodes=512)
    proc = async_schedule.preprocess_async(
        synthetic_molecules(40, seed=4), 4, True, 4, 40, [0], {}, False)
    batch = next(async_schedule.pack_async_batches(
        proc, 4, caps.nodes + 1, caps, 4, 40, 100, 5, False))
    with torch.no_grad():
        want = params.graph.readout(params.heads, [0], params.graph(
            batch.to("cpu")), batch.to("cpu"))
        params.to(cuda)
        before = _launch_counts()
        on_card = batch.to(cuda)
        got = params.graph.readout(params.heads, [0], params.graph(on_card),
                                   on_card)
        torch.cuda.synchronize()
    assert [a - b for a, b in zip(_launch_counts(), before)] == [
        4 * 40, 0, 0, 0, 0]
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


# ------------------------------------------------- attention, A15 routes

def _pairs(batch, device):
    """The combined lane's (src, tgt) as int32 on `device` and their
    EdgeLanes."""
    lane = [torch.from_numpy(a).to(device) for a in (
        batch.edge_sources_all, batch.edge_types_all,
        batch.edge_targets_all)]
    return lane, EdgeLanes.combined(*lane, 4, batch.node_capacity)


@pytest.mark.parametrize("h_dim,aligned", [(100, True), (37, True),
                                           (100, False)])
def test_edge_dot_kernel_matches_plain(cuda, h_dim, aligned):
    """The scores <h[src], h[tgt]> of the envelope's combined lane (the
    pads, tgt = N, give 0) and a gradient's <h[src], g[comp]> (pads past
    the rows of g), each one launch, against the plain version; two
    calls give the same bits."""
    batch = _envelope_batch(seed=21)
    n_cap = batch.node_capacity
    (src, _, tgt), lanes = _pairs(batch, cuda)
    gen = torch.Generator(device=cuda).manual_seed(h_dim)
    flat = torch.randn(n_cap * h_dim + 1, generator=gen, device=cuda)
    h = (flat[:-1] if aligned else flat[1:]).view(n_cap, h_dim)
    g = torch.randn(n_cap * 4, h_dim, generator=gen, device=cuda)
    for x, a, y, b in ((h, src, h, tgt), (h, src, g, lanes.segments)):
        before = edge_dot.launches
        got = edge_dot.edge_dot(x, a, y, b)
        again = edge_dot.edge_dot(x, a, y, b)
        torch.cuda.synchronize()
        assert edge_dot.launches - before == 2
        assert torch.equal(got, again)
        want = edge_dot.edge_dot_reference(x, a, y, b)
        scale = want.abs().max()
        torch.testing.assert_close(got / scale, want / scale, **TOL)
        assert not got[b >= y.shape[0]].any()
    assert edge_dot.vectorized(h, h) == (h_dim % 4 == 0 and aligned)


def test_edge_dot_counts_one_launch_per_call_and_none_when_empty(cuda):
    x = torch.randn(10, 8, device=cuda)
    ids = torch.arange(10, dtype=torch.int32, device=cuda)
    before = edge_dot.launches
    edge_dot.edge_dot(x, ids, x, ids)
    empty = ids[:0]
    assert edge_dot.edge_dot(x, empty, x, empty).shape == (0,)
    torch.cuda.synchronize()
    assert edge_dot.launches - before == 1


def test_edge_dot_registers_are_reported(cuda):
    for vec in (True, False):
        assert 0 < edge_dot.registers(vec, cuda) <= 255


def test_attention_gradients_on_the_card_match_plain_autograd(cuda):
    """The scores (EdgeDot: the kernel forward, two weighted launches
    backward) and the attention-weighted aggregation
    (AttentionGatherSegmentSum: the weighted instance forward, over the
    transpose and edge_dot backward) against PyTorch's autograd of their
    plain versions, on the card."""
    batch = _envelope_batch(seed=22)
    n_cap = batch.node_capacity
    (src, _, tgt), lanes = _pairs(batch, cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    h = (0.3 * torch.randn(n_cap, 100, generator=gen, device=cuda)
         ).requires_grad_(True)
    w = torch.rand(src.shape[0], generator=gen, device=cuda,
                   requires_grad=True)
    probe = torch.randn(n_cap * 4, 100, generator=gen, device=cuda)
    before = (edge_dot.launches, ell_spmm.weighted_launches,
              ell_spmm.weighted_scatter_launches)
    scores = attention.EdgeDot.apply(h, src, h, tgt, lanes.source_pairs,
                                    lanes.target_pairs)
    per = attention.AttentionGatherSegmentSum.apply(
        h, src, w * torch.tanh(scores), lanes.offsets, n_cap * 4,
        lanes.segments, lanes.segment_transpose)
    got_h, got_w = torch.autograd.grad((torch.tanh(per) * probe).sum(),
                                       (h, w))
    torch.cuda.synchronize()
    assert (edge_dot.launches - before[0],
            ell_spmm.weighted_launches - before[1],
            ell_spmm.weighted_scatter_launches - before[2]) == (2, 1, 3)
    plain_scores = edge_dot.edge_dot_reference(h, src, h, tgt)
    plain = ell_spmm.weighted_gather_segment_sum_reference(
        h, src, w * torch.tanh(plain_scores), lanes.offsets, n_cap * 4)
    want_h, want_w = torch.autograd.grad(
        (torch.tanh(plain) * probe).sum(), (h, w))
    torch.testing.assert_close(per, plain, **TOL)
    torch.testing.assert_close(got_h, want_h, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got_w, want_w, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("ke", [96, 100, 37])
def test_gather_rows_function_on_the_card_matches_plain(cuda, ke):
    """GatherRows: B3 at the widest unroll dividing KE, B2 backward."""
    gen = torch.Generator(device=cuda).manual_seed(ke)
    h = torch.randn(500, 100, generator=gen, device=cuda,
                    requires_grad=True)
    src = torch.randint(0, 500, (4, ke), generator=gen, device=cuda,
                        dtype=torch.int32)
    flat = src.reshape(-1).long()
    bgather, boff = ell_spmm.transpose_layout(
        flat, torch.arange(flat.shape[0], device=cuda), 500)
    probe = torch.randn(4, ke, 100, generator=gen, device=cuda)
    before = _launch_counts()
    out = gather_floor.GatherRows.apply(h, src, bgather, boff)
    (got,) = torch.autograd.grad((out * probe).sum(), h)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_launch_counts(), before)] == [
        0, 1, 1, 0, 0]
    assert torch.equal(out, h[src.long()])
    (want,) = torch.autograd.grad((h[src.long()] * probe).sum(), h)
    torch.testing.assert_close(got, want, **TOL)


ROUTES = {"combined": {}, "per-type": {"combined_edge_lanes": False},
          "per-edge": {"aggregate_first": False},
          "unsorted": {"edges_sorted_by_target": False}}


@pytest.mark.parametrize("attention", [False, True])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_sparse_ggnn_route_on_the_card_matches_cpu(cuda, route, attention):
    """Each route of the sparse GGNN, attention off and on, served and
    differentiated on the card against the CPU at 1e-4; the kernels each
    route launches in a forward: B3 only on the per-edge route, edge_dot
    and the weighted instance only with attention (not on the per-edge
    route, whose attention scales the messages before B1)."""
    overrides = {**ROUTES[route], "use_propagation_attention": attention,
                 "use_edge_bias": True}
    config = resolve_config("sparse", config_json=json.dumps(overrides))
    gen = torch.Generator().manual_seed(0)
    params = ModelParams(SparseGGNN(config, 4, gen),
                         init_output_heads(gen, 100, [0]))
    batch = _envelope_batch(seed=23)
    if route == "unsorted":
        rng = np.random.default_rng(3)
        perms = np.stack([rng.permutation(batch.edge_sources.shape[1])
                          for _ in range(4)])
        batch = dataclasses.replace(batch, **{
            k: np.take_along_axis(getattr(batch, k), perms, axis=1)
            for k in ("edge_sources", "edge_targets", "edge_mask")})
    cpu_out = params.graph(batch.to("cpu"))
    torch.tanh(cpu_out).sum().backward()
    want = {n: p.grad.clone() for n, p in params.named_parameters()
            if p.grad is not None}
    params.zero_grad()
    params.to(cuda)
    steps = sum(config["layer_timesteps"])
    before, dots = _launch_counts(), edge_dot.launches
    with torch.no_grad():
        served = params.graph(batch.to(cuda))
    torch.cuda.synchronize()
    counts = [a - b for a, b in zip(_launch_counts(), before)]
    weighted = attention and route != "per-edge"
    assert counts == [0 if weighted else steps, 0,
                      steps if route == "per-edge" else 0,
                      steps if weighted else 0, 0]
    assert edge_dot.launches - dots == (steps if attention else 0)
    torch.testing.assert_close(served.cpu(), cpu_out.detach(), rtol=1e-4,
                               atol=1e-4)
    out = params.graph(batch.to(cuda))
    torch.tanh(out).sum().backward()
    for name, g in want.items():
        got = dict(params.named_parameters())[name].grad.cpu()
        rel = float((got - g).norm() / g.norm().clamp_min(1e-30))
        assert rel <= 1e-4, (name, rel)


# ------------------------------------------- ops and exported programs

def _op_cases(device):
    """Each op of the `ggnn_tpu_torch` namespace with inputs at H = 100:
    the serving envelope's lane for the segment sums and edge_dot, the
    per-edge [T, E] for B3."""
    batch = _envelope_batch()
    src, offsets = _lane(batch, device)
    num_segments = offsets.shape[0] - 1
    gen = torch.Generator(device=device).manual_seed(5)
    h = torch.randn(num_segments, 100, generator=gen, device=device)
    w = torch.rand(src.shape[0], generator=gen, device=device)
    tgt = torch.from_numpy(batch.edge_targets_all).to(device)
    per_edge = torch.from_numpy(batch.edge_sources).to(device)
    ops = torch.ops.ggnn_tpu_torch
    return {
        "gather_segment_sum": (ops.gather_segment_sum.default,
                               (h, src, offsets, num_segments)),
        "segment_scatter_sum": (ops.segment_scatter_sum.default,
                                (h, src, offsets, num_segments)),
        "weighted_gather_segment_sum": (
            ops.weighted_gather_segment_sum.default,
            (h, src, w, offsets, num_segments)),
        "weighted_segment_scatter_sum": (
            ops.weighted_segment_scatter_sum.default,
            (h, src, w, offsets, num_segments)),
        "gather_rows": (ops.gather_rows.default,
                        (h[:2048].contiguous(), per_edge, 8, False)),
        "edge_dot": (ops.edge_dot.default, (h, src, h, tgt)),
    }


OP_NAMES = ("gather_segment_sum", "segment_scatter_sum",
            "weighted_gather_segment_sum", "weighted_segment_scatter_sum",
            "gather_rows", "edge_dot")


@pytest.mark.parametrize("name", OP_NAMES)
def test_opcheck_on_the_card(cuda, name):
    """`torch.library.opcheck` of each op on CUDA tensors, its output
    against the same op on the CPU (the plain version) at 1e-5, and one
    launch counted a call."""
    op, args = _op_cases(cuda)[name]
    result = torch.library.opcheck(op, args)
    assert set(result.values()) == {"SUCCESS"}, result
    before = _launch_counts() + (edge_dot.launches,)
    got = op(*args)
    torch.cuda.synchronize()
    after = _launch_counts() + (edge_dot.launches,)
    assert sum(after) - sum(before) == 1
    want = op(*(a.cpu() if isinstance(a, torch.Tensor) else a
                for a in args))
    torch.testing.assert_close(got.cpu(), want, **TOL)


def test_exported_sparse_forward_launches_b1_on_the_card(cuda, tmp_path):
    """A default sparse model exported on the CPU serves on the card: its
    program replayed as a CUDA graph that holds B1 once a propagation
    step and nothing else, the kernels launched by the first request's
    warm-up and capture alone (a replay counts none); answers equal to
    the live card Predictor's (1e-6) and to the CPU's (1e-4)."""
    from ggnn_tpu_torch.data.loader import DatasetMeta
    from ggnn_tpu_torch.export import export_predictor, load_predictor
    from ggnn_tpu_torch.serving import Predictor
    from ggnn_tpu_torch.training.checkpoint import save_checkpoint

    config = default_params_for("sparse")
    gen = torch.Generator().manual_seed(0)
    params = ModelParams(SparseGGNN(config, 4, gen),
                         init_output_heads(gen, 100, config["task_ids"]))
    ckpt = str(tmp_path / "sparse.pickle")
    save_checkpoint(ckpt, config, params, 0, 0)
    cpu = Predictor.from_checkpoint(ckpt, "sparse", device="cpu")
    path = str(tmp_path / "sparse.ggnnx")
    export_predictor(cpu, path)
    live = Predictor.from_checkpoint(ckpt, "sparse")
    exported = load_predictor(path)
    assert exported.device.type == "cuda"
    request = synthetic_molecules(40, seed=31)
    steps = sum(config["layer_timesteps"])
    # The envelope is one shape: the first request captures its graph.
    wants = ([2 * steps, 0, 0, 0, 0, 0], [0] * 6)
    for batch_request, want in zip((request, request[:1]), wants):
        before = _launch_counts() + (edge_dot.launches,)
        got = exported(batch_request)
        torch.cuda.synchronize()
        counts = [a - b for a, b in
                  zip(_launch_counts() + (edge_dot.launches,), before)]
        assert counts == want
        np.testing.assert_allclose(got, live(batch_request), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(got, cpu(batch_request), rtol=1e-4,
                                   atol=1e-4)
    (graph,) = exported._graphs.graphs.values()
    # The GRU's K1 and K2 once a propagation step each.
    assert graph.launches == {"ell_spmm.launches": steps,
                              "gru.launches": 2 * steps}


# ------------------------------------------------ bf16 instances (A16)
#
# `compute_dtype: bfloat16`: each kernel's bf16 instance against its
# plain version (bf16 rows widened to f32, summed in f32, rounded once).
# Tolerance: one bf16 ulp of each output element (two f32 sums of the
# same terms in another order round to the same or a neighbouring bf16
# value), or 1e-5 of the output's largest magnitude where a sum cancels
# to near 0; 0 on rows of eighths and for the gather, a copy. H = 512
# takes the 8-value (16-byte) path, H = 100 the 4-value (8-byte) path,
# H = 37 and a view one value into its buffer the scalar path.

BF16_SHAPES = [(512, True, 8), (100, True, 4), (37, True, 1),
               (100, False, 1)]


def _bf16_rows(rows, h_dim, device, aligned=True, seed=0, eighths=False):
    gen = torch.Generator(device=device).manual_seed(seed)
    if eighths:
        flat = torch.randint(-16, 17, (rows * h_dim + 1,), generator=gen,
                             device=device).float() / 8
    else:
        flat = torch.randn(rows * h_dim + 1, generator=gen, device=device)
    flat = flat.to(torch.bfloat16)
    return (flat[:-1] if aligned else flat[1:]).view(rows, h_dim)


def _assert_within_a_bf16_ulp(got, want):
    assert got.dtype == want.dtype == torch.bfloat16
    got, want = got.float(), want.float()
    spacing = torch.exp2(torch.floor(torch.log2(
        want.abs().clamp_min(2.0 ** -126))) - 7)
    bound = torch.maximum(spacing, 1e-5 * want.abs().max())
    assert bool(((got - want).abs() <= bound).all()), \
        float(((got - want).abs() / bound).max())


def _bf16_segment_call(name, x, idx, offsets, num_segments, weights):
    kernel = getattr(ell_spmm, name)
    plain = getattr(ell_spmm, name + "_reference", None)
    if name.startswith("weighted"):
        plain = ell_spmm.weighted_gather_segment_sum_reference
        return (kernel(x, idx, weights, offsets, num_segments),
                plain(x, idx, weights, offsets, num_segments))
    return (kernel(x, idx, offsets, num_segments),
            plain(x, idx, offsets, num_segments))


BF16_SEGMENT_KERNELS = KERNELS + W_KERNELS


@pytest.mark.parametrize("h_dim,aligned,elems", BF16_SHAPES)
@pytest.mark.parametrize("name", BF16_SEGMENT_KERNELS)
def test_bf16_segment_kernels_match_plain(cuda, name, h_dim, aligned, elems):
    """B1, B2, the weighted instance and its transpose on bf16 rows of
    the serving envelope's lane: one launch each, the vector path the
    width gives, a bf16 output within a bf16 ulp of the plain version,
    the same bits from two calls."""
    batch = _envelope_batch()
    n_cap = batch.node_capacity
    src, offsets = _lane(batch, cuda)
    x = _bf16_rows(n_cap, h_dim, cuda, aligned, seed=h_dim)
    gen = torch.Generator(device=cuda).manual_seed(1)
    weights = torch.rand(src.shape[0], generator=gen,
                         device=cuda).to(torch.bfloat16)
    before = sum(_launch_counts())
    got, want = _bf16_segment_call(name, x, src, offsets, n_cap * 4,
                                   weights)
    again, _ = _bf16_segment_call(name, x, src, offsets, n_cap * 4, weights)
    torch.cuda.synchronize()
    assert sum(_launch_counts()) == before + 2
    assert ell_spmm.vector_elems(x, got) == elems
    _assert_within_a_bf16_ulp(got, want)
    assert torch.equal(got, again)


@pytest.mark.parametrize("h_dim,aligned,elems", BF16_SHAPES)
@pytest.mark.parametrize("name", BF16_SEGMENT_KERNELS)
def test_bf16_segment_kernels_sum_eighths_exactly(cuda, name, h_dim, aligned,
                                                  elems):
    """Rows and weights of eighths (every f32 sum exact), over segments
    around the split, a 5,000-edge hub and empty segments, ids outside
    [off[0], off[S]) poisoned: the kernel equals its plain version bit
    for bit."""
    rng = np.random.default_rng(h_dim)
    c = ell_spmm.split_edges()
    counts = [0, 1, c - 1, c, c + 1, 2 * c + 1, 5000, 0, 3]
    idx, clean, offsets = _csr(rng, counts, 600, cuda, before=5, after=7)
    x = _bf16_rows(600, h_dim, cuda, aligned, seed=h_dim, eighths=True)
    weights = (torch.from_numpy(rng.integers(-8, 9, idx.shape[0]).astype(
        np.float32) / 8).to(cuda).to(torch.bfloat16))
    got, _ = _bf16_segment_call(name, x, idx, offsets, len(counts), weights)
    _, want = _bf16_segment_call(name, x, clean, offsets, len(counts),
                                 weights)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("h_dim,aligned,elems", BF16_SHAPES)
def test_bf16_edge_dot_matches_plain(cuda, h_dim, aligned, elems):
    """edge_dot of bf16 rows: f32 dots of exact products, within 1e-5 of
    the plain version (f32 sums in another order), pads 0."""
    batch = _envelope_batch()
    (src, _, tgt), _ = _pairs(batch, cuda)
    h = _bf16_rows(batch.node_capacity, h_dim, cuda, aligned, seed=3)
    got = edge_dot.edge_dot(h, src, h, tgt)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    assert edge_dot.vector_elems(h, h) == elems
    want = edge_dot.edge_dot_reference(h, src, h, tgt)
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))
    assert torch.equal(got, edge_dot.edge_dot(h, src, h, tgt))


@pytest.mark.parametrize("unroll", [1, 4, 8])
@pytest.mark.parametrize("h_dim,aligned,elems", BF16_SHAPES)
def test_bf16_gather_rows_equals_plain(cuda, h_dim, aligned, elems, unroll):
    h = _bf16_rows(2000, h_dim, cuda, aligned, seed=4)
    gen = torch.Generator(device=cuda).manual_seed(5)
    src = torch.randint(0, 2000, (33, 16), generator=gen, device=cuda,
                        dtype=torch.int32)
    got = gather_floor.gather_rows(h, src, unroll)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    assert gather_floor.vector_elems(h, got) == elems
    assert torch.equal(got, gather_floor.gather_rows_reference(h, src))


def test_bf16_registers_are_reported_and_within_the_bound(cuda):
    """Every bf16 instance of the segment kernels keeps to the 64
    registers a thread that `__launch_bounds__` allows; edge_dot's and
    B3's bf16 instances report theirs."""
    for elems in (8, 4, False):
        for weighted in (False, True):
            regs = ell_spmm.registers(elems, cuda, weighted=weighted,
                                      dtype=torch.bfloat16)
            assert 0 < regs <= 64, (elems, weighted, regs)
        assert 0 < edge_dot.registers(elems, cuda,
                                      dtype=torch.bfloat16) <= 255
        assert 0 < gather_floor.registers(8, elems, False, cuda,
                                          dtype=torch.bfloat16) <= 255


def test_bf16_product_on_the_card_matches_cpu(cuda):
    """matmul_f32 of bf16 inputs on cuBLAS (f32 out) against the CPU's f32
    product of the widened inputs, forward and the gradients (bf16 in
    each input's dtype): 1e-5 of the largest magnitude."""
    from ggnn_tpu_torch.ops.precision import matmul_f32
    gen = torch.Generator().manual_seed(6)
    a = torch.randn(3, 200, 96, generator=gen).to(torch.bfloat16)
    b = torch.randn(3, 96, 64, generator=gen).to(torch.bfloat16)
    g = torch.randn(3, 200, 64, generator=gen)
    results = []
    for device in ("cpu", cuda):
        la = a.detach().to(device).requires_grad_(True)
        lb = b.detach().to(device).requires_grad_(True)
        out = matmul_f32(la, lb)
        out.backward(g.to(device))
        results.append([t.cpu() for t in (out, la.grad, lb.grad)])
    for got, want in zip(results[1], results[0]):
        assert got.dtype == want.dtype
        scale = float(want.float().abs().max())
        torch.testing.assert_close(got.float(), want.float(), rtol=0,
                                   atol=max(1e-5 * scale,
                                            2.0 ** -7 * scale
                                            if got.dtype == torch.bfloat16
                                            else 0))


@pytest.mark.parametrize("name", OP_NAMES + ("product_f32",))
def test_opcheck_on_the_card_in_bf16(cuda, name):
    """`torch.library.opcheck` of each op on bf16 CUDA tensors (the
    weights too; the product's inputs [M, K] x [K, N]), the output's
    dtype that of the fake registration."""
    if name == "product_f32":
        gen = torch.Generator(device=cuda).manual_seed(7)
        a = torch.randn(64, 96, generator=gen, device=cuda)
        op, args = torch.ops.ggnn_tpu_torch.product_f32.default, (
            a.to(torch.bfloat16), a.t().contiguous().to(torch.bfloat16))
    else:
        op, args = _op_cases(cuda)[name]
        args = tuple(a.to(torch.bfloat16) if isinstance(a, torch.Tensor)
                     and a.is_floating_point() else a for a in args)
    result = torch.library.opcheck(op, args)
    assert set(result.values()) == {"SUCCESS"}, result
    got = op(*args)
    want_dtype = (torch.float32 if name in ("edge_dot", "product_f32")
                  else torch.bfloat16)
    assert got.dtype == want_dtype


@pytest.mark.parametrize("attention", [False, True])
@pytest.mark.parametrize("route", ["combined", "per-type", "per-edge"])
def test_bf16_sparse_ggnn_on_the_card_matches_cpu(cuda, route, attention):
    """A bf16 sparse model (hidden 512, the width of
    configs/sparse_wide_bf16.json) served and differentiated on the card
    against the CPU: states within 2e-2 (bf16 roundings of sums taken in
    another order compound over 4 steps; JAX pins 0.05 for bf16 against
    f32), every gradient within a relative L2 error of 2e-2; the kernels
    the route launches."""
    overrides = {**ROUTES[route], "use_propagation_attention": attention,
                 "use_edge_bias": True, "hidden_size": 512,
                 "layer_timesteps": [2, 1, 1], "compute_dtype": "bfloat16",
                 "residual_connections": {"2": [0]}}
    config = resolve_config("sparse", config_json=json.dumps(overrides))
    gen = torch.Generator().manual_seed(0)
    params = ModelParams(SparseGGNN(config, 4, gen),
                         init_output_heads(gen, 512, [0]))
    caps = packing.PackCapacities(nodes=512, edges_per_type=4096,
                                  graphs=64, edges_all=4096)
    proc = packing.preprocess_sparse(synthetic_molecules(40, 23), 4, True,
                                     [0], {}, False)
    batch = next(packing.pack_sparse_batches(proc, 4, caps.nodes + 1, caps,
                                             512, 5, False, None))
    cpu_out = params.graph(batch.to("cpu"))
    torch.tanh(cpu_out).sum().backward()
    want = {n: p.grad.clone() for n, p in params.named_parameters()
            if p.grad is not None}
    params.zero_grad()
    params.to(cuda)
    steps = sum(config["layer_timesteps"])
    before, dots = _launch_counts(), edge_dot.launches
    with torch.no_grad():
        served = params.graph(batch.to(cuda))
    torch.cuda.synchronize()
    counts = [a - b for a, b in zip(_launch_counts(), before)]
    weighted = attention and route != "per-edge"
    assert counts == [0 if weighted else steps, 0,
                      steps if route == "per-edge" else 0,
                      steps if weighted else 0, 0]
    assert edge_dot.launches - dots == (steps if attention else 0)
    assert served.dtype == torch.float32
    torch.testing.assert_close(served.cpu(), cpu_out.detach(), rtol=0,
                               atol=2e-2)
    out = params.graph(batch.to(cuda))
    torch.tanh(out).sum().backward()
    for name, g in want.items():
        got = dict(params.named_parameters())[name].grad.cpu()
        rel = float((got - g).norm() / g.norm().clamp_min(1e-30))
        assert rel <= 2e-2, (name, rel)


# ------------------------------------- weighted instance and edge_dot cases
#
# Edge cases of the two port-only kernels: rows and weights of eighths, so
# the weighted instance must equal its plain version bit for bit in any
# summation order (f32 at H 1, 37, 100 and 512, a view one value into its
# buffer, bf16 at H 100, the 8-byte path, and 512), and edge_dot on lanes
# whose b repeats, alternates, is all pads, or repeats across the lanes of
# more than one warp.

WEIGHTED_EDGE_SHAPES = [(1, True, torch.float32), (37, True, torch.float32),
                        (100, True, torch.float32),
                        (100, False, torch.float32),
                        (512, True, torch.float32),
                        (100, True, torch.bfloat16),
                        (512, True, torch.bfloat16)]


def _eighth_rows(rng, rows, h_dim, device, aligned, dtype):
    return _eighths(rng, rows, h_dim, device, aligned).to(dtype)


@pytest.mark.parametrize("h_dim,aligned,dtype", WEIGHTED_EDGE_SHAPES)
@pytest.mark.parametrize("layout", ["zero edges", "all segments empty",
                                    "hub of more than kGroup pieces"])
@pytest.mark.parametrize("name", W_KERNELS)
def test_weighted_kernel_edge_cases_sum_exactly(cuda, name, layout, h_dim,
                                                aligned, dtype):
    """No edge at all (an index array without storage), segments that
    are all empty, and a 5,000-edge hub (313 pieces of 16 edges, more
    than the 16 pieces one warp adds before the groups are added) among
    short segments: each call equals the plain version bit for bit and
    counts one launch."""
    rng = np.random.default_rng(h_dim + len(layout))
    if layout == "zero edges":
        counts, after = [0] * 70, 0
    elif layout == "all segments empty":
        counts, after = [0] * 1000, 9
    else:
        counts, after = [0] * 500 + [5000] + [2] * 300 + [0] * 200, 9
    rows = 600
    x = _eighth_rows(rng, rows, h_dim, cuda, aligned, dtype)
    idx, clean, offsets = _csr(rng, counts, rows, cuda, after=after)
    w = _eighth_weights(rng, idx.shape[0], cuda).to(dtype)
    before = _launch_counts()
    got = getattr(ell_spmm, name)(x, idx, w, offsets, len(counts))
    torch.cuda.synchronize()
    counter = 3 if name == W_KERNELS[0] else 4
    assert [a - b for a, b in zip(_launch_counts(), before)] == [
        int(i == counter) for i in range(5)]
    want = ell_spmm.weighted_gather_segment_sum_reference(
        x, clean, w, offsets, len(counts))
    assert got.dtype == dtype and torch.equal(got, want)
    assert not got[torch.from_numpy(np.asarray(counts) == 0).to(cuda)].any()


@pytest.mark.parametrize("name", W_KERNELS)
def test_weighted_kernel_on_the_skewed_lane_sums_exactly(cuda, name):
    """The 160,000-edge lane of skewed in-degrees (targets Zipf 1.1 over
    20,000 nodes, the top node thousands of edges, cut over hundreds of
    warps), forward by target and over its transpose by source, rows and
    weights of eighths: equal to the plain version bit for bit, and two
    calls give the same bits."""
    rng = np.random.default_rng(27)
    n, e = 20000, 160000
    zipf = 1.0 / np.arange(1, n + 1) ** 1.1
    tgt = rng.permutation(n)[rng.choice(n, e, p=zipf / zipf.sum())]
    src = rng.integers(0, n, e)
    order = np.argsort(tgt, kind="stable")
    src, tgt = (torch.from_numpy(a[order].astype(np.int32)).to(cuda)
                for a in (src, tgt))
    w = _eighth_weights(rng, e, cuda)
    x = _eighths(rng, n, 100, cuda)
    if name == W_KERNELS[0]:
        args = (src, w, segment_offsets(tgt, n))
    else:
        args = ell_spmm.weighted_transpose_layout(src, tgt, w, n)
    kernel = getattr(ell_spmm, name)
    got = kernel(x, *args, n)
    again = kernel(x, *args, n)
    torch.cuda.synchronize()
    want = ell_spmm.weighted_gather_segment_sum_reference(x, *args, n)
    assert torch.equal(got, want) and torch.equal(got, again)


def _edge_dot_lane(pattern, device, rows=300, edges=200):
    """(a, b) int32 on `device` of `edges` pairs: a random, b as the
    pattern makes it (pads are b = rows)."""
    rng = np.random.default_rng(len(pattern))
    a = rng.integers(0, rows, edges)
    if pattern == "one repeated b":
        b = np.full(edges, 17)
    elif pattern == "alternating b":
        b = np.where(np.arange(edges) % 2 == 0, 5, 211)
    elif pattern == "all pads":
        b = np.full(edges, rows)
    else:   # runs of 45 equal b, each crossing 32-edge boundaries
        b = np.sort(rng.integers(0, rows, edges // 45 + 1)).repeat(45)[:edges]
    return tuple(torch.from_numpy(v.astype(np.int32)).to(device)
                 for v in (a, b))


@pytest.mark.parametrize("h_dim,aligned,dtype", [
    (100, True, torch.float32), (37, True, torch.float32),
    (100, False, torch.float32), (512, True, torch.bfloat16)])
@pytest.mark.parametrize("pattern", ["one repeated b", "alternating b",
                                     "all pads", "runs crossing warps"])
def test_edge_dot_on_repeated_alternating_and_pad_lanes(cuda, pattern,
                                                        h_dim, aligned,
                                                        dtype):
    """edge_dot where b repeats along the lane, alternates, is a pad on
    every pair, or repeats in runs longer than a warp's share of the
    lane: within 1e-5 of the dots' magnitude of the plain version (f32
    sums in another order), pads 0, one launch a call and two calls with
    the same bits."""
    rows = 300
    gen = torch.Generator(device=cuda).manual_seed(h_dim)
    flat = torch.randn(rows * h_dim + 1, generator=gen, device=cuda)
    x = (flat[:-1] if aligned else flat[1:]).view(rows, h_dim).to(dtype)
    y = torch.randn(rows, h_dim, generator=gen, device=cuda).to(dtype)
    a, b = _edge_dot_lane(pattern, cuda, rows)
    before = edge_dot.launches
    got = edge_dot.edge_dot(x, a, y, b)
    again = edge_dot.edge_dot(x, a, y, b)
    torch.cuda.synchronize()
    assert edge_dot.launches - before == 2
    assert torch.equal(got, again) and got.dtype == torch.float32
    want = edge_dot.edge_dot_reference(x, a, y, b)
    scale = max(float(want.abs().max()), 1.0)
    assert float((got - want).abs().max()) <= 1e-5 * scale
    assert not got[b >= rows].any()


# ------------------------------------------------ train_on_device (A18)

NO_DROPOUT = {"edge_weight_dropout_keep_prob": 1.0,
              "graph_state_dropout_keep_prob": 1.0,
              "out_layer_dropout_keep_prob": 1.0}
# Small cards of each captured path: sparse at 2,000-node batches, gcn
# at its default, async at 2,000-node batches.
GRAPH_CASES = {"sparse": {"batch_size": 2000},
               "gcn": {"batch_size": 2000},
               "async": ASYNC_SMALL}


def _twin_runners(variant, overrides, tmp_path):
    """Two Runners on the card, same config and seed: the same weights,
    numpy stream and dropout stream."""
    config = resolve_config(variant, config_json=json.dumps(overrides))
    train = synthetic_molecules(240, seed=7)
    valid = synthetic_molecules(20, seed=8)
    return [Runner(variant, dict(config), train_data=train,
                   valid_data=valid, log_dir=str(tmp_path / name),
                   quiet=True, tensorboard=False, device="cuda")
            for name in ("graph", "eager")]


def _eager_epochs(runner, epochs):
    """`train_on_device`'s steps run eagerly: one pack, JAX's groups, in
    order; returns the last loss."""
    from ggnn_tpu_torch.utils.timing import shape_groups
    batches = list(runner.adapter.batches(runner.train_processed, True,
                                          runner.np_rng))
    steps = [b.to(runner.device) for g in shape_groups(batches) for b in g]
    for _ in range(epochs):
        for batch in steps:
            loss, _ = runner.train_step(batch)
    runner.train_step_id += epochs * len(steps)
    return float(loss)


@pytest.mark.parametrize("variant", sorted(GRAPH_CASES))
def test_train_on_device_replays_equal_eager_steps(cuda, variant, tmp_path):
    """Two epochs replayed as CUDA graphs against the same steps run
    eagerly on the card: loss at rtol 1e-5 and every parameter within
    1e-5 (the readout's index_add_ atomics sum in another order); the
    same count of updates; the graphs hold the step's kernel launches,
    and replays launch none eagerly."""
    from ggnn_tpu_torch.ops.kernels import launch_counts
    graph, eager = _twin_runners(variant,
                                 {**GRAPH_CASES[variant], **NO_DROPOUT},
                                 tmp_path)
    before = launch_counts()
    loss = graph.train_on_device(2)
    torch.cuda.synchronize()
    during = {k: v - before[k] for k, v in launch_counts().items()}
    want = _eager_epochs(eager, 2)
    torch.cuda.synchronize()
    assert graph.optimizer.count == eager.optimizer.count == \
        graph.train_step_id == eager.train_step_id
    assert loss == pytest.approx(want, rel=1e-5)
    wants = dict(eager.params.named_parameters())
    for name, p in graph.params.named_parameters():
        torch.testing.assert_close(p, wants[name], rtol=0, atol=1e-5)
    kernel = {"sparse": "ell_spmm.launches", "async": "ell_spmm.launches",
              "gcn": "ell_spmm.weighted_launches"}[variant]
    assert all(step.get(kernel, 0) > 0 for step in graph.replay_launches)
    # Every launch of the call was a warm-up step's or a capture's.
    graphs = graph._epochs_fn.graphs.values()
    assert during == {k: 2 * sum(g.launches.get(k, 0) for g in graphs)
                      for k in during}


def test_graph_keeps_its_scratch_across_a_larger_capture(cuda):
    """A graph over B1 with a hub (a cut segment: tickets and partials),
    then a larger hub captured on the same side stream, which grows the
    scratch, then the first graph replayed on new rows: each output
    equal to the plain version (integer rows: exact sums)."""
    from ggnn_tpu_torch.utils.timing import make_epochs_fn
    result = torch.zeros(2, 100, device=cuda)

    def hub(edges, seed):
        gen = torch.Generator(device=cuda).manual_seed(seed)
        h = torch.randint(-4, 5, (64, 100), generator=gen, device=cuda,
                          dtype=torch.float32)
        src = torch.randint(0, 64, (edges,), generator=gen, device=cuda,
                            dtype=torch.int32)
        off = torch.tensor([0, edges, edges], dtype=torch.int32,
                           device=cuda)
        return (h, src, off)

    def step(batch):
        out = ell_spmm.gather_segment_sum(*batch, 2)
        result.copy_(out)
        return out.sum()

    epochs_fn = make_epochs_fn(step, state=[result])
    for batch in (hub(2000, 0), hub(400_000, 1), hub(2000, 2)):
        epochs_fn([[batch]], 1)
        torch.cuda.synchronize()
        torch.testing.assert_close(
            result, ell_spmm.gather_segment_sum_reference(*batch, 2),
            rtol=0, atol=0)
    assert len(epochs_fn.graphs) == 2


def test_a_step_that_synchronises_raises_and_trains_nothing(cuda):
    """A step the capture cannot hold raises, naming where, and leaves
    the state as it was: a host read in the warm-up, a device
    synchronisation in the capture itself."""
    from ggnn_tpu_torch.utils.timing import make_epochs_fn
    total = torch.zeros((), device=cuda)
    calls = []

    def reads(batch):
        total.add_(batch.sum())
        return total * float(batch[0])

    def syncs_in_capture(batch):
        calls.append(1)
        total.add_(batch.sum())
        if len(calls) > 1:   # past the warm-up step: the capture
            torch.cuda.synchronize()
        return total.clone()

    batch = torch.ones(4, device=cuda)
    with pytest.raises(RuntimeError, match="warm-up.*aten"):
        make_epochs_fn(reads, state=[total])([[batch]], 3)
    assert float(total) == 0.0
    with pytest.raises(RuntimeError, match="capture"):
        make_epochs_fn(syncs_in_capture, state=[total])([[batch]], 3)
    torch.cuda.synchronize()
    assert float(total) == 0.0 and len(calls) == 2


def test_no_collection_inside_a_capture_frees_an_earlier_graph(cuda):
    """Garbage collection is held off while a step is captured: a
    collection there could free an unreachable earlier graph, and
    destroying a graph while the thread captures ends the capture. The
    step drops the last reference to an earlier cache's graph at its
    capture, with a collection due at every allocation."""
    import gc
    from ggnn_tpu_torch.utils.timing import StepCache
    x = torch.ones(8, device=cuda)
    earlier = StepCache(lambda batch: batch + 1, cuda)
    earlier(x)
    held = {"earlier": earlier}
    del earlier
    calls, enabled = [], []

    def step(batch):
        calls.append(1)
        enabled.append(gc.isenabled())
        if len(calls) == 2:           # the capture, after the warm-up
            cycle = [held.pop("earlier")]
            cycle.append(cycle)
            del cycle
            [[] for _ in range(100)]
        return batch * 2

    thresholds = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        out = StepCache(step, cuda)(x)
    finally:
        gc.set_threshold(*thresholds)
    assert enabled == [True, False] and gc.isenabled()
    assert torch.equal(out, x * 2)
    gc.collect()


def test_replays_draw_fresh_dropout_masks_from_the_generator(cuda):
    """A registered generator gives each replay new draws, the draws an
    eager step would make from the same state; after the replays the
    generator continues the same stream eagerly."""
    from ggnn_tpu_torch.utils.timing import make_epochs_fn
    gen = torch.Generator(device=cuda).manual_seed(5)
    mask = torch.zeros(1000, device=cuda)

    def step(batch):
        mask.copy_(torch.rand(1000, generator=gen, device=cuda) < batch)
        return mask.sum()

    epochs_fn = make_epochs_fn(step, state=[mask], generators=[gen])
    batch = torch.full((1000,), 0.8, device=cuda)
    replays = []
    for _ in range(3):
        epochs_fn([[batch]], 1)
        replays.append(mask.clone())
    after = torch.rand(8, generator=gen, device=cuda)
    twin = torch.Generator(device=cuda).manual_seed(5)
    for got in replays:
        want = torch.rand(1000, generator=twin, device=cuda) < 0.8
        torch.testing.assert_close(got, want.float(), rtol=0, atol=0)
    assert not torch.equal(replays[0], replays[1])
    torch.testing.assert_close(after, torch.rand(8, generator=twin,
                                                 device=cuda))


def test_dense_dropout_replays_match_eager_steps(cuda, tmp_path):
    """`dense` with edge weights kept at 0.8 (the `sparse` and `blocked`
    default; `dense`'s own is 1.0): graphs and eager steps from one seed
    draw the same masks, so the parameters agree within 1e-5; a later
    eager step on each Runner draws the same stream."""
    graph, eager = _twin_runners(
        "dense", {"batch_size": 16, "edge_weight_dropout_keep_prob": 0.8},
        tmp_path)
    graph.train_on_device(1)
    _eager_epochs(eager, 1)
    batch = next(iter(graph.adapter.batches(graph.train_processed, False)))
    for runner in (graph, eager):
        runner.train_step(batch.to(runner.device))
    wants = dict(eager.params.named_parameters())
    for name, p in graph.params.named_parameters():
        torch.testing.assert_close(p, wants[name], rtol=0, atol=1e-5)


def test_train_on_device_spans_a_capture_once_a_key_and_a_replay_a_step(
        cuda, tmp_path):
    """With the port's spans on (utils/spans.py), `train_on_device(2)` of
    `dense` (several bucket shapes, so several keys) records one
    `ggnn.epochs` with its key walk, one `ggnn.capture` holding a warm-up
    and a graph a key, and a `ggnn.replay` with its input copy a step;
    the next call captures nothing and replays each step once."""
    from ggnn_tpu_torch.utils import spans
    config = resolve_config("dense", config_json=json.dumps(
        {"batch_size": 16}))
    runner = Runner("dense", dict(config),
                    train_data=synthetic_molecules(240, seed=7),
                    valid_data=synthetic_molecules(20, seed=8),
                    log_dir=str(tmp_path), quiet=True, tensorboard=False,
                    device="cuda")
    spans.drain()
    were_on = spans.on(True)
    try:
        runner.train_on_device(2)
        first, counters = spans.drain()
        runner.train_on_device(1)
        second, _ = spans.drain()
    finally:
        spans.on(were_on)
        spans.drain()
    keys = len(runner.train_graphs.graphs)
    steps = len(runner.replay_launches)
    assert keys > 1 and counters == {"spans_dropped": 0}
    names = collections.Counter(r.name for r in first)
    assert names["ggnn.epochs"] == names["ggnn.epochs.keys"] == 1
    assert names["ggnn.capture"] == 1
    assert names["ggnn.capture.warm"] == names["ggnn.capture.graph"] == keys
    assert names["ggnn.replay"] == names["ggnn.replay.fill"] == 2 * steps
    (epochs,) = [r for r in first if r.name == "ggnn.epochs"]
    (capture,) = [r for r in first if r.name == "ggnn.capture"]
    assert capture.parent == epochs.id
    assert all(r.parent == capture.id for r in first
               if r.name in ("ggnn.capture.warm", "ggnn.capture.graph"))
    assert all(r.parent == epochs.id for r in first
               if r.name == "ggnn.replay")
    names = collections.Counter(r.name for r in second)
    assert "ggnn.capture" not in names
    assert names["ggnn.replay"] == steps


# ------------------------------------------ replayed steps (A20)

def _recorded_train(runner):
    """`runner.train()`, returning every per-step (split, loss, MAE) its
    epochs report and the train graphs after each training epoch."""
    seen, counts = [], []
    runner.summaries.add_batch = (
        lambda split, step, loss, accs, tasks:
        seen.append((split, loss, np.asarray(accs).copy())))
    run_epoch = runner.run_epoch

    def counted(name, processed, is_training):
        out = run_epoch(name, processed, is_training)
        if is_training:
            counts.append(runner.graph_counts()["train"])
        return out

    runner.run_epoch = counted
    runner.train()
    return seen, counts


def _eager_train(runner, epochs):
    """`train()`'s steps driven eagerly, each epoch's training batches
    then its validation batches: (split, loss, MAE) a step."""
    seen = []
    for _ in range(epochs):
        for split, processed, step, rng in (
                ("train", runner.train_processed, runner.train_step,
                 runner.np_rng),
                ("validation", runner.valid_processed, runner.eval_step,
                 None)):
            for batch in runner.adapter.batches(processed, rng is not None,
                                                rng):
                loss, accs = step(batch.to(runner.device))
                seen.append((split, float(loss), accs.cpu().numpy()))
    return seen


@pytest.mark.parametrize("variant", sorted(GRAPH_CASES))
def test_replayed_train_equals_its_eager_twin(cuda, variant, tmp_path):
    """Two epochs of `Runner.train()` (dropout on, a rolling checkpoint
    every 2 steps), every train and validation step a replay, against a
    twin driving `train_step` and `eval_step` eagerly over the same
    batches: every per-step loss and MAE and every parameter bit-equal;
    the train graphs all captured in epoch 1; a run resumed from the
    last rolling checkpoint ends bit-equal too."""
    from ggnn_tpu_torch.training.checkpoint import load_iterator_state
    overrides = {**GRAPH_CASES[variant], "num_epochs": 2}
    graph, eager = _twin_runners(variant, overrides, tmp_path)
    graph.checkpoint_every_steps = 2
    seen, counts = _recorded_train(graph)
    want = _eager_train(eager, 2)
    assert len(seen) == len(want) > 4
    for (split, loss, accs), (w_split, w_loss, w_accs) in zip(seen, want):
        assert split == w_split and loss == w_loss
        np.testing.assert_array_equal(accs, w_accs)
    wants = dict(eager.params.named_parameters())
    for name, p in graph.params.named_parameters():
        assert torch.equal(p, wants[name]), name
    assert counts[0] == counts[1] >= 1
    assert graph.graph_counts()["validation"] >= 1
    state = load_iterator_state(graph.last_model_file)
    assert state["epoch"] == 2 and state["steps_done"] > 0
    resumed = Runner(variant, dict(graph.config),
                     train_data=synthetic_molecules(240, seed=7),
                     valid_data=synthetic_molecules(20, seed=8),
                     log_dir=str(tmp_path / "resumed"), quiet=True,
                     tensorboard=False, device="cuda",
                     restore=graph.last_model_file)
    resumed.train()
    for name, p in resumed.params.named_parameters():
        assert torch.equal(p, dict(graph.params.named_parameters())[name])


@pytest.mark.parametrize("variant", ["sparse", "dense", "gcn", "async"])
def test_replayed_predictor_equals_serve_forward(cuda, variant):
    """The Predictor replays one graph a batch shape: 1- and 300-graph
    answers bit-equal to `serve_forward` run eagerly, and 16 threads
    calling it at once answered as serial calls are; its artifact's
    replays bit-equal to the artifact's program run eagerly."""
    from ggnn_tpu_torch.data.loader import DatasetMeta
    from ggnn_tpu_torch.export import export_predictor, load_predictor
    from ggnn_tpu_torch.serving import Predictor
    from ggnn_tpu_torch.training.variants import make_adapter
    import threading

    config = default_params_for(variant)
    if variant == "async":
        config["propagation_substeps"] = 40
    meta = DatasetMeta(512, 1 if variant == "gcn" else 4, 5)
    gen = torch.Generator().manual_seed(0)
    params = ModelParams(
        make_adapter(variant, config, meta).build_model(gen),
        init_output_heads(gen, config["hidden_size"], config["task_ids"]))

    def eager_twin(predictor):
        predictor._forward = lambda batch: predictor._serve(
            batch.to(cuda)).cpu().numpy()
        return predictor

    replayed = Predictor(variant, config, meta, params, max_nodes=512,
                         max_graphs=64)
    eager = eager_twin(Predictor(variant, config, meta, params,
                                 max_nodes=512, max_graphs=64))
    requests = [synthetic_molecules(n, seed=40 + n) for n in (1, 300)]
    for request in requests:
        np.testing.assert_array_equal(replayed(request), eager(request))
    assert replayed.graph_count() >= 1
    small = [synthetic_molecules(n, seed=50 + n) for n in (1, 5, 9, 30) * 4]
    serial = [replayed(r) for r in small]
    got = [None] * len(small)
    barrier = threading.Barrier(len(small))

    def call(i):
        barrier.wait()
        got[i] = replayed(small[i])

    threads = [threading.Thread(target=call, args=(i,))
               for i in range(len(small))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for a, b in zip(got, serial):
        np.testing.assert_array_equal(a, b)

    cpu = Predictor(variant, config, meta, params, max_nodes=512,
                    max_graphs=64, device="cpu")
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        path = export_predictor(cpu, f"{tmp}/{variant}.ggnnx")
        artifact = load_predictor(path)
        artifact_eager = eager_twin(load_predictor(path))
    for request in requests:
        np.testing.assert_array_equal(artifact(request),
                                      artifact_eager(request))
    assert artifact.graph_count() == replayed.graph_count()


def test_a_failed_capture_raises_and_answers_nothing(cuda, tmp_path):
    """A step that reads a device value on the host cannot be captured:
    `run_epoch` and the Predictor raise at its warm-up, naming the
    operator, with no eager answer and the weights as they were."""
    from ggnn_tpu_torch.serving import Predictor
    graph, _ = _twin_runners("sparse", {"batch_size": 2000}, tmp_path)
    before = {n: p.detach().clone()
              for n, p in graph.params.named_parameters()}
    train_step = graph.train_step

    def reads(batch):
        loss, accs = train_step(batch)
        return loss * float(accs.sum()), accs

    graph.train_step = reads
    with pytest.raises(RuntimeError, match="warm-up of a train step.*aten"):
        graph.run_epoch("epoch", graph.train_processed, True)
    assert graph.graph_counts()["train"] == 0
    for name, p in graph.params.named_parameters():
        assert torch.equal(p, before[name]), name
    predictor = Predictor("sparse", graph.config, graph.meta, graph.params,
                          max_nodes=512, max_graphs=64)
    serve = predictor._serve
    predictor._serve = lambda batch: serve(batch) * float(
        batch.node_features.sum())
    with pytest.raises(RuntimeError, match="warm-up of a serving forward"):
        predictor(synthetic_molecules(3, seed=1))
    assert predictor.graph_count() == 0


# ------------------------------------------------- mesh (ROADMAP A11)

@pytest.fixture(scope="module")
def mesh_pool():
    """Two gloo ranks sharing the card (point-to-point sends copied
    through the host, which gloo needs for CUDA tensors)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    import os
    from ggnn_tpu_torch.parallel.launch import RankPool
    pool = RankPool(2, "gloo", timeout=600,
                    python_path=[os.path.dirname(__file__)])
    yield pool
    pool.close()


MESH_STEPS = {
    "sparse 2x1": ("sparse", {"batch_size": 2000}, 2, 1, "sparse",
                   "alltoall"),
    "sparse 1x2 alltoall": ("sparse", {"batch_size": 2000}, 1, 2, "sparse",
                            "alltoall"),
    "sparse 1x2 shift": ("sparse", {"batch_size": 2000}, 1, 2, "sparse",
                         "shift"),
    "sparse 1x2 ragged": ("sparse", {"batch_size": 2000}, 1, 2, "sparse",
                          "ragged"),
    "attention 1x2 ragged": ("sparse", {"batch_size": 2000,
                                        "use_propagation_attention": True,
                                        "use_edge_bias": True}, 1, 2,
                             "sparse", "ragged"),
    "type_tp 1x2": ("sparse", {"batch_size": 2000,
                               "use_propagation_attention": True}, 1, 2,
                    "sparse_tp", "alltoall"),
    "gcn 1x2": ("gcn", {"batch_size": 2000}, 1, 2, "gcn", "shift"),
    "gcn 2x1": ("gcn", {"batch_size": 2000}, 2, 1, "data_only", "alltoall"),
    "blocked 2x1": ("blocked", {"batch_size": 32,
                                "dense_bucket_sizes": [32]}, 2, 1, "dense",
                    "alltoall"),
    "async 2x1": ("async", {"num_nodes": 2000, "propagation_substeps": 40},
                  2, 1, "data_only", "alltoall"),
}


@pytest.mark.parametrize("label", sorted(MESH_STEPS))
def test_mesh_step_on_the_card_matches_single_device(cuda, mesh_pool,
                                                     label):
    """A 2-rank gloo step of each kind, both ranks on the card, against the
    single-device step over the same batches on the card: the loss at
    rtol 1e-5, every gradient leaf at rtol 2e-4 / atol 1e-6 (the bounds
    tests/test_parallel.py holds the JAX mesh to), the ranks' gradients
    equal."""
    import torch_mesh_ranks as ranks
    from ggnn_tpu_torch.data.loader import infer_metadata
    from ggnn_tpu_torch.training.variants import make_adapter
    variant, over, n_data, n_edge, kind, exchange = MESH_STEPS[label]
    config = resolve_config(variant, config_json=json.dumps({
        "hidden_size": 32, "edge_weight_dropout_keep_prob": 1.0,
        "graph_state_dropout_keep_prob": 1.0,
        "out_layer_dropout_keep_prob": 1.0, **over}))
    data = synthetic_molecules(400, seed=3)
    meta = infer_metadata([data], config["tie_fwd_bkwd"])
    adapter = make_adapter(variant, config, meta)
    processed = adapter.preprocess(data, False)
    adapter.plan(processed)
    batches = list(adapter.batches(processed, False))[:3]
    gen = torch.Generator().manual_seed(7)
    weights = {n: p.detach().numpy() for n, p in ModelParams(
        adapter.build_model(gen), init_output_heads(
            gen, config["hidden_size"], config["task_ids"])
    ).named_parameters()}
    loss, accs, grads = ranks.oracle(variant, config, meta, weights,
                                     batches, cuda)
    case = ranks.StepCase(variant, config, meta, weights, batches, n_data,
                          n_edge, kind, exchange, n_edge == 1, "cuda:0",
                          ("p2p",))
    results = mesh_pool.run(ranks.step_case, case)
    for rank, out in enumerate(results):
        np.testing.assert_allclose(float(out["train"]["loss"]), loss,
                                   rtol=1e-5)
        np.testing.assert_allclose(out["eval"]["accuracies"], accs,
                                   rtol=1e-5)
        for name, got in out["grads"].items():
            want = grads[name]
            if out["types"] is not None and ranks.is_tp_sharded_path(name):
                want = want[out["types"][0]:out["types"][1]]
            np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-6,
                                       err_msg=f"{label} rank {rank} {name}")
    if results[0]["types"] is None:
        for name, got in results[1]["grads"].items():
            np.testing.assert_array_equal(got, results[0]["grads"][name])


def test_nccl_mesh_runner_replays_bit_equal_to_eager_and_plain(cuda,
                                                              tmp_path):
    """A one-rank nccl mesh Runner replays its train and validation steps
    (graph counts above 0) and trains 2 epochs bit-equal to its eager
    twin and to the plain replayed Runner under deterministic
    algorithms: every epoch's loss and MAE, every parameter."""
    import os
    import torch_mesh_replay_ranks as ranks
    from ggnn_tpu_torch.parallel.launch import RankPool
    config = resolve_config("sparse", config_json=json.dumps({
        "hidden_size": 32, "batch_size": 2000, "num_epochs": 2,
        "edge_weight_dropout_keep_prob": 1.0,
        "graph_state_dropout_keep_prob": 1.0,
        "out_layer_dropout_keep_prob": 1.0}))
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    with RankPool(1, "nccl", timeout=600, env=env,
                  python_path=[os.path.dirname(__file__)]) as pool:
        (out,) = pool.run(ranks.nccl_replay, config,
                          synthetic_molecules(400, seed=3),
                          synthetic_molecules(60, seed=4), str(tmp_path))
    mesh, eager, plain = out["mesh"], out["mesh eager"], out["plain"]
    assert mesh["step_mode"] == {"mode": "replayed", "reason": None}
    assert mesh["graph_counts"]["train"] > 0
    assert mesh["graph_counts"]["validation"] > 0
    assert eager["graph_counts"] == {"train": 0, "validation": 0,
                                     "predict": 0}
    for other in (eager, plain):
        assert other["log"] == mesh["log"]
        for name, w in mesh["weights"].items():
            np.testing.assert_array_equal(other["weights"][name], w,
                                          err_msg=name)


def test_sorted_sums_and_gathers_repeat_bit_for_bit(cuda):
    """The readout's `segment_sum` and `sorted_gather` (attention type
    factors, async buffers) on the card: the values and gradients of two
    calls bit-equal (no atomics), and equal to the CPU's within 1e-5."""
    from ggnn_tpu_torch.ops.segment import segment_sum, sorted_gather
    gen = torch.Generator().manual_seed(7)
    data = torch.randn(20000, 3, generator=gen)
    ids = torch.sort(torch.randint(0, 1200, (20000,), generator=gen))[0]
    table = torch.randn(4, 100, generator=gen)
    types = torch.randint(0, 4, (42544,), generator=gen)
    g_sum = torch.randn(1201, 3, generator=gen)
    g_rows = torch.randn(42544, 100, generator=gen)

    def run(device):
        x = data.to(device).requires_grad_()
        t = table.to(device).requires_grad_()
        pooled = segment_sum(x, ids.to(device), 1201, True)
        rows = sorted_gather(t, types.to(device))
        ((pooled * g_sum.to(device)).sum()
         + (rows * g_rows.to(device)).sum()).backward()
        return [v.detach().cpu() for v in (pooled, x.grad, rows, t.grad)]

    first, second, cpu = run(cuda), run(cuda), run(torch.device("cpu"))
    for a, b, c in zip(first, second, cpu):
        assert torch.equal(a, b)
        torch.testing.assert_close(a, c, rtol=1e-5, atol=1e-5)


# ------------------------------------------------ ragged exchange (A22)

def _ragged_inputs(device, dtype, h_dim, seeds, n_shards=4, nl=64,
                   most=40):
    """Stand-in batches, one a seed: every rank's node rows, its routing
    rows on the card and a table cotangent, from random send lists of 0
    to `most` rows a pair, all laid out at one pack and table capacity
    (the largest totals, and 3 rows)."""
    from ggnn_tpu_torch.parallel import node_shard
    pairs = []
    for seed in seeds:
        rng = np.random.RandomState(seed)
        pairs.append({(o, d): sorted(rng.choice(
            nl, rng.randint(0, most + 1), replace=False).tolist())
            for o in range(n_shards) for d in range(n_shards) if o != d})
    sizes = np.zeros((len(seeds), n_shards, n_shards), np.int64)
    for i, p in enumerate(pairs):
        for (o, d), r in p.items():
            sizes[i, o, d] = len(r)
    send_cap = int(sizes.sum(2).max()) + 3
    recv_cap = int(sizes.sum(1).max()) + 3
    batches = []
    for seed, p in zip(seeds, pairs):
        spec = node_shard.ragged_spec(p, n_shards, send_cap, recv_cap)
        rows = [node_shard._to(node_shard._shard_of(spec, r), device)
                for r in range(n_shards)]
        gen = torch.Generator().manual_seed(seed)
        hs = [torch.randn(nl, h_dim, generator=gen).to(device, dtype)
              for _ in range(n_shards)]
        gs = [torch.randn(recv_cap, h_dim, generator=gen).to(device, dtype)
              for _ in range(n_shards)]
        batches.append((spec, hs, rows, gs))
    return batches


@pytest.mark.parametrize("dtype,h_dim", [(torch.float32, 100),
                                         (torch.float32, 37),
                                         (torch.bfloat16, 64),
                                         (torch.bfloat16, 37)])
def test_ragged_exchange_standin_equals_plain_eager_and_replayed(
        cuda, dtype, h_dim):
    """The peer-memory ragged all-to-all with one process standing in for
    4 ranks (one kernel a direction, its grid holding every rank) equals
    the plain version bit for bit: every table (its zero tail included)
    and every pack, eagerly for 3 batches whose per-pair sizes differ,
    then with all 3 forwards run before their reverse transfers (in the
    reverse order, as autograd may run a step of several batches), then
    through one CUDA graph captured once and replayed over all 3; rows
    of 8-, 4- and 2-byte units. Each forward returns the routes its
    owners sent. The counters count each launch (one a group's exchange,
    eagerly and at the capture), none a replay."""
    from ggnn_tpu_torch.ops.kernels import ragged_exchange as rx
    batches = _ragged_inputs(cuda, dtype, h_dim, (1, 2, 3))
    sizes = {str(np.asarray(spec.send_sizes).tolist())
             for spec, *_ in batches}
    assert len(sizes) == 3
    row_bytes = h_dim * torch.finfo(dtype).bits // 8
    assert {rx.copy_unit(row_bytes, [0])} == {
        (torch.float32, 100): {8}, (torch.float32, 37): {4},
        (torch.bfloat16, 64): {8}, (torch.bfloat16, 37): {2}}[
            (dtype, h_dim)]
    regions = rx.standin_regions(4, rx.buffer_bytes_for(
        rx.buffer_rows(batches[0][2][0]), row_bytes), cuda)
    rx.launches = rx.backward_launches = 0
    wants = []
    for _, hs, rows, gs in batches:
        want = (rx.exchange_reference(hs, rows),
                rx.exchange_backward_reference(gs, rows))
        tables, received = rx.standin_exchange(hs, rows, regions)
        routes = rx.routes(rows)
        for rank in range(4):
            np.testing.assert_array_equal(received[rank].cpu().numpy(),
                                          routes[rank])
        packs = rx.standin_backward(gs, rows, received, regions)
        torch.cuda.synchronize()
        for a, b in zip(tables + packs, want[0] + want[1]):
            assert torch.equal(a, b)
        wants.append(want)
    forwards = [rx.standin_exchange(hs, rows, regions)
                for _, hs, rows, gs in batches]
    for (_, hs, rows, gs), (tables, received), want in list(
            zip(batches, forwards, wants))[::-1]:
        packs = rx.standin_backward(gs, rows, received, regions)
        torch.cuda.synchronize()
        for a, b in zip(tables + packs, want[0] + want[1]):
            assert torch.equal(a, b)
    fields = ("gather", "input_offsets", "send_sizes", "output_offsets",
              "recv_sizes")
    _, hs, rows, gs = batches[0]
    s_hs, s_gs = [h.clone() for h in hs], [g.clone() for g in gs]
    s_rows = [dataclasses.replace(r, **{f: getattr(r, f).clone()
                                        for f in fields}) for r in rows]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        tables, received = rx.standin_exchange(s_hs, s_rows, regions)
        packs = rx.standin_backward(s_gs, s_rows, received, regions)
    for (_, hs, rows, gs), want in zip(batches[::-1], wants[::-1]):
        for dst, src in zip(s_hs + s_gs, hs + gs):
            dst.copy_(src)
        for dst, src in zip(s_rows, rows):
            for f in fields:
                getattr(dst, f).copy_(getattr(src, f))
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(tables + packs, want[0] + want[1]):
            assert torch.equal(a, b)
    assert (rx.launches, rx.backward_launches) == (7, 7)
    assert rx.status() == 0


def test_ragged_exchange_launch_plan_fits_the_card(cuda):
    """The launch plan of the stand-in's widest grid (8 ranks of
    MAX_BLOCKS) fits what the card holds at once, for every copy unit."""
    from ggnn_tpu_torch.ops.kernels import ragged_exchange as rx
    for unit in (8, 4, 2):
        resident = rx.resident_blocks(unit, cuda)
        assert resident >= rx.MAX_RANKS * rx.MAX_BLOCKS, (unit, resident)
        assert rx.launch_plan(10**6, 10**6, 400, unit, rx.MAX_RANKS,
                              resident) == rx.MAX_BLOCKS


def _ragged_trap(tmp_path, body):
    """Run `body` (lines after the stand-in's set-up: `rx`, `dev`,
    `batches` of 2 ranks and 2 seeds, `regions`; waits budgeted 0.5 s)
    in a process of its own (a trap ends the CUDA context): whether the
    next synchronise raised, and the status word."""
    import os
    import subprocess
    import sys
    script = tmp_path / "ragged_trap.py"
    script.write_text(
        "import sys, torch\n"
        f"sys.path.insert(0, {os.path.dirname(os.path.dirname(os.path.abspath(__file__)))!r})\n"
        f"sys.path.insert(0, {os.path.dirname(os.path.abspath(__file__))!r})\n"
        "from test_torch_cuda import _ragged_inputs\n"
        "from ggnn_tpu_torch.ops.kernels import ragged_exchange as rx\n"
        "rx.WAIT_SECONDS = 0.5\n"
        "dev = torch.device('cuda')\n"
        "batches = _ragged_inputs(dev, torch.float32, 8, (1, 2), 2)\n"
        "regions = rx.standin_regions(2, 1 << 16, dev)\n"
        + body +
        "try:\n"
        "    torch.cuda.synchronize()\n"
        "    print('no error')\n"
        "except RuntimeError as err:\n"
        "    print('raised', type(err).__name__)\n"
        "print('status', rx.status())\n")
    return subprocess.run([sys.executable, str(script)], capture_output=True,
                          text=True, timeout=300).stdout


def test_ragged_exchange_wait_without_its_peer_is_an_error(cuda, tmp_path):
    """A rank whose peer never runs its kernel does not hang: its fused
    kernel's wait reports the channel, itself and the peer in the status
    word and traps once its budget (0.5 s here) is spent, and the next
    synchronise raises."""
    out = _ragged_trap(tmp_path, "((spec, hs, rows, gs), _) = batches\n"
                       "rx.exchange(hs[0], rows[0], regions, 0)\n")
    assert "raised" in out, out
    assert f"status {(1 << 16) | (0 << 8) | (0 << 4) | 1}" in out, out


def test_ragged_exchange_backward_of_other_rows_is_an_error(cuda, tmp_path):
    """A reverse transfer of other rows than its forward's (whose routes
    the peers push by) traps with a stale-route code naming the backward
    channel, never returns a wrong pack."""
    out = _ragged_trap(tmp_path, "(_, hs, rows, gs), (_, _, other, _) = "
                       "batches\n"
                       "_, received = rx.standin_exchange(hs, rows, regions)\n"
                       "rx.standin_backward(gs, other, received, regions)\n")
    assert "raised" in out, out
    code = int(out.split("status")[-1])
    assert code >> 8 == (2 << 8) | 1, out


# ------------------------------------------ the GRU cell's kernels (K1-K4)

def _gru_inputs(device, rows, d_in, h_dim, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)

    def rand(*shape):
        return (0.5 * torch.randn(*shape, generator=gen, device=device)
                ).requires_grad_(True)

    return [rand(rows, d_in), rand(rows, h_dim), rand(d_in + h_dim, 2 * h_dim),
            rand(2 * h_dim), rand(d_in + h_dim, h_dim), rand(h_dim)]


def _gru_grads(out, args, seed=1):
    gen = torch.Generator(device=out.device).manual_seed(seed)
    weight = torch.randn(out.shape, generator=gen, device=out.device)
    return torch.autograd.grad((out * weight).sum(), args)


def _gru_eager(x, h, w_g, b_g, w_c, b_c, act):
    """The cell's step as eager PyTorch ran it before the kernels."""
    d_in, hdim = x.shape[-1], h.shape[-1]
    xs = torch.matmul(x, torch.cat([w_g[:d_in], w_c[:d_in]], dim=1))
    gates = torch.sigmoid(xs[..., :2 * hdim] + torch.matmul(h, w_g[d_in:])
                          + b_g)
    r, u = gates.chunk(2, dim=-1)
    c = act(xs[..., 2 * hdim:] + torch.matmul(r * h, w_c[d_in:]) + b_c)
    return u * h + (1.0 - u) * c


GRU_SHAPES = [(100_000, 100, 100), (100_000, 200, 100), (100_000, 300, 100),
              (7_424, 100, 100), (1_024, 100, 100), (5_000, 37, 37)]


@pytest.mark.parametrize("act", ["tanh", "relu"])
@pytest.mark.parametrize("rows,d_in,h_dim", GRU_SHAPES)
def test_gru_kernels_match_plain(cuda, rows, d_in, h_dim, act):
    """K1-K4 one by one against their plain versions on the card at the
    sparse batch (d_in 100/200/300, the residual layers), the dense
    buckets' extremes and the scalar path (H = 37), 1e-5; then the
    FusedGRU step's output and gradients against autograd of the eager
    formula, 1e-4. One launch a kernel."""
    from ggnn_tpu_torch.ops.kernels import gru
    code = gru.ACTIVATIONS[act]
    gen = torch.Generator(device=cuda).manual_seed(rows + d_in)
    xs = torch.randn(rows, 3 * h_dim, generator=gen, device=cuda)
    hg = torch.randn(rows, 2 * h_dim, generator=gen, device=cuda)
    hc, h, dn, drh = (torch.randn(rows, h_dim, generator=gen, device=cuda)
                      for _ in range(4))
    b_g = torch.randn(2 * h_dim, generator=gen, device=cuda)
    b_c = torch.randn(h_dim, generator=gen, device=cuda)
    assert gru.vector_width(h_dim, xs, h) == (4 if h_dim % 4 == 0 else 1)
    before = (gru.launches, gru.backward_launches)
    g, rh = gru.gru_gates(xs, hg, b_g, h)
    c, h_new = gru.gru_update(xs, hc, b_c, g, h, code)
    dxs, dh, partials = gru.gru_update_bwd(dn, g, h, c, code)
    gru.gru_gates_bwd(drh, h, g, dxs, dh, partials)
    torch.cuda.synchronize()
    assert (gru.launches, gru.backward_launches) == (before[0] + 2,
                                                     before[1] + 2)
    want_g, want_rh = gru.gates_reference(xs, hg, b_g, h)
    want_c, want_h = gru.update_reference(xs, hc, b_c, want_g, h, code)
    want_dxs, want_dh, want_p = gru.update_bwd_reference(dn, want_g, h,
                                                         want_c, code)
    gru.gates_bwd_reference(drh, h, want_g, want_dxs, want_dh, want_p)
    for got, want in ((g, want_g), (rh, want_rh), (c, want_c),
                      (h_new, want_h), (dxs, want_dxs), (dh, want_dh)):
        torch.testing.assert_close(got, want, **TOL)
    assert partials.shape == (gru.row_blocks(
        rows, torch.cuda.get_device_properties(0).multi_processor_count),
        3 * h_dim)
    torch.testing.assert_close(partials.sum(0), want_p.sum(0), rtol=1e-5,
                               atol=1e-3)
    args = _gru_inputs(cuda, rows, d_in, h_dim, seed=rows)
    out = gru.gru_step(*args, code)
    want = _gru_eager(*args, {"tanh": torch.tanh, "relu": torch.relu}[act])
    torch.testing.assert_close(out, want, rtol=1e-4, atol=1e-4)
    for got, want_grad in zip(_gru_grads(out, args), _gru_grads(want, args)):
        rel = float((got - want_grad).norm()
                    / want_grad.norm().clamp_min(1e-30))
        assert rel <= 1e-4


def test_gru_kernels_take_unaligned_views_and_empty_rows(cuda):
    """A row view off 16-byte alignment takes the scalar instance; zero
    rows launch nothing."""
    from ggnn_tpu_torch.ops.kernels import gru
    gen = torch.Generator(device=cuda).manual_seed(3)
    flat = torch.randn(1 + 300 * 100, generator=gen, device=cuda)
    h = flat[1:].view(300, 100)
    xs = torch.randn(300, 300, generator=gen, device=cuda)
    hg = torch.randn(300, 200, generator=gen, device=cuda)
    b_g = torch.randn(200, generator=gen, device=cuda)
    assert gru.vector_width(100, xs, h) == 1
    g, rh = gru.gru_gates(xs, hg, b_g, h)
    want_g, want_rh = gru.gates_reference(xs, hg, b_g, h)
    torch.testing.assert_close(g, want_g, **TOL)
    torch.testing.assert_close(rh, want_rh, **TOL)
    before = (gru.launches, gru.backward_launches)
    args = [a[:0].detach().requires_grad_() if i < 2 else a
            for i, a in enumerate(_gru_inputs(cuda, 4, 100, 100))]
    out = gru.gru_step(*args, gru.ACTIVATIONS["tanh"])
    grads = torch.autograd.grad(out.sum(), args)
    torch.cuda.synchronize()
    assert out.shape == (0, 100)
    assert (gru.launches, gru.backward_launches) == before
    assert all(float(gr.abs().sum()) == 0 for gr in grads)


def test_gru_step_repeats_bit_for_bit_and_replays_in_a_graph(cuda):
    """Two FusedGRU steps at the sparse batch's shape give the same bits,
    the biases' gradients included (no atomics); the step captured in a
    CUDA graph and replayed on new inputs equals the eager step."""
    from ggnn_tpu_torch.ops.kernels import gru
    code = gru.ACTIVATIONS["tanh"]
    args = _gru_inputs(cuda, 100_000, 300, 100, seed=5)
    runs = []
    for _ in range(2):
        out = gru.gru_step(*args, code)
        runs.append([out.detach()] + list(_gru_grads(out, args)))
    for first, second in zip(*runs):
        assert torch.equal(first, second)

    static = [a.detach().clone().requires_grad_(a.requires_grad)
              for a in _gru_inputs(cuda, 7_424, 100, 100, seed=6)]
    weight = torch.randn(7_424, 100, device=cuda)

    def step():
        out = gru.gru_step(*static, code)
        return [out.detach()] + list(torch.autograd.grad(
            (out * weight).sum(), static))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = (gru.launches, gru.backward_launches)
    with torch.cuda.graph(graph):
        outputs = step()
    assert (gru.launches - before[0], gru.backward_launches - before[1]) \
        == (2, 2)
    fresh = _gru_inputs(cuda, 7_424, 100, 100, seed=7)
    with torch.no_grad():
        for s, f in zip(static, fresh):
            s.copy_(f)
    graph.replay()
    replayed = [t.clone() for t in outputs]
    want = step()
    torch.cuda.synchronize()
    assert (gru.launches - before[0], gru.backward_launches - before[1]) \
        == (4, 4)
    for got, w in zip(replayed, want):
        assert torch.equal(got, w)


@pytest.mark.parametrize("variant,want", [("sparse", 16), ("dense", 8)])
def test_gru_launches_of_a_train_step(cuda, variant, want, tmp_path):
    """One Runner train step launches K1 and K2 once a propagation step
    and K3 and K4 once: 8 steps sparse (`layer_timesteps` [2,2,1,2,1]),
    4 dense."""
    from ggnn_tpu_torch.ops.kernels import gru
    if variant == "sparse":
        config = resolve_config("sparse", config_json=json.dumps({
            "batch_size": 2000}))
        train = synthetic_molecules(120, seed=7)
        batch = None
    else:
        config, batch = _dense_batch(variant)
        config.update({"dense_bucket_sizes": [16, 32]})
        train = synthetic_molecules(40, seed=7)
    runner = Runner(variant, dict(config), train_data=train,
                    valid_data=synthetic_molecules(20, seed=8),
                    log_dir=str(tmp_path), quiet=True, device="cuda")
    if batch is None:
        batch = next(iter(runner.adapter.batches(runner.train_processed,
                                                 False)))
    before = (gru.launches, gru.backward_launches)
    runner.loss_and_grads(batch.to("cuda"))
    torch.cuda.synchronize()
    assert (gru.launches - before[0],
            gru.backward_launches - before[1]) == (want, want)
