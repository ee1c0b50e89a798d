"""The CUDA kernels of ggnn_tpu_torch (B1, the aggregation, B2, its
transpose, and B3, the gather-floor probe's row gather) against their
plain PyTorch versions, the autograd Function and one training step, on
the card. Every test here needs an NVIDIA GPU and skips without one. The
file imports nothing of JAX, so it runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerances: rtol = atol = 1e-5 for a kernel against its plain version
(f32 sums in another order), 0 for B3 (a gather copies bits); 1e-4 for
a model forward or a gradient, which chain 8 GRU steps of f32 products
in another order.
"""

import json

import numpy as np
import pytest
import torch

from ggnn_tpu_torch.data import packing
from ggnn_tpu_torch.data.synthetic import synthetic_molecules
from ggnn_tpu_torch.models.base import ModelParams, init_output_heads
from ggnn_tpu_torch.models.sparse_ggnn import SparseGGNN
from ggnn_tpu_torch.ops.kernels import ell_spmm, gather_floor
from ggnn_tpu_torch.ops.messages import (aggregate_then_transform_combined,
                                         combined_lane_offsets,
                                         combined_lane_transpose)
from ggnn_tpu_torch.training.config import (default_params_for,
                                            resolve_config)
from ggnn_tpu_torch.training.runner import Runner

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
    src = torch.from_numpy(batch.edge_sources_all).to(device)
    offsets = combined_lane_offsets(
        torch.from_numpy(batch.edge_targets_all).to(device),
        torch.from_numpy(batch.edge_types_all).to(device), 4,
        batch.node_capacity)
    return src, offsets


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
    return combined_lane_transpose(*lane, 4, batch.node_capacity)


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
        h, *lane, w, n_cap, offsets=offsets,
        transpose=_transpose(batch, cuda))
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
