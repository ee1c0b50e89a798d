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
