"""The blocked-ELL batch layout (ggnn_tpu_torch/data/ell.py, the
`ell_block` branch of both sparse packers, graph.py's ELLGraphBatch)
against the JAX package on the same numpy inputs, on the CPU.

Layouts, overflow signals and packed batches are held bit for bit; the
model over an ELLGraphBatch bit for bit against the plain batch and at
2e-5 against JAX's (the TF1 golden tolerance); the ELL ops over a packed
batch against JAX's Pallas kernels (interpret mode) at 1e-5 forward and
rtol 1e-4 / atol 1e-5 for the gradient (tests/test_pallas.py's VJP
tolerance). On the card the kernels are held to their plain versions by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import dataclasses
import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggnn_tpu.data import ell as jax_ell
from ggnn_tpu.data import native_pack as jax_native_pack
from ggnn_tpu.data import packing as jax_packing
from ggnn_tpu.models.base import init_output_heads as jax_init_heads
from ggnn_tpu.models.sparse_ggnn import SparseGGNN as JaxSparseGGNN
from ggnn_tpu.native import native_available as jax_native_available
from ggnn_tpu.ops.pallas import ell_aggregate_by_type as jax_ell_aggregate
from ggnn_tpu.ops.pallas import ell_scatter_sum as jax_ell_scatter_sum
from ggnn_tpu.training.checkpoint import _flatten_named
from ggnn_tpu.training.config import resolve_config as jax_resolve_config
from ggnn_tpu_torch import native
from ggnn_tpu_torch.data import ell, native_pack, packing
from ggnn_tpu_torch.data.loader import infer_metadata
from ggnn_tpu_torch.data.synthetic import synthetic_molecules
from ggnn_tpu_torch.graph import ELLGraphBatch, GraphBatch
from ggnn_tpu_torch.models.base import ModelParams, init_output_heads
from ggnn_tpu_torch.models.sparse_ggnn import SparseGGNN
from ggnn_tpu_torch.ops.kernels import ell_spmm
from ggnn_tpu_torch.training.checkpoint import params_from_jax_weights
from ggnn_tpu_torch.training.config import resolve_config
from ggnn_tpu_torch.utils.timing import _leaves, graph_key

torch.set_num_threads(1)

H = 16
BUDGET = 300
MODEL_TOL = dict(rtol=2e-5, atol=2e-5)
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
ELL_FIELDS = ("ell_fwd_src", "ell_fwd_tgt", "ell_bwd_tgt", "ell_bwd_src")
LAYOUT_FIELDS = ("fwd_src", "fwd_tgt", "bwd_tgt", "bwd_src")


@pytest.fixture(scope="module")
def corpus():
    data = synthetic_molecules(90, seed=31)
    return data, infer_metadata([data], True)


def _plain_batches(data, meta):
    proc = packing.preprocess_sparse(data, meta.num_edge_types, True, [0],
                                     {}, False)
    caps = packing.plan_capacities(proc, meta.num_edge_types, BUDGET)
    return caps, list(packing.pack_sparse_batches(
        proc, meta.num_edge_types, BUDGET, caps, H, meta.annotation_size,
        False, None))


def _epoch_ell_k(batches, block):
    """The slots a (type, block) that every batch of the epoch fits."""
    return max(ell.plan_ell_k(b.edge_targets, b.edge_mask, block,
                              edge_sources=b.edge_sources)
               for b in batches)


def _assert_same_leaves(got, want, label=""):
    """Class name, field names and every leaf's dtype and bits."""
    assert type(got).__name__ == type(want).__name__, label
    names = [f.name for f in dataclasses.fields(got)]
    assert names == [f.name for f in dataclasses.fields(want)], label
    for name in names:
        a, b = getattr(got, name), getattr(want, name)
        if b is None:
            assert a is None, (label, name)
            continue
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, (label, name, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f"{label} {name}")


# ------------------------------------------------------------ layouts

@pytest.mark.parametrize("block", [8, 16])
@pytest.mark.parametrize("ell_k", ["planned", "per-batch"])
@pytest.mark.parametrize("fn", ["build_ell_layout", "try_build_ell_layout"])
def test_ell_layout_of_packed_lanes_matches_jax(corpus, fn, ell_k, block):
    """Each packed batch's per-type lanes laid out by both packages,
    with the epoch's planned ell_k or each batch's own (ell_k None for
    `build_ell_layout`, the batch's own plan for the try variant)."""
    data, meta = corpus
    caps, batches = _plain_batches(data, meta)
    planned = _epoch_ell_k(batches, block)
    assert len(batches) > 1
    for b in batches:
        lanes = (b.edge_sources, b.edge_targets, b.edge_mask)
        if ell_k == "planned":
            k = planned
        elif fn == "try_build_ell_layout":
            k = ell.plan_ell_k(b.edge_targets, b.edge_mask, block,
                               edge_sources=b.edge_sources)
        else:
            k = None
        got = getattr(ell, fn)(*lanes, caps.nodes, block, k)
        want = getattr(jax_ell, fn)(*lanes, caps.nodes, block, k)
        assert got.ell_k == want.ell_k
        if ell_k == "planned":
            assert got.ell_k == planned
        for name in LAYOUT_FIELDS:
            a, w = getattr(got, name), np.asarray(getattr(want, name))
            assert a.dtype == w.dtype == np.int32
            np.testing.assert_array_equal(a, w, err_msg=name)


def test_ell_overflow_signals_match_jax(corpus, caplog):
    data, meta = corpus
    caps, batches = _plain_batches(data, meta)
    b = batches[0]
    lanes = (b.edge_sources, b.edge_targets, b.edge_mask)
    assert issubclass(ell.ELLOverflowError, ValueError)
    with pytest.raises(jax_ell.ELLOverflowError) as want:
        jax_ell.build_ell_layout(*lanes, caps.nodes, 8, 1)
    with pytest.raises(ell.ELLOverflowError) as got:
        ell.build_ell_layout(*lanes, caps.nodes, 8, 1)
    assert str(got.value) == str(want.value)
    warnings = []
    for pkg in (ell, jax_ell):
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger=pkg.__name__):
            assert pkg.try_build_ell_layout(*lanes, caps.nodes, 8, 1) is None
        (record,) = [r for r in caplog.records if r.name == pkg.__name__]
        assert record.levelno == logging.WARNING
        warnings.append(record.getMessage())
    assert warnings[0] == warnings[1]
    assert warnings[0].startswith("ELL layout overflow (")


MIS_SHAPES = {
    # IndexError: the mask selects past the lanes.
    "mask one edge short": lambda s, t, m: (s, t, m[:, :-1]),
    # ValueError, the overflow's base class: [n, 1] rows into [n] slots.
    "sources with a trailing axis": lambda s, t, m: (s[..., None], t, m),
}


@pytest.mark.parametrize("case", sorted(MIS_SHAPES))
def test_mis_shaped_lanes_propagate_in_both_packages(corpus, case):
    """Only the overflow is swallowed: a mis-shaped input raises the
    same error in both packages, a ValueError too."""
    data, meta = corpus
    caps, batches = _plain_batches(data, meta)
    b = batches[0]
    lanes = MIS_SHAPES[case](b.edge_sources, b.edge_targets, b.edge_mask)
    errors = []
    for fn in (jax_ell.try_build_ell_layout, ell.try_build_ell_layout):
        with pytest.raises(Exception) as err:
            fn(*lanes, caps.nodes, 8, 64)
        assert not isinstance(err.value, (jax_ell.ELLOverflowError,
                                          ell.ELLOverflowError))
        errors.append(type(err.value))
    assert errors[0] is errors[1]
    assert (errors[0] is ValueError) == (case != "mask one edge short")


# ------------------------------------------------------------ packers

@pytest.fixture(scope="module")
def native_packers():
    """The native libraries build on first use, here."""
    if not (native.native_available() and jax_native_available()):
        pytest.skip("g++ could not build a native packer")


def _numpy_stream(pkg, data, meta, block, ell_k, seed):
    proc = pkg.preprocess_sparse(data, meta.num_edge_types, True, [0], {},
                                 True, np.random.RandomState(seed))
    caps = pkg.plan_capacities(proc, meta.num_edge_types, BUDGET)
    return list(pkg.pack_sparse_batches(
        proc, meta.num_edge_types, BUDGET, caps, H, meta.annotation_size,
        True, np.random.RandomState(seed + 1), ell_block=block,
        ell_k=ell_k))


def _native_stream(pkg, data, meta, block, ell_k, seed, **workers):
    proc = pkg.preprocess_sparse_native(
        data, meta.num_edge_types, True, [0], {}, True,
        np.random.RandomState(seed))
    caps = pkg.plan_capacities_native(proc, BUDGET)
    return list(pkg.pack_sparse_batches_native(
        proc, meta.num_edge_types, True, BUDGET, caps, H,
        meta.annotation_size, True, np.random.RandomState(seed + 1),
        ell_block=block, ell_k=ell_k, **workers))


@pytest.mark.parametrize("block", [8, 16])
@pytest.mark.parametrize("packer", ["numpy", "native, 1 worker",
                                    "native, 4 workers"])
def test_packers_with_ell_block_match_jax(corpus, native_packers, packer,
                                          block):
    """Training mode from the same RandomStates: each port packer's
    ELLGraphBatches against the JAX packer's, class and every leaf."""
    data, meta = corpus
    ell_k = _epoch_ell_k(_plain_batches(data, meta)[1], block) + 8
    if packer == "numpy":
        got = _numpy_stream(packing, data, meta, block, ell_k, 5)
        want = _numpy_stream(jax_packing, data, meta, block, ell_k, 5)
    else:
        workers = 1 if packer.startswith("native, 1") else 4
        got = _native_stream(native_pack, data, meta, block, ell_k, 5,
                             workers=workers)
        want = _native_stream(jax_native_pack, data, meta, block, ell_k, 5,
                              workers=workers)
    assert len(got) == len(want) > 1
    for i, (a, b) in enumerate(zip(got, want)):
        assert isinstance(a, ELLGraphBatch)
        _assert_same_leaves(a, b, f"{packer} batch {i}")
        assert a.ell_fwd_src.shape[2] == ell_k
        n_pad = a.ell_fwd_src.shape[1] * block
        for keys in (a.ell_fwd_tgt, a.ell_bwd_src):
            assert int((keys < n_pad).sum()) == int(a.edge_mask.sum())


def test_numpy_and_native_ell_packs_agree(corpus, native_packers):
    """The two port packers, eval mode: the same ELLGraphBatches, whose
    GraphBatch fields are the plain pack's."""
    data, meta = corpus
    caps, plain = _plain_batches(data, meta)
    ell_k = _epoch_ell_k(plain, 16)
    proc = packing.preprocess_sparse(data, meta.num_edge_types, True, [0],
                                     {}, False)
    got = list(packing.pack_sparse_batches(
        proc, meta.num_edge_types, BUDGET, caps, H, meta.annotation_size,
        False, None, ell_block=16, ell_k=ell_k))
    nproc = native_pack.preprocess_sparse_native(
        data, meta.num_edge_types, True, [0], {}, False)
    nat = list(native_pack.pack_sparse_batches_native(
        nproc, meta.num_edge_types, True, BUDGET, caps, H,
        meta.annotation_size, False, None, ell_block=16, ell_k=ell_k))
    assert len(got) == len(nat) == len(plain)
    for a, b, p in zip(got, nat, plain):
        _assert_same_leaves(a, b)
        _assert_same_leaves(GraphBatch(**{
            f.name: getattr(a, f.name)
            for f in dataclasses.fields(GraphBatch)}), p)


@pytest.mark.parametrize("packer", ["numpy", "native"])
def test_port_packers_raise_on_ell_overflow(corpus, native_packers, packer,
                                            caplog):
    """An ell_k the epoch overflows raises the replan ValueError, as in
    JAX (tests/test_native.py's overflow test), never a mixed stream; the
    overflow is its cause, and nothing is logged before it."""
    data, meta = corpus
    stream = _numpy_stream if packer == "numpy" else _native_stream
    pkg = packing if packer == "numpy" else native_pack
    with caplog.at_level(logging.WARNING, logger=ell.__name__):
        with pytest.raises(ValueError, match="ELL layout overflow") as err:
            stream(pkg, data, meta, 8, 1, 7)
    assert "replan ell_k over this epoch" in str(err.value)
    assert not isinstance(err.value, ell.ELLOverflowError)
    assert isinstance(err.value.__cause__, ell.ELLOverflowError)
    assert not [r for r in caplog.records if r.name == ell.__name__]


def test_ell_batch_moves_and_keys_its_four_arrays(corpus):
    """`to`, `graph_key` and `_leaves` walk the ELL fields too."""
    data, meta = corpus
    caps, plain = _plain_batches(data, meta)
    proc = packing.preprocess_sparse(data, meta.num_edge_types, True, [0],
                                     {}, False)
    b = next(packing.pack_sparse_batches(
        proc, meta.num_edge_types, BUDGET, caps, H, meta.annotation_size,
        False, None, ell_block=8, ell_k=_epoch_ell_k(plain, 8)))
    moved = b.to("cpu")
    assert isinstance(moved, ELLGraphBatch)
    for name in ELL_FIELDS:
        t = getattr(moved, name)
        assert isinstance(t, torch.Tensor) and t.dtype == torch.int32
        np.testing.assert_array_equal(t.numpy(), getattr(b, name))
    key = graph_key(b)
    assert key[0] == "ELLGraphBatch" and key == graph_key(moved)
    assert key[-4:] == tuple((getattr(b, n).shape, torch.int32)
                             for n in ELL_FIELDS)
    assert key != graph_key(plain[0])
    leaves = _leaves(moved)
    assert len(leaves) == len(_leaves(plain[0].to("cpu"))) + 4
    assert all(x is getattr(moved, n) for x, n in zip(leaves[-4:],
                                                       ELL_FIELDS))


# ------------------------------------------------------------ model, ops

def test_sparse_ggnn_on_an_ell_batch(corpus):
    """The model reads the GraphBatch fields only: the ELLGraphBatch and
    its plain twin give the same bits, and JAX's model on the JAX ELL
    batch the same values at 2e-5."""
    data, meta = corpus
    overrides = {"hidden_size": H, "layer_timesteps": [2, 1]}
    config = resolve_config("sparse", config_json=json.dumps(overrides))
    jax_config = jax_resolve_config("sparse",
                                    config_json=json.dumps(overrides))
    t_dim = meta.num_edge_types
    jax_model = JaxSparseGGNN(jax_config, t_dim)
    key = jax.random.PRNGKey(3)
    jax_params = {"graph": jax_model.init_params(key),
                  "heads": jax_init_heads(key, H, config["task_ids"])}
    gen = torch.Generator().manual_seed(0)
    port = ModelParams(SparseGGNN(config, t_dim, gen),
                       init_output_heads(gen, H, config["task_ids"]))
    port.load_state_dict(params_from_jax_weights(
        _flatten_named({"params": jax_params})), strict=True)
    port.eval()
    jax_proc = jax_packing.preprocess_sparse(data, t_dim, True, [0], {},
                                             False)
    caps = jax_packing.plan_capacities(jax_proc, t_dim, BUDGET)
    jax_plain = next(jax_packing.pack_sparse_batches(
        jax_proc, t_dim, BUDGET, caps, H, meta.annotation_size, False,
        None))
    ell_k = jax_ell.plan_ell_k(jax_plain.edge_targets, jax_plain.edge_mask,
                               8, edge_sources=jax_plain.edge_sources)
    jax_batch = next(jax_packing.pack_sparse_batches(
        jax_proc, t_dim, BUDGET, caps, H, meta.annotation_size, False,
        None, ell_block=8, ell_k=ell_k))
    proc = packing.preprocess_sparse(data, t_dim, True, [0], {}, False)
    batch = next(packing.pack_sparse_batches(
        proc, t_dim, BUDGET, caps, H, meta.annotation_size, False, None,
        ell_block=8, ell_k=ell_k)).to("cpu")
    twin = GraphBatch(**{f.name: getattr(batch, f.name)
                         for f in dataclasses.fields(GraphBatch)})
    with torch.no_grad():
        final = port.graph(batch)
        out = port.graph.readout(port.heads, [0], final, batch)
        plain_final = port.graph(twin)
        plain_out = port.graph.readout(port.heads, [0], plain_final, twin)
    assert torch.equal(final, plain_final) and torch.equal(out, plain_out)
    want = jax_model.forward(jax_params["graph"], jax_batch)
    want_out = jax_model.readout(jax_params["heads"], [0], want, jax_batch)
    np.testing.assert_allclose(final.numpy(), np.asarray(want), **MODEL_TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out),
                               **MODEL_TOL)


def _packed_ell(data, meta, block):
    caps, plain = _plain_batches(data, meta)
    proc = packing.preprocess_sparse(data, meta.num_edge_types, True, [0],
                                     {}, False)
    b = next(packing.pack_sparse_batches(
        proc, meta.num_edge_types, BUDGET, caps, H, meta.annotation_size,
        False, None, ell_block=block, ell_k=_epoch_ell_k(plain, block)))
    return b, b.ell_fwd_src.shape[1] * block


def test_ell_ops_over_a_packed_batch_match_jax_pallas(corpus):
    """`ell_aggregate_by_type`, its gradient (B2 over the backward
    layout) and `ell_scatter_sum` over a packed ELLGraphBatch against
    JAX's Pallas pair in interpret mode."""
    data, meta = corpus
    block = 16
    b, np_total = _packed_ell(data, meta, block)
    t_dim = meta.num_edge_types
    rng = np.random.RandomState(4)
    h = rng.randn(np_total, H).astype(np.float32)
    w = rng.randn(t_dim, H, H).astype(np.float32) / 4
    g = rng.randn(t_dim, np_total, H).astype(np.float32)
    fwd = (jnp.asarray(b.ell_fwd_src), jnp.asarray(b.ell_fwd_tgt))
    bwd = (jnp.asarray(b.ell_bwd_tgt), jnp.asarray(b.ell_bwd_src))
    layout = [torch.from_numpy(getattr(b, n)) for n in ELL_FIELDS]

    def loss_jax(x):
        out = jax_ell_aggregate(x, fwd, bwd, block, True)
        return jnp.sum(jnp.tanh(jnp.einsum("tnh,thd->nd", out, w))), out

    (_, want), want_grad = jax.value_and_grad(loss_jax, has_aux=True)(
        jnp.asarray(h))
    x = torch.from_numpy(h).requires_grad_(True)
    out = ell_spmm.ell_aggregate_by_type(x, *layout)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **TOL)
    loss = torch.tanh(torch.einsum("tnh,thd->nd", out,
                                   torch.from_numpy(w))).sum()
    (grad,) = torch.autograd.grad(loss, x)
    np.testing.assert_allclose(grad.numpy(), np.asarray(want_grad),
                               **GRAD_TOL)
    want_dh = jax_ell_scatter_sum(jnp.asarray(g), *bwd, block, True)
    got_dh = ell_spmm.ell_scatter_sum(torch.from_numpy(g), *layout[2:])
    np.testing.assert_allclose(got_dh.numpy(), np.asarray(want_dh), **TOL)
