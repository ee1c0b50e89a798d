"""`compute_dtype: bfloat16` in the port against the JAX package on the
CPU: the kernels' plain versions in bf16, the message functions of every
route with and without attention, every model that reads the key
(`SparseGGNN` on each route, `DenseGGNN` in both modes, `BlockedGCN`)
and the two that ignore it (the edge-list `GCN`, `AsyncGGNN`), one
step's gradients, the Runner, the Predictor and an exported artifact.

What the two packages do differently in bf16, and so what the
tolerances cover:

  * sums: the port's kernels and their plain versions sum bf16 rows in
    f32 and round each output once (the JAX model's "bf16 with f32
    accumulation", `ggnn_tpu/models/sparse_ggnn.py:102-104`); JAX on the
    CPU adds bf16 rows in bf16, one rounding an add
    (`ggnn_tpu/ops/segment.py:18-23`). On QM9-sized segments (a few edges
    a (target, type)) the two differ by an ulp or two of a sum; on a
    segment of 1,000 ones JAX gives 256 and the port 1000
    (`test_bf16_sums_accumulate_in_f32`);
  * products: the port's `edge_dot` and weighted sums multiply bf16
    values in f32 (exactly), JAX rounds each product `src * tgt`
    (`ggnn_tpu/ops/messages.py:68`) and `gathered * attention`
    (`:179-180`) to bf16;
  * gradients of a bf16-in, f32-out product: the port rounds the f32
    cotangent to bf16 before the product (`ops/precision.py`), JAX
    multiplies it in f32.

Each tolerance below was set from the port-vs-JAX error measured on
these inputs (named beside it), at no more than 4x that error and never
looser than JAX's own bf16 bound, 0.05 absolute on the node states
(`tests/test_models.py:268-280`). Errors are absolute for node states
and outputs (tanh-bounded, O(1)) and relative to the largest magnitude
of the reference for gradients.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggnn_tpu.data import packing as jax_packing
from ggnn_tpu.data.loader import infer_metadata
from ggnn_tpu.data.synthetic import synthetic_molecules
from ggnn_tpu.models import base as jax_base
from ggnn_tpu.models.dense_ggnn import DenseGGNN as JaxDenseGGNN
from ggnn_tpu.models.gcn import GCN as JaxGCN
from ggnn_tpu.models.gcn import BlockedGCN as JaxBlockedGCN
from ggnn_tpu.models.sparse_ggnn import SparseGGNN as JaxSparseGGNN
from ggnn_tpu.ops import messages as jax_messages
from ggnn_tpu.ops.segment import segment_sum as jax_segment_sum
from ggnn_tpu.serving import Predictor as JaxPredictor
from ggnn_tpu.training.checkpoint import _flatten_named
from ggnn_tpu.training.config import resolve_config as jax_resolve_config
from ggnn_tpu.training.runner import Runner as JaxRunner
from ggnn_tpu_torch.data.loader import DatasetMeta
from ggnn_tpu_torch.export import export_predictor, load_predictor
from ggnn_tpu_torch.graph import DenseGraphBatch, GCNGraphBatch, GraphBatch
from ggnn_tpu_torch.models import base
from ggnn_tpu_torch.models.async_ggnn import AsyncGGNN
from ggnn_tpu_torch.models.base import ModelParams, init_output_heads
from ggnn_tpu_torch.models.dense_ggnn import DenseGGNN
from ggnn_tpu_torch.models.gcn import GCN, BlockedGCN
from ggnn_tpu_torch.models.sparse_ggnn import SparseGGNN
from ggnn_tpu_torch.ops import messages
from ggnn_tpu_torch.ops.kernels import edge_dot, ell_spmm, gather_floor
from ggnn_tpu_torch.ops.precision import matmul_f32
from ggnn_tpu_torch.ops.segment import segment_offsets
from ggnn_tpu_torch.serving import Predictor
from ggnn_tpu_torch.training.checkpoint import (params_from_jax_weights,
                                                save_checkpoint)
from ggnn_tpu_torch.training.config import resolve_config
from ggnn_tpu_torch.training.runner import Runner
from ggnn_tpu_torch.training.variants import make_adapter

torch.set_num_threads(1)

H = 16
BF16 = {"compute_dtype": "bfloat16"}
NO_DROPOUT = {"edge_weight_dropout_keep_prob": 1.0,
              "graph_state_dropout_keep_prob": 1.0,
              "out_layer_dropout_keep_prob": 1.0}
# JAX's own bound on bf16 node states against f32
# (tests/test_models.py:268-280): no tolerance here is looser.
JAX_BF16_ATOL = 0.05

# Tolerances, port vs JAX in bf16 (see the module docstring): each the
# largest error measured over its tests' cases on these inputs (in
# brackets) times at most 4. The sparse routes' sums differ in their
# bf16 roundings; the dense family's products round at the same places
# in both packages and sum in f32 in both, so its states agree to f32
# rounding and only its gradients (bf16 cotangents) differ more.
TOL_MESSAGES = 1.5e-2        # one step's messages, relative [4.57e-3]
TOL_MESSAGES_GRAD = 4e-2     # their gradients, relative [1.21e-2]
TOL_SPARSE = 1e-3            # SparseGGNN node states, abs [2.72e-4]
TOL_SPARSE_GRAD = 3.5e-2     # its gradients, relative [9.44e-3]
TOL_DENSE = 1e-5             # dense, blocked, gcn_blocked states and
#                              outputs, abs [2.86e-6]
TOL_DENSE_GRAD = 3e-2        # their gradients, relative [8.33e-3]
TOL_RUNNER = 4e-4            # Runner losses per epoch, relative [1.02e-4]
TOL_PREDICTOR = 7e-4         # served answers, abs [1.88e-4]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _to_bf16(x: np.ndarray) -> torch.Tensor:
    return _t(np.asarray(x, np.float32)).to(torch.bfloat16)


def _round_bf16(x: np.ndarray) -> np.ndarray:
    """f32 values rounded to bf16 (nearest even), as f32."""
    return _to_bf16(x).float().numpy()


def _bf16_ulps(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    """|got - want| in units of bf16's spacing at want."""
    mag = np.maximum(np.abs(want), np.float32(2.0 ** -126))
    return np.abs(got - want) / 2.0 ** (np.floor(np.log2(mag)) - 7)


def _rel(got, want) -> float:
    """Largest abs error relative to the reference's largest magnitude."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def _abs(got, want) -> float:
    return float(np.abs(np.asarray(got, np.float64)
                        - np.asarray(want, np.float64)).max())


# ------------------------------------------------------------- kernels

def _lane(seed, num_rows=60, num_edges=400, num_segments=50):
    """A segment-sorted edge list: ids, CSR offsets, each edge's
    segment; its rows and weights bf16 values (f32 randn rounded)."""
    rng = np.random.RandomState(seed)
    src = rng.randint(0, num_rows, num_edges).astype(np.int32)
    seg = np.sort(rng.randint(0, num_segments, num_edges)).astype(np.int32)
    rows = _round_bf16(rng.randn(num_rows, H).astype(np.float32))
    weights = _round_bf16(rng.rand(num_edges).astype(np.float32))
    offsets = segment_offsets(_t(seg), num_segments)
    return src, seg, rows, weights, offsets, num_segments


def _numpy_segment_sum(rows, src, seg, num_segments, weights=None):
    """f32 sums of the (weighted) rows in edge order, rounded once."""
    gathered = rows[src]
    if weights is not None:
        gathered = gathered * weights[:, None]
    out = np.zeros((num_segments, rows.shape[1]), np.float32)
    np.add.at(out, seg, gathered.astype(np.float32))
    return _round_bf16(out)


@pytest.mark.parametrize("kernel", ["b1", "b2", "weighted",
                                    "weighted_transpose"])
def test_plain_segment_sums_in_bf16_match_f32_accumulated_numpy(kernel):
    """B1, B2, the weighted instance and its transpose, on bf16 rows:
    the output is bf16 and within one bf16 ulp of numpy's f32 sums
    rounded once (the same sums in another order can round to the
    neighbouring bf16 value)."""
    src, seg, rows, weights, offsets, s = _lane(seed=1)
    h = _to_bf16(rows)
    if kernel == "b1":
        got = ell_spmm.gather_segment_sum(h, _t(src), offsets, s)
        want = _numpy_segment_sum(rows, src, seg, s)
    elif kernel == "weighted":
        got = ell_spmm.weighted_gather_segment_sum(h, _t(src),
                                                   _to_bf16(weights),
                                                   offsets, s)
        want = _numpy_segment_sum(rows, src, seg, s, weights)
    else:
        # The transpose: g [S, H] summed into the sources over the edges
        # sorted by source, each edge reading its segment's row.
        g = rows[:s]
        num_nodes = rows.shape[0]
        if kernel == "b2":
            bgather, boff = ell_spmm.transpose_layout(_t(src).long(),
                                                      _t(seg), num_nodes)
            got = ell_spmm.segment_scatter_sum(_to_bf16(g), bgather, boff,
                                               num_nodes)
            want = _numpy_segment_sum(g, seg, src, num_nodes)
        else:
            bgather, bweights, boff = ell_spmm.weighted_transpose_layout(
                _t(src).long(), _t(seg), _to_bf16(weights), num_nodes)
            got = ell_spmm.weighted_segment_scatter_sum(
                _to_bf16(g), bgather, bweights, boff, num_nodes)
            want = _numpy_segment_sum(g, seg, src, num_nodes, weights)
    assert got.dtype == torch.bfloat16
    assert _bf16_ulps(got.float().numpy(), want).max() <= 1


def test_plain_gather_rows_and_edge_dot_in_bf16():
    """gather_rows copies bf16 rows bit for bit; edge_dot's dots of bf16
    rows are f32, each the f32 sum of exact products (rtol 1e-6: the
    same sums in another order), pads 0."""
    src, seg, rows, _, _, _ = _lane(seed=2)
    h = _to_bf16(rows)
    ids = _t(src[:96].reshape(12, 8))
    got = gather_floor.gather_rows(h, ids, 8)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, h[ids.long()])
    b = np.random.RandomState(3).randint(0, rows.shape[0] + 1,
                                         src.shape[0]).astype(np.int32)
    dots = edge_dot.edge_dot(h, _t(src), h, _t(b))
    assert dots.dtype == torch.float32
    real = b < rows.shape[0]
    want = np.where(real, np.einsum(
        "ek,ek->e", rows[src].astype(np.float64),
        rows[np.where(real, b, 0)].astype(np.float64)), 0.0)
    np.testing.assert_allclose(dots.numpy(), want, rtol=1e-6, atol=1e-6)


def test_bf16_sums_accumulate_in_f32():
    """One segment of 1,000 bf16 ones: the port's B1 (its plain version
    here, the kernel on the card) gives 1000, the f32 sum rounded once;
    JAX's segment_sum on the CPU adds in bf16 and stops at 256, where
    256 + 1 rounds back to 256. The port follows the JAX model's
    docstring ("bf16 with f32 accumulation"), not the CPU's rounding:
    an accepted divergence (ROADMAP.md section C)."""
    ones = torch.ones(1, 1, dtype=torch.bfloat16)
    src = torch.zeros(1000, dtype=torch.int32)
    offsets = torch.tensor([0, 1000], dtype=torch.int32)
    got = ell_spmm.gather_segment_sum(ones, src, offsets, 1)
    assert got.dtype == torch.bfloat16 and float(got) == 1000.0
    jax_sum = jax_segment_sum(jnp.ones((1000, 1), jnp.bfloat16),
                              jnp.zeros(1000, jnp.int32), 1)
    assert float(jax_sum[0, 0]) == 256.0


@pytest.mark.parametrize("op", ["b1", "weighted", "edge_dot", "gather_rows",
                                "product"])
def test_kernels_take_f32_and_bf16_and_refuse_other_dtypes(op):
    """float16 (and weights of another dtype than the rows) raise a
    TypeError; the fake (meta) registration gives the kernel's output
    dtype, so that torch.export traces a bf16 program."""
    h16 = torch.ones(4, 8, dtype=torch.float16)
    hb = torch.ones(4, 8, dtype=torch.bfloat16)
    src = torch.tensor([0, 1, 2], dtype=torch.int32)
    offsets = torch.tensor([0, 2, 3], dtype=torch.int32)
    calls = {
        "b1": (lambda h: ell_spmm.gather_segment_sum(h, src, offsets, 2),
               torch.bfloat16),
        "weighted": (lambda h: ell_spmm.weighted_gather_segment_sum(
            h, src, torch.ones(3, dtype=h.dtype), offsets, 2),
            torch.bfloat16),
        "edge_dot": (lambda h: edge_dot.edge_dot(h, src, h, src),
                     torch.float32),
        "gather_rows": (lambda h: gather_floor.gather_rows(
            h, src.view(1, 3), 1), torch.bfloat16),
        "product": (lambda h: matmul_f32(h, h.t()), torch.float32),
    }
    call, out_dtype = calls[op]
    assert call(hb).dtype == out_dtype
    with pytest.raises(TypeError):
        call(h16)
    if op == "weighted":
        with pytest.raises(TypeError, match="dtype"):
            ell_spmm.weighted_gather_segment_sum(hb, src, torch.ones(3),
                                                 offsets, 2)
    with torch._subclasses.fake_tensor.FakeTensorMode(
            allow_non_fake_inputs=True) as mode:
        fake = call(mode.from_tensor(hb))
    assert fake.dtype == out_dtype


def test_matmul_f32_keeps_the_product_in_f32_with_input_dtype_gradients():
    """bf16 inputs, an f32 output equal to the f32 product of the
    widened inputs (no bf16 rounding of the output, which torch.matmul of
    two bf16 tensors would do); gradients in each input's dtype, from
    the cotangent rounded to bf16."""
    rng = np.random.RandomState(4)
    a32, b32 = rng.randn(5, 7).astype(np.float32), rng.randn(7, 3).astype(
        np.float32)
    g = rng.randn(5, 3).astype(np.float32)
    a = _to_bf16(a32).requires_grad_(True)
    b = _to_bf16(b32).requires_grad_(True)
    out = matmul_f32(a, b)
    assert out.dtype == torch.float32
    wa, wb = _round_bf16(a32), _round_bf16(b32)
    np.testing.assert_allclose(out.detach().numpy(), wa @ wb, rtol=1e-6,
                               atol=1e-6)
    out.backward(_t(g))
    assert a.grad.dtype == b.grad.dtype == torch.bfloat16
    gb = _round_bf16(g)
    np.testing.assert_array_equal(a.grad.float().numpy(),
                                  _round_bf16(gb @ wb.T))
    np.testing.assert_array_equal(b.grad.float().numpy(),
                                  _round_bf16(wa.T @ gb))
    batched = matmul_f32(a.detach().expand(2, 5, 7),
                         b.detach().expand(2, 7, 3))
    assert batched.shape == (2, 5, 3) and batched.dtype == torch.float32


# ------------------------------------------------------------ messages

def _batch(seed=13, n_graphs=30, budget=300, lane=True):
    data = synthetic_molecules(n_graphs, seed=seed)
    meta = infer_metadata([data], True)
    t_dim = meta.num_edge_types
    proc = jax_packing.preprocess_sparse(data, t_dim, True, [0], {}, False)
    caps = jax_packing.plan_capacities(proc, t_dim, budget)
    if not lane:
        caps = dataclasses.replace(caps, edges_all=0)
    batch = next(jax_packing.pack_sparse_batches(
        proc, t_dim, budget, caps, H, meta.annotation_size, False, None))
    return batch, t_dim


def _step_fns(route, attention, batch, n):
    """(jax_fn, port_fn) of one propagation step's incoming messages on
    `route`, each taking f32 (h, W, factors) and casting h and W to bf16
    as the models do, the attention weights to bf16 on the
    aggregate-first routes; f32 out."""
    bf = jnp.bfloat16
    if route == "combined":
        lane = (batch.edge_sources_all, batch.edge_types_all,
                batch.edge_targets_all, batch.edge_mask_all)

        def jax_fn(h, w, f):
            hc, wc = h.astype(bf), w.astype(bf)
            attn = None
            if attention:
                attn = jax_messages.propagation_attention_weights_combined(
                    hc, lane[0], lane[2], lane[3], lane[1], f, n).astype(bf)
            return jax_messages.aggregate_then_transform_combined(
                hc, lane[0], lane[1], lane[2], wc, n, attn).astype(
                    jnp.float32)

        def port_fn(h, w, f):
            src, typ, tgt, mask = (_t(a) for a in lane)
            hc, wc = h.to(torch.bfloat16), w.to(torch.bfloat16)
            lanes = messages.EdgeLanes.combined(src, typ, tgt, w.shape[0], n)
            attn = None
            if attention:
                attn = messages.propagation_attention_weights_combined(
                    hc, src, tgt, mask, typ, f, n, lanes).to(torch.bfloat16)
            return messages.aggregate_then_transform_combined(
                hc, src, typ, tgt, wc, n, attn, lanes).float()

        return jax_fn, port_fn
    lane = (batch.edge_sources, batch.edge_targets, batch.edge_mask)
    if route == "per-type":
        def jax_fn(h, w, f):
            hc, wc = h.astype(bf), w.astype(bf)
            attn = None
            if attention:
                attn = jax_messages.propagation_attention_weights(
                    hc, *lane, f, n).astype(bf)
            return jax_messages.aggregate_then_transform(
                hc, lane[0], lane[1], wc, n, attn,
                targets_sorted=True).astype(jnp.float32)

        def port_fn(h, w, f):
            src, tgt, mask = (_t(a) for a in lane)
            hc, wc = h.to(torch.bfloat16), w.to(torch.bfloat16)
            attn = None
            if attention:
                attn = messages.propagation_attention_weights(
                    hc, src, tgt, mask, f, n).to(torch.bfloat16)
            return messages.aggregate_then_transform(
                hc, src, tgt, wc, n, attn, targets_sorted=True).float()

        return jax_fn, port_fn

    def jax_fn(h, w, f):
        hc, wc = h.astype(bf), w.astype(bf)
        msgs = jax_messages.typed_edge_messages(hc, lane[0], wc)
        if attention:
            msgs = jax_messages.propagation_attention(msgs, hc, *lane, f, n)
        return jax_messages.aggregate_messages(msgs, lane[1], n).astype(
            jnp.float32)

    def port_fn(h, w, f):
        src, tgt, mask = (_t(a) for a in lane)
        hc, wc = h.to(torch.bfloat16), w.to(torch.bfloat16)
        msgs = messages.typed_edge_messages(hc, src, wc)
        if attention:
            msgs = messages.propagation_attention(msgs, hc, src, tgt, mask, f,
                                                  n)
        return messages.aggregate_messages(msgs, tgt, n).float()

    return jax_fn, port_fn


@pytest.mark.parametrize("attention", [False, True])
@pytest.mark.parametrize("route", ["combined", "per-type", "per-edge"])
def test_messages_in_bf16_match_jax(route, attention):
    """One step's incoming messages on each route, with and without
    attention, from bf16 node states and weights: forward and the
    gradients in the f32 h, W and attention factors."""
    batch, t_dim = _batch(seed=21 + attention)
    n = batch.node_capacity
    rng = np.random.RandomState(5)
    h = rng.randn(n, H).astype(np.float32)
    w = (0.3 * rng.randn(t_dim, H, H)).astype(np.float32)
    f = rng.uniform(0.5, 1.5, t_dim).astype(np.float32)
    g = rng.randn(n, H).astype(np.float32)
    jax_fn, port_fn = _step_fns(route, attention, batch, n)
    args = (jnp.asarray(h), jnp.asarray(w), jnp.asarray(f))
    want = np.asarray(jax_fn(*args))
    want_grads = jax.grad(lambda *a: jnp.sum(jax_fn(*a) * g),
                          argnums=(0, 1, 2))(*args)
    leaves = [_t(a).requires_grad_(True) for a in (h, w, f)]
    got = port_fn(*leaves)
    assert got.dtype == torch.float32
    assert _rel(got.detach().numpy(), want) <= TOL_MESSAGES
    wanted = leaves if attention else leaves[:2]
    got_grads = torch.autograd.grad((got * _t(g)).sum(), wanted)
    for name, got_g, want_g in zip("hwf", got_grads, want_grads):
        assert got_g.dtype == torch.float32
        assert _rel(got_g.numpy(), np.asarray(want_g)) <= TOL_MESSAGES_GRAD, \
            name


# -------------------------------------------------------------- models

def _bridged(jax_params):
    return {k[len("graph."):]: v for k, v in params_from_jax_weights(
        _flatten_named({"params": {"graph": jax_params}})).items()}


def _port_batch(jax_batch, cls):
    return cls(**{f.name: getattr(jax_batch, f.name)
                  for f in dataclasses.fields(cls)}).to("cpu")


def _configs(variant, overrides):
    overrides = json.dumps(overrides)
    config = resolve_config(variant, config_json=overrides)
    assert config == jax_resolve_config(variant, config_json=overrides)
    return config


def _assert_model_matches(out, want, grads, want_grads, tol, grad_tol):
    """Node states within `tol` of JAX's; every parameter's gradient
    within `grad_tol` of JAX's, relative to its largest entry."""
    assert np.isfinite(out).all() and _abs(out, want) <= tol
    assert sorted(grads) == sorted(want_grads)
    for k in grads:
        assert np.isfinite(grads[k]).all(), k
        assert _rel(grads[k], want_grads[k]) <= grad_tol, k


SPARSE_ROUTES = {"combined": {}, "per-type": {"combined_edge_lanes": False},
                 "per-edge": {"aggregate_first": False}}


def _sparse_pair(route, attention, compute_dtype="bfloat16"):
    overrides = {"hidden_size": H, "layer_timesteps": [2, 1, 1],
                 "residual_connections": {"2": [0]}, "use_edge_bias": True,
                 "use_propagation_attention": attention,
                 "compute_dtype": compute_dtype, **SPARSE_ROUTES[route]}
    config = _configs("sparse", overrides)
    batch, t_dim = _batch(seed=17)
    jax_model = JaxSparseGGNN(config, t_dim)
    params = jax_model.init_params(jax.random.PRNGKey(1))
    rng = np.random.RandomState(2)
    for layer in params["layers"]:
        layer["edge_biases"] = (0.3 * rng.randn(t_dim, H)).astype(np.float32)
        if attention:
            layer["attention"] = rng.uniform(0.5, 1.5, t_dim).astype(
                np.float32)
    model = SparseGGNN(config, t_dim, torch.Generator().manual_seed(0))
    model.load_state_dict(_bridged(params), strict=True)
    return jax_model, params, model, batch


@pytest.mark.parametrize("attention", [False, True])
@pytest.mark.parametrize("route", sorted(SPARSE_ROUTES))
def test_sparse_ggnn_in_bf16_matches_jax(route, attention):
    """The model's node states and the gradients of tanh(states).sum()
    for every parameter, each route, attention on and off."""
    jax_model, params, model, batch = _sparse_pair(route, attention)
    assert model.compute_dtype == torch.bfloat16
    want = np.asarray(jax_model.forward(params, batch))
    want_grads = _bridged(jax.grad(
        lambda p: jnp.sum(jnp.tanh(jax_model.forward(p, batch))))(params))
    out = model(_port_batch(batch, GraphBatch))
    assert out.dtype == torch.float32
    torch.tanh(out).sum().backward()
    _assert_model_matches(
        out.detach().numpy(), want,
        {k: p.grad.numpy() for k, p in model.named_parameters()},
        {k: v.numpy() for k, v in want_grads.items()}, TOL_SPARSE,
        TOL_SPARSE_GRAD)


@pytest.mark.parametrize("route", sorted(SPARSE_ROUTES))
def test_sparse_ggnn_bf16_is_close_to_f32(route):
    """The port in bf16 against the port in f32, the same weights, at
    JAX's own bound for its model (0.05 absolute on the states)."""
    _, _, model16, batch = _sparse_pair(route, True)
    _, _, model32, _ = _sparse_pair(route, True, "float32")
    model32.load_state_dict(model16.state_dict())
    port_batch = _port_batch(batch, GraphBatch)
    with torch.no_grad():
        out16, out32 = model16(port_batch), model32(port_batch)
    np.testing.assert_allclose(out16.numpy(), out32.numpy(), rtol=0,
                               atol=JAX_BF16_ATOL)


def _heads_params(jax_model, config, seed=1):
    key = jax.random.PRNGKey(seed)
    return {"graph": jax_model.init_params(key),
            "heads": jax_base.init_output_heads(key, config["hidden_size"],
                                                config["task_ids"])}


def _assert_step_matches(port, jax_model, jax_params, jb, cls):
    """A batch's node states and outputs (TOL_DENSE) and the masked
    regression loss's gradients for every parameter (TOL_DENSE_GRAD),
    the port's against JAX's."""
    def jax_loss(p):
        final = jax_model.forward(p["graph"], jb)
        computed = jax_model.readout(p["heads"], [0], final, jb)
        loss = jax_base.masked_regression_loss(
            computed, jb.targets, jb.target_mask, [0], {})[0]
        return loss, (final, computed)

    (_, (want, want_out)), jax_grads = jax.value_and_grad(
        jax_loss, has_aux=True)(jax_params)
    want_grads = params_from_jax_weights(_flatten_named(
        {"params": jax_grads}))
    batch = _port_batch(jb, cls)
    final = port.graph(batch)
    out = port.graph.readout(port.heads, [0], final, batch)
    loss, _ = base.masked_regression_loss(out, batch.targets,
                                          batch.target_mask, [0], {})
    names = [n for n, _ in port.named_parameters()]
    grads = torch.autograd.grad(loss, list(port.parameters()))
    assert _abs(out.detach().numpy(), np.asarray(want_out)) <= TOL_DENSE
    _assert_model_matches(
        final.detach().numpy(), np.asarray(want),
        {n: g.numpy() for n, g in zip(names, grads)},
        {n: v.numpy() for n, v in want_grads.items()}, TOL_DENSE,
        TOL_DENSE_GRAD)


def _port_params(model, config, jax_params):
    gen = torch.Generator().manual_seed(0)
    params = ModelParams(model, init_output_heads(
        gen, config["hidden_size"], config["task_ids"]))
    params.load_state_dict(params_from_jax_weights(
        _flatten_named({"params": jax_params})), strict=True)
    return params


DENSE_CASES = {
    "dense": ("dense", {"hidden_size": H, "dense_bucket_sizes": [16, 32]}),
    "blocked, attention and bias": ("blocked", {
        "hidden_size": H, "layer_timesteps": [2, 1, 1],
        "residual_connections": {"2": [0]}, "dense_bucket_sizes": [16, 32],
        "use_propagation_attention": True, "use_edge_bias": True}),
}


@pytest.mark.parametrize("case", sorted(DENSE_CASES))
def test_dense_ggnn_in_bf16_matches_jax(case):
    """Both modes of DenseGGNN (reference `dense`, extended `blocked`
    with attention and edge biases) over every bucket's batch."""
    variant, overrides = DENSE_CASES[case]
    config = _configs(variant, {**overrides, **BF16})
    data = synthetic_molecules(24, seed=13)
    t_dim = infer_metadata([data], config["tie_fwd_bkwd"]).num_edge_types
    bucketed, sizes = jax_packing.preprocess_dense(
        data, t_dim, config["tie_fwd_bkwd"], [0], {}, False,
        bucket_sizes=np.asarray(config["dense_bucket_sizes"]))
    batches = list(jax_packing.pack_dense_batches(
        bucketed, sizes, 8, H, 5, False, drop_remainder=False))
    jax_model = JaxDenseGGNN(config, t_dim)
    jax_params = _heads_params(jax_model, config)
    rng = np.random.RandomState(1)
    graph = jax_params["graph"]
    for holder in graph.get("layers", [graph]):
        if "edge_biases" in holder:
            holder["edge_biases"] = (0.3 * rng.randn(
                *holder["edge_biases"].shape)).astype(np.float32)
        if "attention" in holder:
            holder["attention"] = rng.uniform(
                0.5, 1.5, holder["attention"].shape).astype(np.float32)
    port = _port_params(DenseGGNN(config, t_dim,
                                  torch.Generator().manual_seed(0)),
                        config, jax_params)
    assert port.graph.compute_dtype == torch.bfloat16
    for jb in batches[:2]:
        _assert_step_matches(port, jax_model, jax_params, jb,
                             DenseGraphBatch)


def _gcn_case(variant, compute_dtype):
    small = {"hidden_size": H, "gcn_use_bias": True,
             "compute_dtype": compute_dtype}
    if variant == "gcn_blocked":
        small.update(dense_bucket_sizes=[16, 32], batch_size=8)
    else:
        small.update(batch_size=300)
    config = _configs(variant, small)
    data = synthetic_molecules(24, seed=13)
    if variant == "gcn":
        proc = jax_packing.preprocess_gcn(data, [0], {}, False)
        caps = jax_packing.plan_gcn_capacities(proc, config["batch_size"])
        batches = list(jax_packing.pack_gcn_batches(
            proc, config["batch_size"], caps, H, 5, False))
        jax_model, cls = JaxGCN(config), GCNGraphBatch
        model = GCN(config, torch.Generator().manual_seed(0))
    else:
        bucketed, sizes = jax_packing.preprocess_gcn_dense(
            data, [0], {}, False,
            bucket_sizes=np.asarray(config["dense_bucket_sizes"]))
        batches = list(jax_packing.pack_dense_batches(
            bucketed, sizes, config["batch_size"], H, 5, False,
            drop_remainder=False))
        jax_model, cls = JaxBlockedGCN(config), DenseGraphBatch
        model = BlockedGCN(config, torch.Generator().manual_seed(0))
    jax_params = _heads_params(jax_model, config)
    rng = np.random.RandomState(1)
    for layer in jax_params["graph"]["layers"]:
        layer["b"] = (0.3 * rng.randn(*layer["b"].shape)).astype(np.float32)
    return config, jax_model, jax_params, _port_params(
        model, config, jax_params), batches, cls


def test_blocked_gcn_in_bf16_matches_jax():
    _, jax_model, jax_params, port, batches, cls = _gcn_case(
        "gcn_blocked", "bfloat16")
    assert port.graph.compute_dtype == torch.bfloat16
    for jb in batches[:2]:
        _assert_step_matches(port, jax_model, jax_params, jb, cls)


def test_edge_list_gcn_runs_f32_under_the_key_as_jax_does():
    """The edge-list GCN has no compute_dtype in JAX: under the key both
    packages run f32, so the port matches JAX at the f32 model bound
    (2e-5) and its own f32 run bit for bit."""
    _, jax_model, jax_params, port, batches, cls = _gcn_case(
        "gcn", "bfloat16")
    _, _, _, port32, _, _ = _gcn_case("gcn", "float32")
    assert port.graph.compute_dtype == torch.float32
    jb = batches[0]
    batch = _port_batch(jb, cls)
    with torch.no_grad():
        out, out32 = port.graph(batch), port32.graph(batch)
    assert torch.equal(out, out32)
    np.testing.assert_allclose(
        out.numpy(), np.asarray(jax_model.forward(jax_params["graph"], jb)),
        rtol=2e-5, atol=2e-5)


def test_async_runs_f32_under_the_key_as_jax_does():
    """AsyncGGNN reads no compute_dtype in either package: the same
    weights give the same bits with the key as without it."""
    from ggnn_tpu_torch.data import async_schedule
    data = synthetic_molecules(12, seed=9)
    config = {"hidden_size": H, "propagation_rounds": 2,
              "propagation_substeps": 40, "use_edge_bias": False,
              "graph_rnn_cell": "GRU", "graph_rnn_activation": "tanh",
              "graph_state_dropout_keep_prob": 1.0}
    proc = async_schedule.preprocess_async(data, 4, True, 2, 40, [0], {},
                                           False, None)
    caps = async_schedule.plan_async_capacities(proc, 4, 200, 2)
    batch = next(async_schedule.pack_async_batches(
        proc, 4, 200, caps, 2, 40, H, 5, False, None)).to("cpu")
    model32 = AsyncGGNN(dict(config), 4, torch.Generator().manual_seed(0))
    model16 = AsyncGGNN({**config, **BF16}, 4,
                        torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert torch.equal(model16(batch), model32(batch))


# ------------------------------------------- Runner, Predictor, export

def test_runner_on_the_bf16_config_matches_jax_over_two_epochs(tmp_path):
    """configs/sparse_wide_bf16.json at hidden 16 (its edge-weight
    dropout off: the two packages draw different masks), two epochs of
    the port's Runner against JAX's from the same weights: each epoch's
    train and valid loss within TOL_RUNNER, relative."""
    config_file = "configs/sparse_wide_bf16.json"
    overrides = json.dumps({"hidden_size": H, "batch_size": 300,
                            "num_epochs": 2, "native_pack": False,
                            "random_seed": 3, **NO_DROPOUT})
    config = resolve_config("sparse", config_file, overrides)
    assert config == jax_resolve_config("sparse", config_file, overrides)
    assert config["compute_dtype"] == "bfloat16"
    train = synthetic_molecules(40, seed=11)
    valid = synthetic_molecules(12, seed=12)
    jax_runner = JaxRunner("sparse", dict(config), train_data=train,
                           valid_data=valid, log_dir=str(tmp_path / "jax"),
                           quiet=True, tensorboard=False)
    port_runner = Runner("sparse", dict(config), train_data=train,
                         valid_data=valid, log_dir=str(tmp_path / "port"),
                         quiet=True, device="cpu")
    port_runner.params.load_state_dict(params_from_jax_weights(
        _flatten_named({"params": jax_runner.state["params"]})),
        strict=True)
    jax_log, port_log = jax_runner.train(), port_runner.train()
    assert len(port_log) == len(jax_log) == 2
    for got, want in zip(port_log, jax_log):
        for split in ("train_results", "valid_results"):
            assert np.isfinite(got[split][0])
            assert _rel(got[split][0], want[split][0]) <= TOL_RUNNER, split


def _bf16_checkpoint(path, overrides=None):
    config = resolve_config("sparse", "configs/sparse_wide_bf16.json",
                            json.dumps({"hidden_size": H,
                                        "native_pack": False,
                                        "use_propagation_attention": True,
                                        **(overrides or {})}))
    gen = torch.Generator().manual_seed(0)
    adapter = make_adapter("sparse", config, DatasetMeta(64, 4, H))
    params = ModelParams(adapter.build_model(gen),
                         init_output_heads(gen, H, config["task_ids"]))
    save_checkpoint(str(path), config, params, 0, 0)
    return str(path)


@pytest.fixture(scope="module")
def bf16_predictor(tmp_path_factory):
    path = _bf16_checkpoint(tmp_path_factory.mktemp("bf16") / "m.pickle")
    return path, Predictor.from_checkpoint(path, "sparse", device="cpu",
                                           max_nodes=256, max_graphs=32)


def test_bf16_predictor_matches_the_jax_predictor(bf16_predictor):
    """A bf16 checkpoint (attention on) served by the port's Predictor
    and by JAX's, one and 20 graphs."""
    path, live = bf16_predictor
    assert live.params.graph.compute_dtype == torch.bfloat16
    jax_live = JaxPredictor.from_checkpoint(path, "sparse", max_nodes=256,
                                            max_graphs=32)
    for mols in (synthetic_molecules(1, seed=4),
                 synthetic_molecules(20, seed=5)):
        got, want = live(mols), np.asarray(jax_live(mols))
        assert got.shape == want.shape and _abs(got, want) <= TOL_PREDICTOR


def test_bf16_artifact_round_trip(bf16_predictor, tmp_path):
    """A bf16 Predictor exported and loaded on the CPU answers as the
    live one (1e-6, the artifact bound of tests/test_torch_export.py),
    and its program calls the bf16-in, f32-out product as an op."""
    import io
    import zipfile
    _, live = bf16_predictor
    path = str(tmp_path / "bf16.ggnnx")
    export_predictor(live, path)
    exported = load_predictor(path, device="cpu")
    mols = synthetic_molecules(7, seed=6)
    np.testing.assert_allclose(exported(mols), live(mols), rtol=1e-6,
                               atol=1e-7)
    with zipfile.ZipFile(path) as z:
        meta = json.loads(z.read("meta.json"))
        program = torch.export.load(io.BytesIO(z.read(
            meta["functions"][0]["file"])))
    targets = [str(n.target) for n in program.graph.nodes
               if n.op == "call_function"]
    steps = sum(live.config["layer_timesteps"])
    assert targets.count("ggnn_tpu_torch.product_f32.default") == steps
    assert targets.count(
        "ggnn_tpu_torch.weighted_gather_segment_sum.default") == steps
