"""The mesh's host-side layouts (ggnn_tpu_torch.parallel, ROADMAP A11)
against the JAX package's, with no process group: the stacks, the node
shards of each exchange layout, the type-TP slices and `dfs_reorder`,
every array equal to the JAX function's on the same numpy input; the
capacity errors; a one-shard layout's forward against the single-device
forward (rtol 1e-5 / atol 1e-6: f32 sums in another order); and the
checks the mesh, the steps and the exchange choice make before any
collective runs."""

import dataclasses
import json
import types

import jax
import numpy as np
import pytest
import torch

from ggnn_tpu.data.reorder import dfs_reorder as jax_dfs_reorder
from ggnn_tpu.graph import DenseGraphBatch as JaxDenseBatch
from ggnn_tpu.graph import GCNGraphBatch as JaxGCNBatch
from ggnn_tpu.graph import GraphBatch as JaxGraphBatch
from ggnn_tpu.models.base import init_output_heads as jax_heads
from ggnn_tpu.parallel import node_shard as jax_ns
from ggnn_tpu.parallel import stacking as jax_stacking
from ggnn_tpu.parallel import tp as jax_tp
from ggnn_tpu.training.checkpoint import _flatten_named
from ggnn_tpu.training.variants import make_adapter as jax_make_adapter
from ggnn_tpu_torch.data.loader import infer_metadata
from ggnn_tpu_torch.data.reorder import dfs_reorder
from ggnn_tpu_torch.data.synthetic import (synthetic_giant_graph,
                                           synthetic_molecules)
from ggnn_tpu_torch.models.base import ModelParams, init_output_heads
from ggnn_tpu_torch.parallel import node_shard, stacking, tp
from ggnn_tpu_torch.parallel.mesh import (DATA_AXIS, EDGE_AXIS, Axis, Mesh,
                                          make_mesh)
from ggnn_tpu_torch.parallel.step import make_parallel_steps
from ggnn_tpu_torch.training.checkpoint import (_module_name,
                                                params_from_jax_weights)
from ggnn_tpu_torch.training.config import resolve_config
from ggnn_tpu_torch.training.optimizer import TFAdam
from ggnn_tpu_torch.training.runner import Runner
from ggnn_tpu_torch.training.variants import make_adapter

torch.set_num_threads(1)

SMALL = {"hidden_size": 8, "layer_timesteps": [2, 1],
         "residual_connections": {"1": [0]}, "native_pack": False,
         "use_propagation_attention": True, "use_edge_bias": True,
         "edge_weight_dropout_keep_prob": 1.0,
         "graph_state_dropout_keep_prob": 1.0}
FWD_TOL = dict(rtol=1e-5, atol=1e-6)


def _batches(variant, over, data):
    config = resolve_config(variant, config_json=json.dumps({**SMALL,
                                                              **over}))
    meta = infer_metadata([data], config["tie_fwd_bkwd"])
    adapter = make_adapter(variant, config, meta)
    processed = adapter.preprocess(data, False)
    adapter.plan(processed)
    return config, meta, list(adapter.batches(processed, False))


@pytest.fixture(scope="module")
def sparse():
    return _batches("sparse", {"batch_size": 160},
                    synthetic_molecules(48, seed=3))


@pytest.fixture(scope="module")
def giant():
    return _batches("sparse", {"batch_size": 420},
                    synthetic_giant_graph(400, seed=5))


@pytest.fixture(scope="module")
def gcn():
    return _batches("gcn", {"batch_size": 160},
                    synthetic_molecules(48, seed=3))


def _jax_like(batch, cls):
    return cls(**{f.name: getattr(batch, f.name)
                  for f in dataclasses.fields(batch)})


def _assert_leaves_equal(got, want, prefix=""):
    """Every leaf of a port batch equal to the JAX one's, dtypes
    included; a port stack (a list) against JAX's stacked batch."""
    if isinstance(got, list):
        for i, b in enumerate(got):
            _assert_leaves_equal(b, jax.tree_util.tree_map(
                lambda x: np.asarray(x)[i], want), f"{prefix}[{i}].")
        return
    if isinstance(got, tuple):
        assert isinstance(want, tuple) and len(got) == len(want), prefix
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_leaves_equal(g, w, f"{prefix}{i}.")
        return
    if dataclasses.is_dataclass(got):
        for f in dataclasses.fields(got):
            g, w = getattr(got, f.name), getattr(want, f.name)
            if g is None or isinstance(g, (bool, int)):
                assert g == w, prefix + f.name
            else:
                _assert_leaves_equal(g, w, f"{prefix}{f.name}.")
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, prefix
    np.testing.assert_array_equal(got, want, err_msg=prefix)


# ------------------------------------------------------------ stacking

@pytest.mark.parametrize("n_data,count,combined", [
    (2, 3, False), (2, 4, True), (4, 3, True), (1, 2, False)])
def test_stack_batches_matches_jax(sparse, n_data, count, combined):
    _, _, batches = sparse
    got = stacking.stack_batches(batches[:count], n_data,
                                 keep_combined=combined)
    want = jax_stacking.stack_batches(
        [_jax_like(b, JaxGraphBatch) for b in batches[:count]], n_data,
        keep_combined=combined)
    assert len(got) % n_data == 0 and len(got) >= count
    _assert_leaves_equal(got, want)
    rows = [stacking.rows_of(got, types.SimpleNamespace(
        shape={DATA_AXIS: n_data}, data=types.SimpleNamespace(index=d)))
        for d in range(n_data)]
    assert [b for r in rows for b in r] == got


def test_empty_batch_and_repad_match_jax(sparse):
    _, _, batches = sparse
    b = batches[0]
    jb = _jax_like(b, JaxGraphBatch)
    _assert_leaves_equal(stacking.empty_batch_like(b),
                         jax_stacking.empty_batch_like(jb))
    e_cap = b.edge_sources.shape[1] + 13
    _assert_leaves_equal(stacking.repad_edges(b, e_cap),
                         jax_stacking.repad_edges(jb, e_cap))
    empty = stacking.empty_batch_like(b)
    assert int(empty.num_graphs) == 0
    assert float(np.sum(empty.target_mask)) == 0.0
    with pytest.raises(ValueError, match="cannot shrink"):
        stacking.repad_edges(b, 1)
    with pytest.raises(ValueError, match="no batches"):
        stacking.stack_batches([], 2)


def test_dense_and_any_stacking_match_jax(gcn):
    _, _, gcn_batches = gcn
    config, _, dense = _batches("blocked", {"batch_size": 8,
                                            "dense_bucket_sizes": [32]},
                                synthetic_molecules(40, seed=4))
    got = stacking.stack_dense_batches(dense[:3], 2)
    want = jax_stacking.stack_dense_batches(
        [_jax_like(b, JaxDenseBatch) for b in dense[:3]], 2)
    _assert_leaves_equal(got, want)
    _assert_leaves_equal(stacking.empty_dense_batch_like(dense[0]),
                         jax_stacking.empty_dense_batch_like(
                             _jax_like(dense[0], JaxDenseBatch)))
    got = stacking.stack_any_batches(gcn_batches[:3], 2,
                                     stacking.empty_masked_batch_like)
    want = jax_stacking.stack_any_batches(
        [_jax_like(b, JaxGCNBatch) for b in gcn_batches[:3]], 2,
        jax_stacking.empty_masked_batch_like)
    _assert_leaves_equal(got, want)
    with pytest.raises(ValueError, match="empty_fn"):
        stacking.stack_any_batches(gcn_batches[:3], 2)
    _, _, two = _batches("blocked", {"batch_size": 4,
                                     "dense_bucket_sizes": [16, 32]},
                         synthetic_molecules(40, seed=4))
    with pytest.raises(ValueError, match="one bucket shape"):
        stacking.stack_dense_batches(two, 2)


# ---------------------------------------------------------- node shards

@pytest.mark.parametrize("data", ["sparse", "giant"])
@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("exchange",
                         ["alltoall", "shift", "ragged", "ragged_emulated"])
def test_node_shard_layout_matches_jax(request, data, n_shards, exchange):
    _, _, batches = request.getfixturevalue(data)
    jbatches = [_jax_like(b, JaxGraphBatch) for b in batches]
    caps = node_shard.plan_node_shard_caps(batches, n_shards)
    jcaps = jax_ns.plan_node_shard_caps(jbatches, n_shards)
    assert dataclasses.asdict(caps) == dataclasses.asdict(jcaps)
    for b, jb in zip(batches, jbatches):
        _assert_leaves_equal(node_shard.shard_batch(b, caps, exchange),
                             jax_ns.shard_batch(jb, jcaps, exchange))
    got = node_shard.shard_and_stack(batches[:3], caps, 2, exchange)
    want = jax_ns.shard_and_stack(jbatches[:3], jcaps, 2, exchange)
    assert len(got) == -(-min(3, len(batches)) // 2) * 2
    _assert_leaves_equal(got, want)
    if data == "giant":
        assert float(np.asarray(got[0].bnd_mask).sum()) > 100


@pytest.mark.parametrize("exchange", ["alltoall", "shift", "ragged"])
def test_gcn_node_shard_layout_matches_jax(gcn, exchange):
    _, _, batches = gcn
    jbatches = [_jax_like(b, JaxGCNBatch) for b in batches]
    caps = node_shard.plan_gcn_shard_caps(batches, 4)
    jcaps = jax_ns.plan_gcn_shard_caps(jbatches, 4)
    assert dataclasses.asdict(caps) == dataclasses.asdict(jcaps)
    for b, jb in zip(batches, jbatches):
        _assert_leaves_equal(node_shard.shard_gcn_batch(b, caps, exchange),
                             jax_ns.shard_gcn_batch(jb, jcaps, exchange))
    _assert_leaves_equal(
        node_shard.gcn_shard_and_stack(batches[:3], caps, 2, exchange),
        jax_ns.gcn_shard_and_stack(jbatches[:3], jcaps, 2, exchange))


def test_local_view_and_device_copy(giant):
    """A shard's view drops the shard axis; on a device copy the ragged
    routing rows, like the rows to gather, are int32 tensors (the split
    sizes stay on the device)."""
    _, _, batches = giant
    caps = node_shard.plan_node_shard_caps(batches, 4)
    sharded = node_shard.shard_batch(batches[0], caps, "ragged")
    view = sharded.local_view(2).to("cpu")
    assert view.node_features.shape == (caps.nodes_local,
                                        batches[0].node_features.shape[1])
    spec = view.send_idx
    for name in ("input_offsets", "send_sizes", "output_offsets",
                 "recv_sizes"):
        row = getattr(spec, name)
        assert isinstance(row, torch.Tensor) and row.dtype == torch.int32
        np.testing.assert_array_equal(
            row.numpy(), np.asarray(getattr(sharded.send_idx, name))[2])
    assert isinstance(spec.gather, torch.Tensor)
    assert node_shard.table_rows(spec) == caps.boundary_recv_total
    assert isinstance(view.num_graphs, int)


def test_node_shard_boundary_capacity_overflow_raises(sparse):
    _, _, batches = sparse
    b = batches[0]
    good = node_shard.plan_node_shard_caps([b], 4)
    bad = node_shard.NodeShardCaps(
        n_shards=4, nodes_local=good.nodes_local,
        edges_local=good.edges_local, edges_boundary=good.edges_boundary,
        boundary=0)
    jbad = jax_ns.NodeShardCaps(**dataclasses.asdict(bad))
    src = np.asarray(b.edge_sources)[np.asarray(b.edge_mask) > 0]
    tgt = np.asarray(b.edge_targets)[np.asarray(b.edge_mask) > 0]
    assert np.any(src // good.nodes_local != tgt // good.nodes_local)
    for shard, caps in ((node_shard.shard_batch, bad),
                        (jax_ns.shard_batch, jbad)):
        with pytest.raises(ValueError, match="boundary capacity"):
            shard(b, caps)
    bad_lane = dataclasses.replace(bad, edges_local=0,
                                   boundary=good.boundary)
    with pytest.raises(ValueError, match="local edge capacity"):
        node_shard.shard_batch(b, bad_lane)
    ragged = dataclasses.replace(good, boundary_send_total=0,
                                 boundary_recv_total=0)
    with pytest.raises(ValueError, match="ragged send total"):
        node_shard.shard_batch(b, ragged, "ragged")


def test_shard_batch_rejects_undersized_layout(sparse):
    _, _, batches = sparse
    caps = node_shard.plan_node_shard_caps(batches, 2)
    small = dataclasses.replace(caps,
                                nodes_local=batches[0].node_capacity // 4)
    with pytest.raises(ValueError, match="exceeds the shard layout"):
        node_shard.shard_batch(batches[0], small)


def test_plan_caps_nodes_local_pin(sparse):
    _, _, batches = sparse
    caps = node_shard.plan_node_shard_caps(batches, 2, margin=1.0)
    need = node_shard.plan_node_shard_caps(batches[:1], 2, margin=1.0,
                                           nodes_local=caps.nodes_local)
    assert need.nodes_local == caps.nodes_local
    jneed = jax_ns.plan_node_shard_caps(
        [_jax_like(batches[0], JaxGraphBatch)], 2, margin=1.0,
        nodes_local=caps.nodes_local)
    assert dataclasses.asdict(need) == dataclasses.asdict(jneed)
    grown = dataclasses.replace(
        caps, edges_local=max(caps.edges_local, need.edges_local),
        edges_boundary=max(caps.edges_boundary, need.edges_boundary))
    node_shard.shard_batch(batches[0], grown)  # must not raise


def test_merge_grown_caps_takes_the_larger_of_each():
    old = node_shard.NodeShardCaps(2, 40, 64, 8, 16, (16,), 24, 32)
    grown = node_shard.NodeShardCaps(2, 32, 80, 16, 8, (24,), 16, 40)
    merged = Runner._merge_grown_caps(old, grown)
    assert merged == node_shard.NodeShardCaps(2, 40, 80, 16, 16, (24,),
                                              24, 40)


@pytest.mark.parametrize("exchange", ["alltoall", "shift", "ragged"])
def test_one_shard_layout_forward_matches_single_device(sparse, gcn,
                                                        exchange):
    """A one-shard layout runs the node-sharded forward end to end with
    no collective (its exchange moves nothing): the sparse GGNN (with
    attention and edge biases) and the GCN match their single-device
    forwards and readouts."""
    for config, meta, batches, variant in ((*sparse, "sparse"),
                                           (*gcn, "gcn")):
        adapter = make_adapter(variant, config, meta)
        gen = torch.Generator().manual_seed(5)
        params = ModelParams(adapter.build_model(gen), init_output_heads(
            gen, config["hidden_size"], config["task_ids"]))
        plan = (node_shard.plan_gcn_shard_caps if variant == "gcn"
                else node_shard.plan_node_shard_caps)
        shard = (node_shard.shard_gcn_batch if variant == "gcn"
                 else node_shard.shard_batch)
        for b in batches[:2]:
            caps = plan([b], 1)
            view = shard(b, caps, exchange).local_view(0).to("cpu")
            plain = b.to("cpu")
            with torch.no_grad():
                want = params.graph(plain)
                got = params.graph(view)
                n = b.node_capacity
                np.testing.assert_allclose(got[:n].numpy(),
                                           want[:n].numpy(), **FWD_TOL)
                np.testing.assert_allclose(
                    params.graph.readout(params.heads, config["task_ids"],
                                         got, view).numpy(),
                    params.graph.readout(params.heads, config["task_ids"],
                                         want, plain).numpy(), **FWD_TOL)


def test_exchange_without_an_axis_moves_nothing(giant):
    _, _, batches = giant
    h = torch.randn(128, 8)
    for exchange in ("alltoall", "shift", "ragged"):
        caps = node_shard.plan_node_shard_caps(batches, 1)
        view = node_shard.shard_batch(batches[0], caps,
                                      exchange).local_view(0).to("cpu")
        table = node_shard.exchange_boundary(h, view.send_idx, None, 8)
        assert table.shape[0] == node_shard.table_rows(view.send_idx)
        if exchange == "ragged":
            assert not table.any()


# -------------------------------------------------------------- type-TP

def test_type_tp_slices_match_jax_partition(sparse):
    """shard_lanes gives edge rank e the e-th of P type blocks of the
    per-type lanes, as tp_batch_specs splits them; shard_parameters keeps
    the same block of edge_weights, attention and their Adam moments,
    the leaves JAX's path predicate shards."""
    config, meta, batches = sparse
    t_dim = meta.num_edge_types
    stack = stacking.stack_batches(batches[:2], 1)
    jstack = jax_stacking.stack_batches(
        [_jax_like(b, JaxGraphBatch) for b in batches[:2]], 1)
    for n_tp in (2, 4):
        per = t_dim // n_tp
        for e in range(n_tp):
            axis = Axis(EDGE_AXIS, n_tp, e, tuple(range(n_tp)))
            for i, b in enumerate(stack):
                got = tp.shard_lanes(b, axis)
                for f in ("edge_sources", "edge_targets", "edge_mask"):
                    np.testing.assert_array_equal(
                        getattr(got, f),
                        np.asarray(getattr(jstack, f))[i,
                                                       e * per:(e + 1) * per])
                np.testing.assert_array_equal(got.in_degrees, b.in_degrees)
    with pytest.raises(ValueError, match="divisible"):
        tp.validate_tp(t_dim, 3)
    with pytest.raises(ValueError, match="per-type lanes"):
        tp.shard_lanes(batches[0], Axis(EDGE_AXIS, 2, 0, (0, 1)))

    # The predicate: the port's names against JAX's paths.
    adapter = jax_make_adapter("sparse", dict(config), meta)
    model = adapter.build_model()
    key = jax.random.PRNGKey(0)
    tree = {"graph": model.init_params(key),
            "heads": jax_heads(key, config["hidden_size"],
                               config["task_ids"])}
    want = {_module_name("['params']" + jax.tree_util.keystr(path))
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]
            if jax_tp.is_tp_sharded_path(path)}
    names = params_from_jax_weights(_flatten_named({"params": tree}))
    port = {n for n in names if tp.is_tp_sharded_path(n)}
    assert port == want == {f"graph.layers.{i}.{leaf}" for i in range(2)
                            for leaf in ("edge_weights", "attention")}
    assert not tp.is_tp_sharded_path("heads.task0.attention")

    port_adapter = make_adapter("sparse", config, meta)
    gen = torch.Generator().manual_seed(0)
    params = ModelParams(port_adapter.build_model(gen), init_output_heads(
        gen, config["hidden_size"], config["task_ids"]))
    full = {n: p.detach().clone() for n, p in params.named_parameters()}
    opt = TFAdam(params, 1e-3, 1.0)
    for n in opt.mu:
        opt.mu[n] += 1.0
        opt.nu[n] += 2.0
    tp.shard_parameters(params, opt, Axis(EDGE_AXIS, 2, 1, (0, 1)), t_dim)
    for n, p in params.named_parameters():
        want_p = full[n][t_dim // 2:] if n in port else full[n]
        assert torch.equal(p.detach(), want_p), n
        assert opt.params[n] is p and opt.mu[n].shape == p.shape
        assert float(opt.nu[n].mean()) == 2.0


def test_dfs_reorder_matches_jax():
    graphs = synthetic_molecules(6, seed=8) + synthetic_giant_graph(
        300, seed=2)
    for g in graphs:
        assert dfs_reorder(g) == jax_dfs_reorder(g)
    with pytest.raises(ValueError, match="out of range"):
        dfs_reorder({"targets": [[0.0]], "graph": [[0, 1, -1]],
                     "node_features": [[1.0], [0.0]]})


# ------------------------------------------------- checks before a step

def _fake_mesh(n_data, n_edge, backend="gloo", device="cpu"):
    axis = lambda name, size: Axis(name, size, 0, tuple(range(size)),
                                   None, frozenset(), backend)
    return Mesh(shape={DATA_AXIS: n_data, EDGE_AXIS: n_edge}, rank=0,
                device=torch.device(device), backend=backend,
                data=axis(DATA_AXIS, n_data), edge=axis(EDGE_AXIS, n_edge),
                world=axis("world", n_data * n_edge))


def test_make_mesh_errors_without_a_group():
    """One process and no group: a 1 x 1 mesh; the shapes JAX refuses on
    one device, refused alike; the options that make no sense raise."""
    mesh = make_mesh(device="cpu")
    assert mesh.shape == {DATA_AXIS: 1, EDGE_AXIS: 1} and mesh.rank == 0
    assert mesh.axis(EDGE_AXIS) is mesh.edge and mesh.size == 1
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        make_mesh(2, 1, device="cpu")
    with pytest.raises(ValueError, match="not divisible by n_edge=3"):
        make_mesh(None, 3, device="cpu")
    with pytest.raises(ValueError, match="unknown collectives"):
        make_mesh(device="cpu", host_staged=("p2p", "scatter"))
    with pytest.raises(ValueError, match="host staging"):
        make_mesh(device="cpu", host_staged=("p2p",))
    with pytest.raises(ValueError, match="no mesh axis"):
        mesh.axis("model")


def test_shift_refuses_cuda_over_gloo_unstaged():
    """Gloo sends no CUDA tensor point to point: an unstaged shift of one
    raises before any transfer (a CUDA tensor stands in: no card here)."""
    axis = Axis(EDGE_AXIS, 2, 0, (0, 1), object(), frozenset(), "gloo")
    with pytest.raises(ValueError, match="host_staged"):
        axis.shift(types.SimpleNamespace(is_cuda=True), 1)


def test_make_parallel_steps_refuses_what_jax_refuses(sparse):
    config, meta, _ = sparse
    adapter = make_adapter("sparse", config, meta)
    gen = torch.Generator().manual_seed(0)
    params = ModelParams(adapter.build_model(gen), init_output_heads(
        gen, config["hidden_size"], config["task_ids"]))
    opt = TFAdam(params, 1e-3, 1.0)
    for kind in ("dense", "data_only"):
        with pytest.raises(ValueError, match="data-parallel only"):
            make_parallel_steps(params, opt, config, [0], _fake_mesh(1, 2),
                                batch_kind=kind)
    with pytest.raises(ValueError, match="edge_axis='edge'"):
        make_parallel_steps(params, opt, config, [0], _fake_mesh(1, 2))
    with pytest.raises(ValueError, match="unknown batch_kind"):
        make_parallel_steps(params, opt, config, [0], _fake_mesh(1, 1),
                            batch_kind="ring")
    mesh = _fake_mesh(1, 2)
    tp_params = ModelParams(adapter.build_model(gen, edge_axis=mesh.edge),
                            params.heads)
    with pytest.raises(ValueError, match="tp_axis"):
        make_parallel_steps(tp_params, TFAdam(tp_params, 1e-3, 1.0), config,
                            [0], mesh, batch_kind="sparse_tp")
    with pytest.raises(TypeError, match="mesh Axis"):
        adapter.build_model(gen, edge_axis="edge")


def test_boundary_exchange_auto_resolves_per_backend():
    """"auto" takes the ragged exchange where the backend's all-to-all
    takes per-pair split sizes on the mesh's device (gloo on the CPU,
    gloo and nccl on the card), and the shift exchange elsewhere; any
    other value is the config's."""
    def resolve(value, backend, device):
        runner = types.SimpleNamespace(
            config={} if value is None else {"boundary_exchange": value},
            mesh=_fake_mesh(1, 2, backend, device))
        return Runner._resolve_exchange(runner)
    assert resolve("auto", "gloo", "cpu") == "ragged"
    assert resolve("auto", "gloo", "cuda") == "ragged"
    assert resolve("auto", "nccl", "cuda") == "ragged"
    assert resolve("auto", "mpi", "cpu") == "shift"
    assert resolve(None, "nccl", "cuda") == "alltoall"
    assert resolve("shift", "nccl", "cuda") == "shift"
