"""The port's async slice (ggnn_tpu_torch: data/async_schedule.py,
models/async_ggnn.py, the adapter, the checkpoint split of a stacked
leaf and the Predictor for `async`) against the JAX package, on the CPU,
where the receiver sums run the plain versions of kernels B1 and B2.

Tolerances, each with its reason:
  * preprocessing, plans and packed batches: bit for bit;
  * node states against the JAX model: 2e-5 (tests/test_tf1_golden.py
    pins 2e-5 for the JAX models), predictions 2e-5;
  * gradients against jax.grad: 1e-4 relative to each leaf's largest
    entry (f32 sums in another order through R rounds of substeps);
  * remat on against off: 1e-6 (the same operations, recomputed);
  * the port's compact path against its plain path: 1e-5 / 1e-6, the
    bound tests/test_models.py holds the JAX paths to.
"""

import dataclasses
import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggnn_tpu.data import async_schedule as jax_async
from ggnn_tpu.data.synthetic import synthetic_molecules
from ggnn_tpu.models import base as jax_base
from ggnn_tpu.models.async_ggnn import AsyncGGNN as JaxAsyncGGNN
from ggnn_tpu.serving import Predictor as JaxPredictor
from ggnn_tpu.training.checkpoint import _flatten_named
from ggnn_tpu.training.checkpoint import save_checkpoint as jax_save
from ggnn_tpu.training.config import resolve_config as jax_resolve_config
from ggnn_tpu_torch.data import async_schedule
from ggnn_tpu_torch.data.loader import DatasetMeta
from ggnn_tpu_torch.graph import AsyncGraphBatch
from ggnn_tpu_torch.models.async_ggnn import AsyncGGNN, compact_dump_row
from ggnn_tpu_torch.models.base import ModelParams, init_output_heads
from ggnn_tpu_torch.ops.kernels import ell_spmm
from ggnn_tpu_torch.serving import Predictor
from ggnn_tpu_torch.training import checkpoint
from ggnn_tpu_torch.training.config import ASYNC_DEFAULTS, resolve_config
from ggnn_tpu_torch.training.optimizer import TFAdam
from ggnn_tpu_torch.training.variants import make_adapter

torch.set_num_threads(1)

TOL = dict(rtol=2e-5, atol=2e-5)
H = 16
T = 4
# The synthetic corpus reaches schedule depth 17; the default 15 raises.
S = 40
# Graphs the schedule treats apart: an isolated node, an edgeless graph,
# a self-loop.
ODD_GRAPHS = [
    {"targets": [[0.5]], "graph": [[0, 1, 1]],
     "node_features": [[1, 0, 0, 0, 0], [0, 1, 0, 0, 0], [0, 0, 1, 0, 0]]},
    {"targets": [[-0.2]], "graph": [],
     "node_features": [[1, 0, 0, 0, 0], [0, 0, 0, 1, 0]]},
    {"targets": [[0.3]], "graph": [[0, 2, 1], [1, 1, 2], [2, 3, 2]],
     "node_features": [[0, 1, 0, 0, 0], [0, 0, 1, 0, 0], [1, 0, 0, 0, 0]]},
]


def _model_config(rounds=2, **overrides):
    return {"hidden_size": H, "propagation_rounds": rounds,
            "propagation_substeps": S, "use_edge_bias": False,
            "graph_rnn_cell": "GRU", "graph_rnn_activation": "tanh",
            "graph_state_dropout_keep_prob": 1.0, **overrides}


def _assert_identical(got, want, name="batch"):
    """Leaf for leaf, dtypes included, through segments and tuples."""
    if dataclasses.is_dataclass(want):
        assert type(got).__name__ == type(want).__name__, name
        for field in dataclasses.fields(want):
            _assert_identical(getattr(got, field.name),
                              getattr(want, field.name),
                              f"{name}.{field.name}")
    elif isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want), name
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_identical(a, b, f"{name}[{i}]")
    elif want is None:
        assert got is None, name
    else:
        a, b = np.asarray(got), np.asarray(want)
        assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=name)


def _both_preprocessed(raw, rounds=2, tie=True, t_dim=T, training=False):
    args = (raw, t_dim, tie, rounds, S, [0], {}, training)
    return (async_schedule.preprocess_async(
                *args, np.random.RandomState(1) if training else None),
            jax_async.preprocess_async(
                *args, np.random.RandomState(1) if training else None))


def _both_batches(raw, rounds=2, budget=200, training=False, caps=None):
    """(port batches, JAX batches, caps) of one corpus: the same plan,
    the JAX flat packer (no corpus cache) and the same RandomState."""
    port_proc, jax_proc = _both_preprocessed(raw, rounds)
    if caps is None:
        caps = async_schedule.plan_async_capacities(port_proc, T, budget,
                                                    rounds)
    jax_caps = jax_async.AsyncCapacities(**dataclasses.asdict(caps))
    rng = (lambda: np.random.RandomState(3)) if training else (lambda: None)
    port = list(async_schedule.pack_async_batches(
        port_proc, T, budget, caps, rounds, S, H, 5, training, rng()))
    want = list(jax_async.pack_async_batches(
        jax_proc, T, budget, jax_caps, rounds, S, H, 5, training, rng(),
        use_flat=True))
    return port, want, caps


# ------------------------------------------------------ preprocessing

def test_config_key_set_equals_jax():
    assert resolve_config("async") == jax_resolve_config("async")
    assert ASYNC_DEFAULTS["propagation_substeps"] == 15


@pytest.mark.parametrize("tie", [True, False])
def test_preprocess_async_identical_to_jax(tie):
    """Flat tables, labels and the training shuffle, tied and untied,
    with an isolated node, an edgeless graph and a self-loop."""
    raw = synthetic_molecules(20, seed=5) + ODD_GRAPHS
    t_dim = T if tie else 2 * T
    port, want = _both_preprocessed(raw, 4, tie, t_dim, training=True)
    assert len(port) == len(want) == len(raw)
    for got, ref in zip(port, want):
        np.testing.assert_array_equal(got["init"], ref["init"])
        assert got["labels"] == ref["labels"]
        _assert_identical(got["flat_schedules"], ref["flat_schedules"])


def test_schedule_quirks_and_errors_match_jax():
    """The self-loop is dropped from the schedule; the isolated node and
    the edgeless graph's nodes are initial in every round; an
    out-of-range type, a schedule deeper than the substeps and an odd
    round count raise ValueError in both packages."""
    loop, isolated, edgeless = ODD_GRAPHS[2], ODD_GRAPHS[0], ODD_GRAPHS[1]
    for g in (loop, isolated, edgeless):
        got = async_schedule.graph_to_propagation_schedules(
            g["graph"], T, True, 2, S, num_nodes=len(g["node_features"]))
        want = jax_async.graph_to_propagation_schedules(
            g["graph"], T, True, 2, S, num_nodes=len(g["node_features"]))
        for (gi, gs, gm, gr), (wi, ws, wm, wr) in zip(got, want):
            np.testing.assert_array_equal(gi, wi)
            assert [list(map(list, x)) for x in gs] == \
                [list(map(list, x)) for x in ws]
            assert [list(map(list, x)) for x in gm] == \
                [list(map(list, x)) for x in wm]
            assert [list(x) for x in gr] == [list(x) for x in wr]
            async_schedule.check_schedule_invariants((gi, gs, gm, gr), T)
    without_loop = async_schedule.graph_to_propagation_schedules(
        loop["graph"][:2], T, True, 2, S, num_nodes=3)
    with_loop = async_schedule.graph_to_propagation_schedules(
        loop["graph"], T, True, 2, S, num_nodes=3)
    assert repr(with_loop) == repr(without_loop)
    assert 2 in async_schedule.graph_to_propagation_schedules(
        isolated["graph"], T, True, 2, S, num_nodes=3)[0][0]
    chain = [[i, 1, i + 1] for i in range(20)]
    for module in (async_schedule, jax_async):
        with pytest.raises(ValueError, match="out of range"):
            module.graph_to_propagation_schedules([[0, 5, 1]], T, True, 2, S)
        with pytest.raises(ValueError, match="propagation_substeps"):
            module.graph_to_propagation_schedules(chain, T, True, 2, 15)
        with pytest.raises(ValueError, match="even"):
            module.graph_to_propagation_schedules(chain, T, True, 3, S)


def test_plan_identical_to_jax_over_two_splits():
    train = async_schedule.preprocess_async(
        synthetic_molecules(40, seed=6), T, True, 4, S, [0], {}, False)
    valid = async_schedule.preprocess_async(
        synthetic_molecules(12, seed=7) + ODD_GRAPHS, T, True, 4, S, [0], {},
        False)
    jax_train = jax_async.preprocess_async(
        synthetic_molecules(40, seed=6), T, True, 4, S, [0], {}, False)
    jax_valid = jax_async.preprocess_async(
        synthetic_molecules(12, seed=7) + ODD_GRAPHS, T, True, 4, S, [0], {},
        False)
    for margin in (None, 1.3):
        got = async_schedule.plan_async_capacities_multi(
            [train, valid], T, 250, 4, margin)
        want = jax_async.plan_async_capacities_multi(
            [jax_train, jax_valid], T, 250, 4, margin)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert len(got.plan) == 4 and all(got.plan)
    assert dataclasses.asdict(async_schedule.plan_async_capacities_multi(
        [], T, 250, 4)) == dataclasses.asdict(
            jax_async.plan_async_capacities_multi([], T, 250, 4))


@pytest.mark.parametrize("training", [False, True])
def test_pack_async_batches_identical_to_jax(training):
    """Every leaf of every batch, segments included, in training (the
    same RandomState) and in evaluation."""
    port, want, _ = _both_batches(synthetic_molecules(40, seed=8)
                                  + ODD_GRAPHS, 4, training=training)
    assert len(port) == len(want) > 1
    for got, ref in zip(port, want):
        assert got.seg_rounds is not None
        _assert_identical(got, ref)


def test_pack_with_serving_caps_and_on_segment_overflow_identical_to_jax():
    """The serving envelope (no plan: no segments) and a plan that
    covers only each round's first segment (the deeper steps overflow it;
    the batch falls back to the plain layout) give JAX's batches."""
    raw = synthetic_molecules(10, seed=9)
    serving = async_schedule.AsyncCapacities(
        nodes=64, graphs=8, initial_nodes=64, sending_edges=512,
        receiving_nodes=64)
    port, want, _ = _both_batches(raw, caps=serving, budget=65)
    for got, ref in zip(port, want):
        assert got.seg_rounds is None and got.init_prev is None
        _assert_identical(got, ref)
    proc, _ = _both_preprocessed(raw)
    caps = async_schedule.plan_async_capacities(proc, T, 200, 2)
    small = dataclasses.replace(caps, plan=tuple(segs[:1]
                                                 for segs in caps.plan))
    port, want, _ = _both_batches(raw, caps=small)
    assert all(b.seg_rounds is None for b in port)
    assert all(b.init_prev is not None for b in port)
    for got, ref in zip(port, want):
        _assert_identical(got, ref)


def test_corpus_without_flat_tables_raises_naming_its_item():
    """A graph with neither schedule form cannot be packed: both packages
    raise, naming the fix (the loop packer takes graphs that carry their
    nested schedules: tests/test_torch_async_cache.py)."""
    proc, ref = _both_preprocessed(synthetic_molecules(4, seed=1))
    caps = async_schedule.plan_async_capacities(proc, T, 200, 2)
    jax_caps = jax_async.AsyncCapacities(**dataclasses.asdict(caps))
    for mod, corpus, c in ((async_schedule, proc, caps),
                           (jax_async, ref, jax_caps)):
        stripped = [{k: v for k, v in g.items() if k != "flat_schedules"}
                    for g in corpus]
        with pytest.raises(ValueError, match="re-run preprocess_async"):
            mod.plan_async_capacities(stripped, T, 200, 2)
        with pytest.raises(ValueError, match="re-run preprocess_async"):
            list(mod.pack_async_batches(stripped, T, 200, c, 2, S, H, 5,
                                        False))


def test_batch_to_device_keeps_recv_base_on_the_host():
    port, _, _ = _both_batches(synthetic_molecules(10, seed=2))
    moved = port[0].to("cpu")
    assert isinstance(moved, AsyncGraphBatch)
    seg = moved.seg_rounds[1][0]
    assert isinstance(seg.send_compact, torch.Tensor)
    assert isinstance(seg.recv_base, tuple)
    assert all(type(v) is int for v in seg.recv_base)
    assert list(seg.recv_base) == port[0].seg_rounds[1][0].recv_base.tolist()
    assert moved.num_graphs == int(port[0].num_graphs)


# -------------------------------------------------------------- model

def _graph_state(jax_params):
    """The port model's state dict of a JAX async params tree."""
    named = checkpoint.params_from_jax_weights(
        _flatten_named({"params": {"graph": jax_params}}))
    return {k[len("graph."):]: v for k, v in named.items()}


def _model_pair(config, seed=3):
    """A JAX AsyncGGNN and its params (edge biases random, not zero) and
    the port's model holding the same weights."""
    jax_model = JaxAsyncGGNN(dict(config), T)
    params = jax_model.init_params(jax.random.PRNGKey(seed))
    if config["use_edge_bias"]:
        rng = np.random.RandomState(seed)
        params["edge_biases"] = [
            jnp.asarray(rng.randn(H).astype(np.float32) * 0.3)
            for _ in range(T)]
    model = AsyncGGNN(dict(config), T, torch.Generator().manual_seed(0))
    model.load_state_dict(_graph_state(params), strict=True)
    return jax_model, params, model


CELLS = {
    "gru": {},
    "gru, edge bias": {"use_edge_bias": True},
    "rnn relu, edge bias": {"use_edge_bias": True, "graph_rnn_cell": "RNN",
                            "graph_rnn_activation": "ReLU"},
}


@pytest.fixture(scope="module")
def batches():
    port, want, _ = _both_batches(synthetic_molecules(30, seed=9)
                                  + ODD_GRAPHS)
    return port[0], want[0]


@pytest.mark.parametrize("compact", [True, False])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_forward_and_gradients_match_jax(batches, cell, compact):
    """Node states at 2e-5 and every parameter's gradient of a weighted
    sum of them at 1e-4, on the segmented and on the plain path."""
    port_batch, jax_batch = batches
    config = _model_config(async_compact=compact, **CELLS[cell])
    jax_model, params, model = _model_pair(config)
    weights = np.random.RandomState(0).randn(
        port_batch.node_capacity, H).astype(np.float32)
    loss, grads = jax.value_and_grad(lambda p: jnp.sum(
        jax_model.forward(p, jax_batch) * weights))(params)
    out = model(port_batch.to("cpu"))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(
        jax_model.forward(params, jax_batch)), **TOL)
    (out * torch.from_numpy(weights)).sum().backward()
    want = _graph_state(grads)
    for name, p in model.named_parameters():
        scale = float(want[name].abs().max()) + 1e-12
        np.testing.assert_allclose(p.grad.numpy() / scale,
                                   want[name].numpy() / scale, rtol=0,
                                   atol=1e-4, err_msg=name)
    # The weighted sum cancels: bound it by the states' own tolerance.
    np.testing.assert_allclose(
        float((out * torch.from_numpy(weights)).sum().detach()), float(loss),
        rtol=0, atol=TOL["atol"] * float(np.abs(weights).sum()))


def test_all_rounds_match_jax_round_by_round(batches):
    port_batch, jax_batch = batches
    config = _model_config(rounds=4, use_edge_bias=True)
    port4, jax4, _ = _both_batches(synthetic_molecules(12, seed=4), 4)
    jax_model, params, model = _model_pair(config)
    want = jax_model.forward(params, jax4[0], return_all_rounds=True)
    with torch.no_grad():
        got = model(port4[0].to("cpu"), return_all_rounds=True)
    assert len(got) == len(want) == 4
    for r, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   err_msg=f"round {r}", **TOL)
    np.testing.assert_allclose(got[-1].numpy(), model(
        port4[0].to("cpu")).detach().numpy(), **TOL)


def test_compact_path_equals_plain_path_over_every_batch():
    """The port's counterpart of tests/test_models.py's compact-vs-plain
    check: 4 rounds, edge bias, every batch, and the gradients."""
    port, _, _ = _both_batches(synthetic_molecules(25, seed=9), 4, 220)
    config = _model_config(rounds=4, use_edge_bias=True)
    _, _, compact = _model_pair(config)
    plain = AsyncGGNN(dict(config, async_compact=False), T,
                      torch.Generator().manual_seed(0))
    plain.load_state_dict(compact.state_dict())
    for batch in port:
        b = batch.to("cpu")
        assert b.seg_rounds is not None
        with torch.no_grad():
            np.testing.assert_allclose(compact(b).numpy(), plain(b).numpy(),
                                       rtol=1e-5, atol=1e-6)
    b = port[0].to("cpu")
    for model in (compact, plain):
        (model(b) ** 2).sum().backward()
    for (name, a), (_, c) in zip(compact.named_parameters(),
                                 plain.named_parameters()):
        np.testing.assert_allclose(a.grad.numpy(), c.grad.numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("compact", [True, False])
def test_isolated_nodes_and_edgeless_graphs_keep_their_features(compact):
    """tests/test_models.py's two cases on the port: an isolated node and
    an edgeless graph ride every round as initial nodes."""
    port, _, _ = _both_batches(ODD_GRAPHS[:2], 4, 64)
    batch = port[0].to("cpu")
    assert batch.seg_rounds is not None
    _, _, model = _model_pair(_model_config(rounds=4,
                                            async_compact=compact))
    with torch.no_grad():
        out = model(batch).numpy()
    feats = batch.node_features.numpy()
    # Node 2 of graph 0, and both nodes of the edgeless graph (rows 3-4).
    for row in (2, 3, 4):
        np.testing.assert_allclose(out[row], feats[row], rtol=1e-6,
                                   err_msg=f"row {row}")
        assert np.abs(out[row]).sum() > 0


def test_out_of_plan_schedule_falls_back_to_the_plain_path():
    """Caps planned on shallow chains meet a deeper chain: its batch has
    no segments, and the forward equals that of a batch planned on the
    deep chain itself, and JAX's."""
    def chain(n):
        return {"targets": [[0.1]],
                "graph": [[i, 1, i + 1] for i in range(n - 1)],
                "node_features": [[1, 0] for _ in range(n)]}

    shallow = async_schedule.preprocess_async([chain(3)] * 4, 1, True, 2, 12,
                                              [0], {}, False)
    deep = async_schedule.preprocess_async([chain(9)], 1, True, 2, 12, [0],
                                           {}, False)
    caps = async_schedule.plan_async_capacities(shallow, 1, 100, 2)
    batch = next(async_schedule.pack_async_batches(deep, 1, 100, caps, 2, 12,
                                                   8, 2, False))
    assert batch.seg_rounds is None
    caps_deep = async_schedule.plan_async_capacities(deep, 1, 100, 2)
    batch_ok = next(async_schedule.pack_async_batches(
        deep, 1, 100, caps_deep, 2, 12, 8, 2, False))
    config = {**_model_config(), "hidden_size": 8, "propagation_substeps": 12}
    jax_model = JaxAsyncGGNN(config, 1)
    params = jax_model.init_params(jax.random.PRNGKey(0))
    model = AsyncGGNN(config, 1, torch.Generator())
    model.load_state_dict(_graph_state(params), strict=True)
    with torch.no_grad():
        got = model(batch.to("cpu")).numpy()[:9]
        want = model(batch_ok.to("cpu")).numpy()[:9]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, np.asarray(jax_model.forward(
        params, batch))[:9], **TOL)
    assert not np.allclose(want, 0.0)


@pytest.mark.parametrize("keep_prob", [1.0, 0.7])
def test_remat_on_and_off_give_the_same_gradients(batches, keep_prob):
    """`async_remat` true recomputes each substep in the backward from a
    buffer no later write changes: the same loss and gradients as false,
    with state dropout drawn from the same generator seed."""
    port_batch = batches[0].to("cpu")
    grads = {}
    for remat in (False, True):
        config = _model_config(use_edge_bias=True, async_remat=remat,
                               graph_state_dropout_keep_prob=keep_prob)
        _, _, model = _model_pair(config)
        out = model(port_batch, is_training=True,
                    generator=torch.Generator().manual_seed(11))
        (out ** 2).sum().backward()
        grads[remat] = {n: p.grad.clone() for n, p in
                        model.named_parameters()}
    for name, g in grads[False].items():
        np.testing.assert_allclose(grads[True][name].numpy(), g.numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=name)


def test_auto_remat_follows_the_estimate(batches):
    port_batch = batches[0].to("cpu")
    _, _, model = _model_pair(_model_config())
    m_dump = compact_dump_row(port_batch)
    assert model._use_remat(port_batch, m_dump) is False
    assert model._remat_limit == int(2.5 * 2**30)
    model._remat_limit = 1
    assert model._use_remat(port_batch, m_dump) is True
    model.config["async_remat"] = False
    assert model._use_remat(port_batch, m_dump) is False


def test_dropout_needs_a_generator_and_follows_its_seed(batches):
    port_batch = batches[0].to("cpu")
    _, _, model = _model_pair(_model_config(
        graph_state_dropout_keep_prob=0.5))
    with pytest.raises(ValueError, match="Generator"):
        model(port_batch, is_training=True)
    with torch.no_grad():
        def run(seed):
            return model(port_batch, is_training=True,
                         generator=torch.Generator().manual_seed(seed))
        assert torch.equal(run(3), run(3)) and not torch.equal(run(3), run(4))
        assert not torch.equal(run(3), model(port_batch))


def _count_kernel_calls(monkeypatch):
    """{name: calls} of the B1 and B2 wrappers, which the autograd
    Function looks up at each call (on the CPU they run the plain
    versions; the launch counters count CUDA launches only)."""
    calls = {"b1": 0, "b2": 0}
    for key, name in (("b1", "gather_segment_sum"),
                      ("b2", "segment_scatter_sum")):
        real = getattr(ell_spmm, name)

        def counted(*args, _key=key, _real=real):
            calls[_key] += 1
            return _real(*args)

        monkeypatch.setattr(ell_spmm, name, counted)
    return calls


@pytest.mark.parametrize("remat", [False, True])
def test_a_train_step_calls_b1_per_substep_and_b2_but_once(
        batches, monkeypatch, remat):
    """What the card's run checks with the launch counters: one B1 call
    a substep forward (again in the backward under remat, which
    recomputes each substep), one B2 call a substep backward but for the
    first substep of round 0, whose buffer holds only features; the plain
    path (serving, no gradient) one B1 call a substep of every round."""
    port_batch = batches[0].to("cpu")
    substeps = sum(seg.old_compact.shape[0]
                   for segs in port_batch.seg_rounds for seg in segs)
    _, _, model = _model_pair(_model_config(async_remat=remat))
    calls = _count_kernel_calls(monkeypatch)
    (model(port_batch) ** 2).sum().backward()
    assert calls == {"b1": substeps * (2 if remat else 1),
                     "b2": substeps - 1}
    calls.update(b1=0, b2=0)
    plain = dataclasses.replace(port_batch, seg_rounds=None)
    with torch.inference_mode():
        model(plain)
    assert calls == {"b1": 2 * S, "b2": 0}


def test_parameter_names_are_the_jax_key_paths():
    config = {**ASYNC_DEFAULTS, **_model_config(use_edge_bias=True)}
    gen = torch.Generator().manual_seed(0)
    params = ModelParams(AsyncGGNN(config, T, gen),
                         init_output_heads(gen, H, [0]))
    jax_params = {"graph": JaxAsyncGGNN(config, T).init_params(
        jax.random.PRNGKey(0)), "heads": jax_base.init_output_heads(
            jax.random.PRNGKey(0), H, [0])}
    weights = checkpoint.jax_weights_from_params(params)
    assert set(weights) == set(_flatten_named({"params": jax_params}))
    assert "['params']['graph']['edge_weights'][3]" in weights
    assert "['params']['graph']['edge_biases'][0]" in weights


# ------------------------------------------------------- adapter, ckpt

def _adapter(extra=None):
    config = resolve_config("async", config_json=json.dumps(
        {"hidden_size": H, "propagation_rounds": 2,
         "propagation_substeps": S, "num_nodes": 200, **(extra or {})}))
    return make_adapter("async", config, DatasetMeta(32, T, 5))


def test_batch_order_shuffle_packs_once_and_permutes():
    adapter = _adapter({"async_epoch_shuffle": "batches"})
    proc = adapter.preprocess(synthetic_molecules(40, seed=3), False)
    adapter.plan(proc)
    first = list(adapter.batches(proc, False))
    again = list(adapter.batches(proc, False))
    assert len(first) > 2 and all(a is b for a, b in zip(first, again))
    shuffled = list(adapter.batches(proc, True, np.random.RandomState(0)))
    order = np.random.RandomState(0).permutation(len(first))
    assert [id(b) for b in shuffled] == [id(first[i]) for i in order]
    # A corpus a fifth distinct one pushes out first in, first out.
    corpora = [adapter.preprocess(synthetic_molecules(6, seed=s), False)
               for s in range(5)]
    for c in corpora:
        list(adapter.batches(c, False))
    assert len(adapter._batch_caches) == 4
    assert id(corpora[0]) not in adapter._batch_caches
    with pytest.raises(ValueError, match="async_epoch_shuffle"):
        list(_adapter({"async_epoch_shuffle": "nodes"}).batches(proc, False))


def test_graph_shuffle_packs_what_the_jax_packer_packs():
    adapter = _adapter()
    raw = synthetic_molecules(30, seed=4)
    proc = adapter.preprocess(raw, True, np.random.RandomState(2))
    caps = adapter.plan(proc)
    jax_proc = jax_async.preprocess_async(raw, T, True, 2, S, [0], {}, True,
                                          np.random.RandomState(2))
    want = list(jax_async.pack_async_batches(
        jax_proc, T, 200, jax_async.AsyncCapacities(
            **dataclasses.asdict(caps)), 2, S, H, 5, True,
        np.random.RandomState(9), use_flat=True))
    got = list(adapter.batches(proc, True, np.random.RandomState(9)))
    for a, b in zip(got, want):
        _assert_identical(a, b)


def _stack_legacy(payload, t_dim, extra_row):
    """The payload with the per-type edge-weight leaves (weights and Adam
    moments) stacked under their base names, as older checkpoints hold
    them, one surplus row added when `extra_row`."""
    weights = dict(payload["weights"])
    prefixes = ["['params']['graph']['edge_weights']",
                "['opt_state'][1]['mu']['graph']['edge_weights']",
                "['opt_state'][1]['nu']['graph']['edge_weights']"]
    for base in prefixes:
        rows = [weights.pop(f"{base}[{t}]") for t in range(t_dim)]
        if extra_row:
            rows.append(np.ones_like(rows[0]))
        weights[base] = np.stack(rows)
    return {**payload, "weights": weights}


@pytest.mark.parametrize("extra_row", [False, True])
def test_restore_splits_a_legacy_stacked_edge_weight(tmp_path, extra_row):
    config = resolve_config("async", config_json=json.dumps(
        _model_config(use_edge_bias=True)))
    gen = torch.Generator().manual_seed(4)
    params = ModelParams(AsyncGGNN(config, T, gen),
                         init_output_heads(gen, H, [0]))
    opt = TFAdam(params, 0.01, 1.0)
    opt.step({n: torch.randn(p.shape, generator=gen)
              for n, p in params.named_parameters()})
    path = str(tmp_path / "port.pickle")
    checkpoint.save_checkpoint(path, config, params, 2, 1, optimizer=opt)
    with open(path, "rb") as f:
        payload = _stack_legacy(pickle.load(f), T, extra_row)
    legacy = str(tmp_path / "legacy.pickle")
    with open(legacy, "wb") as f:
        pickle.dump(payload, f)
    fresh = ModelParams(AsyncGGNN(config, T, torch.Generator()),
                        init_output_heads(torch.Generator(), H, [0]))
    fresh_opt = TFAdam(fresh, 0.01, 1.0)
    lines = []
    checkpoint.restore_checkpoint(legacy, config, fresh, log=lines.append,
                                  optimizer=fresh_opt)
    for name, value in params.state_dict().items():
        torch.testing.assert_close(fresh.state_dict()[name], value, rtol=0,
                                   atol=0)
    for moment in ("mu", "nu"):
        for name, value in getattr(opt, moment).items():
            torch.testing.assert_close(getattr(fresh_opt, moment)[name],
                                       value, rtol=0, atol=0)
    assert sum("Splitting legacy stacked" in s for s in lines) == 3
    assert not any("Freshly" in s for s in lines)
    assert not any("not used by model" in s for s in lines)
    assert sum("surplus row" in s for s in lines) == (3 if extra_row else 0)


# ------------------------------------------------------------ serving

ENVELOPE = dict(max_nodes=64, max_graphs=8)


def _jax_checkpoint(path):
    config = jax_resolve_config("async", config_json=json.dumps(
        _model_config(use_edge_bias=True)))
    key = jax.random.PRNGKey(6)
    params = {"graph": JaxAsyncGGNN(config, T).init_params(key),
              "heads": jax_base.init_output_heads(key, H,
                                                  config["task_ids"])}
    params["graph"]["edge_biases"] = [
        jnp.full((H,), 0.1 * (t + 1), jnp.float32) for t in range(T)]
    jax_save(str(path), config, {"params": params}, 5, 2)
    return str(path)


@pytest.fixture(scope="module")
def predictors(tmp_path_factory):
    path = _jax_checkpoint(tmp_path_factory.mktemp("async") / "jax.pickle")
    return (Predictor.from_checkpoint(path, "async", device="cpu",
                                      **ENVELOPE),
            JaxPredictor.from_checkpoint(path, "async", **ENVELOPE))


@pytest.mark.parametrize("n_graphs", [1, 12])
def test_predictor_matches_jax_on_a_jax_checkpoint(predictors, n_graphs):
    port, want_pred = predictors
    assert port.meta.num_edge_types == T and port.caps.plan is None
    request = synthetic_molecules(n_graphs, seed=90 + n_graphs)
    got = port(request)
    want = np.asarray(want_pred(request))
    assert got.shape == want.shape == (1, n_graphs)
    np.testing.assert_allclose(got, want, **TOL)
    if n_graphs > 1:
        assert len(list(port._batches(request, 5))) > 1
        alone = np.concatenate([port([g]) for g in request[:3]], axis=1)
        np.testing.assert_allclose(got[:, :3], alone, **TOL)


def test_schedule_cache_is_keyed_by_topology(predictors, monkeypatch):
    port, _ = predictors
    calls = []
    real = async_schedule.graph_to_propagation_schedules
    monkeypatch.setattr(async_schedule, "graph_to_propagation_schedules",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    g = synthetic_molecules(1, seed=300)[0]
    twin = {**g, "node_features": [[0, 0, 1, 0, 0]] * len(g["node_features"])}
    first = port._async_processed(g)
    again = port._async_processed(twin)
    assert len(calls) == 1
    assert again["flat_schedules"] is first["flat_schedules"]
    assert not np.array_equal(again["init"], first["init"])
    port._schedules.max_entries = 1
    port._async_processed(synthetic_molecules(1, seed=301)[0])
    assert len(calls) == 2 and len(port._schedules.entries) == 1


def test_single_graph_cache_equals_the_corpus_pack(predictors):
    """A topology seen before takes its cached batch with the new
    features and targets: leaf for leaf `_batches([g])`'s."""
    port, want_pred = predictors
    g = synthetic_molecules(1, seed=400)[0]
    twin = {"targets": [[1.5]], "graph": g["graph"],
            "node_features": [[0, 1, 0, 0, 0]] * len(g["node_features"])}
    first = port._pack_single_async(g, 5)
    cached = port._pack_single_async(twin, 5)
    _assert_identical(first, next(iter(port._batches([g], 5))))
    _assert_identical(cached, next(iter(port._batches([twin], 5))))
    _assert_identical(cached, want_pred._pack_single_async(twin, 5))
    np.testing.assert_allclose(port([twin]), np.asarray(want_pred([twin])),
                               **TOL)
