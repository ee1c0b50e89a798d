"""The port's `Runner.train_on_device`, `make_epochs_fn` and
`time_epochs` against the JAX package's, on the CPU, where the epochs
run as eager steps in the order the card's graphs replay them.

Tolerances, each with its reason:
  * the final loss: rtol 5e-4, the Runner tolerance of
    tests/test_torch_training.py (two epochs of f32 training in another
    summation order);
  * every parameter: rtol 5e-4 / atol 5e-5, the compounding-steps bound
    of tests/test_torch_training.py's 10-step trajectory (a parameter
    near 0 has no relative scale);
  * the numpy stream, the step counts, the Adam count and the order of
    the steps: exact; TFAdam's device count: bit for bit.
"""

import dataclasses
import json
import math

import jax
import numpy as np
import pytest
import torch
from torch import nn

import ggnn_tpu.parallel.stacking as jax_stacking
from ggnn_tpu.data.synthetic import synthetic_molecules
from ggnn_tpu.training.checkpoint import _flatten_named
from ggnn_tpu.training.runner import Runner as JaxRunner
from ggnn_tpu_torch.training import runner as port_runner_module
from ggnn_tpu_torch.training.checkpoint import params_from_jax_weights
from ggnn_tpu_torch.training.config import resolve_config
from ggnn_tpu_torch.training.optimizer import (B1, B2, EPS, TFAdam,
                                               clip_by_norm)
from ggnn_tpu_torch.training.runner import Runner
from ggnn_tpu_torch.utils.timing import (graph_key, leaf_shapes,
                                         make_epochs_fn, shape_groups,
                                         time_epochs)

torch.set_num_threads(1)

NO_DROPOUT = {"edge_weight_dropout_keep_prob": 1.0,
              "graph_state_dropout_keep_prob": 1.0,
              "out_layer_dropout_keep_prob": 1.0}
# Small configurations (2 layers, H 16) whose 60-molecule corpus packs
# into several batches and, for `dense`, several buckets.
SMALL = {
    "sparse": {"hidden_size": 16, "layer_timesteps": [2, 1],
               "residual_connections": {"1": [0]}, "batch_size": 300},
    "dense": {"hidden_size": 16, "num_timesteps": 2, "batch_size": 8,
              "drop_remainder": False},
    # The synthetic corpus reaches schedule depth 17; the default 15
    # raises.
    "async": {"hidden_size": 16, "propagation_rounds": 2,
              "propagation_substeps": 40, "num_nodes": 200},
}
TOL_LOSS = dict(rtol=5e-4)
TOL_PARAMS = dict(rtol=5e-4, atol=5e-5)


def _bridge(jax_params):
    """{port parameter name: tensor} of a JAX params tree."""
    return params_from_jax_weights(_flatten_named({"params": jax_params}))


@pytest.fixture(scope="module", params=sorted(SMALL))
def pair(request, tmp_path_factory):
    """The JAX Runner and the port's, same seed, corpus and weights, no
    dropout, each after `train_on_device(2)`, with the batch groups each
    one ran (JAX's from `stack_any_batches`, the port's from
    `shape_groups`)."""
    variant = request.param
    config_json = json.dumps({**SMALL[variant], **NO_DROPOUT,
                              "random_seed": 3})
    train = synthetic_molecules(60, seed=11)
    valid = synthetic_molecules(12, seed=12)
    jax_runner = JaxRunner(variant, resolve_config(variant,
                                                   config_json=config_json),
                           train_data=train, valid_data=valid,
                           log_dir=str(tmp_path_factory.mktemp("jax")),
                           quiet=True, tensorboard=False)
    port = Runner(variant, resolve_config(variant, config_json=config_json),
                  train_data=train, valid_data=valid,
                  log_dir=str(tmp_path_factory.mktemp("port")), quiet=True,
                  tensorboard=False, device="cpu")
    port.params.load_state_dict(_bridge(jax_runner.state["params"]),
                                strict=True)
    jax_groups, port_groups = [], []

    def jax_stack(batches, n_data, empty_fn=None):
        jax_groups.append(list(batches))
        return stack_any_batches(batches, n_data, empty_fn)

    def port_shape_groups(batches):
        groups = shape_groups(batches)
        port_groups.extend(groups)
        return groups

    stack_any_batches = jax_stacking.stack_any_batches
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_stacking, "stack_any_batches", jax_stack)
        mp.setattr(port_runner_module, "shape_groups", port_shape_groups)
        jax_loss = jax_runner.train_on_device(2)
        port_loss = port.train_on_device(2)
    return dict(variant=variant, jax=jax_runner, port=port,
                jax_loss=jax_loss, port_loss=port_loss,
                jax_groups=jax_groups, port_groups=port_groups,
                train=train, valid=valid)


def test_train_on_device_matches_jax(pair):
    np.testing.assert_allclose(pair["port_loss"], pair["jax_loss"],
                               **TOL_LOSS)
    want = _bridge(pair["jax"].state["params"])
    got = dict(pair["port"].params.named_parameters())
    assert set(got) == set(want)
    for name, value in want.items():
        np.testing.assert_allclose(got[name].detach().numpy(),
                                   value.numpy(), err_msg=name,
                                   **TOL_PARAMS)


def test_train_on_device_advances_the_numpy_stream_and_counts_as_jax(pair):
    jax_runner, port = pair["jax"], pair["port"]
    steps = sum(len(g) for g in pair["port_groups"])
    assert port.train_step_id == jax_runner.train_step_id == 2 * steps > 2
    assert port.optimizer.count == port.train_step_id
    assert port.optimizer.count == \
        int(jax_runner.state["opt_state"][1]["count"])
    for got, want in zip(port.np_rng.get_state(),
                         jax_runner.np_rng.get_state()):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_step_order_is_jax_groups_order(pair):
    """The port's groups are JAX's, in JAX's order, batch for batch."""
    jax_groups, port_groups = pair["jax_groups"], pair["port_groups"]
    assert [len(g) for g in port_groups] == [len(g) for g in jax_groups]
    if pair["variant"] == "dense":
        assert len(port_groups) > 1   # several buckets
    for port_group, jax_group in zip(port_groups, jax_groups):
        for port_batch, jax_batch in zip(port_group, jax_group):
            assert leaf_shapes(port_batch) == tuple(
                np.shape(leaf)
                for leaf in jax.tree_util.tree_leaves(jax_batch))
            for field in ("node_features", "targets", "target_mask"):
                np.testing.assert_array_equal(
                    np.asarray(getattr(port_batch, field), np.float32),
                    np.asarray(getattr(jax_batch, field), np.float32))


def test_checkpoint_after_train_on_device_restores_in_jax(pair, tmp_path):
    port = pair["port"]
    path = str(tmp_path / "after.pickle")
    port._save(path)
    restored = JaxRunner(pair["variant"], dict(port.config),
                         train_data=pair["train"], valid_data=pair["valid"],
                         log_dir=str(tmp_path), quiet=True,
                         tensorboard=False, restore=path)
    assert restored.train_step_id == port.train_step_id
    assert int(restored.state["opt_state"][1]["count"]) == \
        port.optimizer.count == port.train_step_id
    for name, value in _bridge(restored.state["params"]).items():
        np.testing.assert_array_equal(
            value.numpy(),
            dict(port.params.named_parameters())[name].detach().numpy())


@pytest.mark.parametrize("pair", ["async"], indirect=True)
def test_async_graph_keys_split_a_jax_group_by_recv_base(pair):
    """Two async batches with the same leaf shapes but other `recv_base`
    offsets share a JAX group and one graph key: the offsets are device
    arrays, as JAX's traced `recv_base`, so one graph replays both. A
    host batch and its device copy share the key; the counts, which no
    step reads, are not part of it."""
    batch = pair["port_groups"][0][0]
    assert batch.seg_rounds is not None
    seg = batch.seg_rounds[0][-1]
    moved = dataclasses.replace(seg, recv_base=np.asarray(seg.recv_base) + 1)
    rounds = ((*batch.seg_rounds[0][:-1], moved),) + batch.seg_rounds[1:]
    other = dataclasses.replace(batch, seg_rounds=rounds,
                                num_graphs=batch.num_graphs + 1)
    assert leaf_shapes(other) == leaf_shapes(batch)
    assert len(shape_groups([batch, other])) == 1
    on_cpu = batch.to("cpu")
    assert graph_key(other.to("cpu")) == graph_key(on_cpu) == \
        graph_key(batch) == graph_key(other)
    assert graph_key(dataclasses.replace(batch, num_graphs=0).to("cpu")) \
        == graph_key(on_cpu)
    # The run's batches: one key a JAX group, whatever their offsets.
    flat = [b for g in pair["port_groups"] for b in g]
    bases = {tuple(tuple(np.asarray(s.recv_base).tolist()) for r in
                   b.seg_rounds for s in r) for b in flat}
    assert len(bases) > 1
    keys = [graph_key(b.to("cpu")) for b in flat]
    for i in range(len(flat)):
        for j in range(i):
            assert (keys[i] == keys[j]) == \
                (leaf_shapes(flat[i]) == leaf_shapes(flat[j]))


def test_make_epochs_fn_runs_epochs():
    """The port of tests/test_cli_and_utils.py's: n chained epochs of a
    counting step over one group of three batches."""
    total = torch.zeros(())

    def step(batch):
        total.add_(batch.sum())
        return batch.sum()

    batches = torch.arange(6, dtype=torch.float32).reshape(3, 2)
    epochs_fn = make_epochs_fn(step)
    last_loss = epochs_fn([list(batches)], 4)
    # 4 epochs x (0+1)+(2+3)+(4+5) = 15 -> 60
    assert float(total) == 60.0
    assert float(last_loss) == 9.0   # the last batch of the last epoch
    assert float(epochs_fn([list(batches)], 0)) == 0.0
    with pytest.raises(ValueError, match="no batch groups"):
        epochs_fn([], 1)
    seconds, loss = time_epochs(epochs_fn, [list(batches)], 1, 3)
    assert loss == 9.0 and math.isfinite(seconds)
    assert float(total) == 60.0 + 15.0 * (1 + 1 + 3)


def test_train_on_device_fast_path(tmp_path):
    """The port of tests/test_training.py's: whole epochs lower the
    validation loss, and `predict` serves the new weights."""
    config = resolve_config("sparse", config_json=json.dumps(
        {"hidden_size": 16, "layer_timesteps": [2, 1],
         "residual_connections": {"1": [0]}, "num_epochs": 1,
         "learning_rate": 0.003}))
    runner = Runner("sparse", config, train_data=synthetic_molecules(60, 0),
                    valid_data=synthetic_molecules(20, 1),
                    log_dir=str(tmp_path), quiet=True, tensorboard=False,
                    device="cpu")
    base_loss = runner.run_epoch("probe", runner.valid_processed, False)[0]
    final_loss = runner.train_on_device(8)
    assert np.isfinite(final_loss)
    after_loss = runner.run_epoch("probe2", runner.valid_processed,
                                  False)[0]
    assert after_loss < base_loss
    outs = runner.predict(synthetic_molecules(3, seed=4))
    assert sum(o.shape[1] for o in outs) == 3


def test_tfadam_device_count_is_bit_equal_to_the_host_count():
    """The count and lr_t on the device give the updates of the host's
    `math` version bit for bit, at t = 1..50 and at t = 10,000."""
    gen = torch.Generator().manual_seed(0)
    module = nn.Module()
    module.w = nn.Parameter(torch.randn(7, 5, generator=gen))
    module.b = nn.Parameter(torch.randn(3, generator=gen))
    want = {n: p.detach().clone() for n, p in module.named_parameters()}
    mu = {n: torch.zeros_like(p) for n, p in want.items()}
    nu = {n: torch.zeros_like(p) for n, p in want.items()}
    opt = TFAdam(module, 0.001, 1.0)
    assert opt.count == 0 and opt.state_tensors()[0].dtype == torch.float64
    for t in list(range(1, 51)) + [10_000]:
        if t == 10_000:
            opt.count = 9_999
        grads = {n: torch.randn(p.shape, generator=gen)
                 for n, p in want.items()}
        lr_t = 0.001 * math.sqrt(1 - B2 ** t) / (1 - B1 ** t)
        for name, p in want.items():
            g = clip_by_norm(grads[name], 1.0)
            mu[name].mul_(B1).add_(g, alpha=1 - B1)
            nu[name].mul_(B2).add_(g.square(), alpha=1 - B2)
            p.sub_(lr_t * mu[name] / (nu[name].sqrt() + EPS))
        opt.step(grads)
        assert opt.count == t
        for name, p in module.named_parameters():
            assert torch.equal(p.detach(), want[name]), (t, name)


@pytest.mark.parametrize("ratios", [{}, {0: 0.5, "2": 0.25}])
def test_prebuilt_loss_rescale_keeps_the_loss_bits(ratios):
    """The loss's task weights made once (`task_rescale`, what a Runner
    passes so that a captured step copies nothing from the host) give
    the loss and MAE of the weights made per call, bit for bit."""
    from ggnn_tpu_torch.models import base
    rng = np.random.RandomState(1)
    computed, targets = (torch.from_numpy(rng.randn(2, 9).astype(np.float32))
                         for _ in range(2))
    mask = torch.from_numpy((rng.rand(2, 9) < 0.7).astype(np.float32))
    want = base.masked_regression_loss(computed, targets, mask, [0, 2],
                                       ratios)
    got = base.masked_regression_loss(
        computed, targets, mask, [0, 2], ratios,
        base.task_rescale([0, 2], ratios, computed.device))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
