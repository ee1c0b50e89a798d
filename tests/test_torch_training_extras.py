"""The port's training extras against the JAX package, on the CPU:
mid-epoch resume (the iterator state in the rolling checkpoint, across
packages both ways), TensorBoard summaries, `--profile`, `Runner.predict`
and `--evaluate`.

Tolerances, each with its reason:
  * a port run resumed mid-epoch against the port's uninterrupted run:
    rtol 1e-5 / atol 1e-6, the JAX package's own bound for its resume
    (tests/test_training.py); on the CPU the two are bit-equal;
  * a resume across packages against the other package's uninterrupted
    run: rtol 5e-4 / atol 5e-5 (two epochs of f32 training in another
    summation order, the Runner tolerance of tests/test_torch_training.py
    and the trajectory bound of tests/test_tf1_golden.py);
  * summaries: the scalars within 5e-4 (the same two epochs);
  * `Runner.predict` against JAX's on the same checkpoint: 2e-5 (one
    forward, f32 products in another order).
"""

import collections
import glob
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from ggnn_tpu.data.synthetic import synthetic_molecules
from ggnn_tpu.training import runner as jax_runner_mod
from ggnn_tpu.training.checkpoint import _flatten_named
from ggnn_tpu.training.checkpoint import \
    load_iterator_state as jax_load_iterator_state
from ggnn_tpu.training.checkpoint import save_checkpoint as jax_save
from ggnn_tpu.training.config import resolve_config as jax_resolve_config
from ggnn_tpu.training.runner import Runner as JaxRunner
from ggnn_tpu_torch import cli
from ggnn_tpu_torch.training import checkpoint
from ggnn_tpu_torch.training import runner as runner_mod
from ggnn_tpu_torch.training.checkpoint import params_from_jax_weights
from ggnn_tpu_torch.training.config import resolve_config
from ggnn_tpu_torch.training.runner import Runner
from ggnn_tpu_torch.training.summaries import SummarySink
from ggnn_tpu_torch.utils import spans as span_recorder

torch.set_num_threads(1)

SMALL = {"hidden_size": 16, "layer_timesteps": [2, 1],
         "residual_connections": {"1": [0]}, "batch_size": 120,
         "num_epochs": 2, "random_seed": 3}
NO_DROPOUT = {"edge_weight_dropout_keep_prob": 1.0,
              "graph_state_dropout_keep_prob": 1.0,
              "out_layer_dropout_keep_prob": 1.0}
DROPOUT = {"edge_weight_dropout_keep_prob": 0.8,
           "graph_state_dropout_keep_prob": 0.9,
           "out_layer_dropout_keep_prob": 0.8, "patience": 1}
TRAIN = synthetic_molecules(60, seed=0)
VALID = synthetic_molecules(12, seed=1)


def _config(extra, resolve=resolve_config):
    return resolve("sparse", config_json=json.dumps({**SMALL, **extra}))


def _port(config, log_dir, **kwargs):
    return Runner("sparse", dict(config), train_data=TRAIN,
                  valid_data=VALID, log_dir=str(log_dir), quiet=True,
                  device="cpu", **kwargs)


def _jax(config, log_dir, **kwargs):
    return JaxRunner("sparse", dict(config), train_data=TRAIN,
                     valid_data=VALID, log_dir=str(log_dir), quiet=True,
                     **kwargs)


def _port_params(runner):
    return {n: p.detach().numpy().copy()
            for n, p in runner.params.named_parameters()}


def _jax_params(runner):
    return {n: t.numpy() for n, t in params_from_jax_weights(
        _flatten_named({"params": runner.state["params"]})).items()}


def _assert_params(got, want, rtol, atol):
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=rtol,
                                   atol=atol, err_msg=name)


def _capturing(module, out_dir):
    """A stand-in for `module.save_checkpoint` that also copies each
    rolling checkpoint with an iterator state to
    `out_dir/<epoch>_<steps_done>.pickle` and records the state."""
    save = module.save_checkpoint
    states = {}

    def capture(path, *args, iterator_state=None, **kwargs):
        save(path, *args, iterator_state=iterator_state, **kwargs)
        if iterator_state is not None:
            key = (iterator_state["epoch"], iterator_state["steps_done"])
            states[key] = iterator_state
            shutil.copy(path, os.path.join(out_dir, "%d_%d.pickle" % key))
    return capture, states


def _interrupted(module, runner, out_dir):
    """Train `runner` (checkpointing every step) with the capture in
    place; returns the captured iterator states."""
    capture, states = _capturing(module, str(out_dir))
    original = module.save_checkpoint
    module.save_checkpoint = capture
    try:
        runner.train()
    finally:
        module.save_checkpoint = original
    return states


def _last_of_epoch(states, epoch):
    return max(steps for e, steps in states if e == epoch)


# ------------------------------------------------------ port-to-port resume

@pytest.fixture(scope="module")
def dropout_runs(tmp_path_factory):
    """With dropout on: the port's uninterrupted 2 epochs, and the same
    run checkpointing every step with each rolling checkpoint kept."""
    root = tmp_path_factory.mktemp("port_dropout")
    config = _config(DROPOUT)
    ref = _port(config, root / "ref", tensorboard=False)
    ref.train()
    runner = _port(config, root / "a", tensorboard=False,
                   checkpoint_every_steps=1)
    states = _interrupted(runner_mod, runner, root)
    return config, ref, runner, states, root


def test_mid_epoch_resume_with_dropout_replays_the_uninterrupted_run(
        dropout_runs):
    config, ref, interrupted, states, root = dropout_runs
    ckpt = str(root / "2_1.pickle")
    it = checkpoint.load_iterator_state(ckpt)
    assert it["epoch"] == 2 and it["steps_done"] == 1
    assert it["torch_generator_device"] == "cpu"
    assert it["torch_generator_state"].dtype == np.uint8
    # The rolling checkpoint carries the Adam state and the step count.
    first_epoch = _last_of_epoch(states, 1)
    resumed = _port(config, root / "b", tensorboard=False, restore=ckpt)
    assert resumed.train_step_id == first_epoch + 1
    assert resumed.optimizer.count == first_epoch + 1
    log = resumed.train()
    assert [e["epoch"] for e in log] == [2]
    assert resumed.train_step_id == ref.train_step_id
    _assert_params(_port_params(resumed), _port_params(ref), 1e-5, 1e-6)
    # The interrupted run itself is the uninterrupted one.
    _assert_params(_port_params(interrupted), _port_params(ref), 0, 0)


def test_epoch_boundary_checkpoint_resumes_at_the_next_epoch(dropout_runs):
    """A rolling checkpoint on an epoch's last step continues at the next
    epoch with the post-shuffle RNG; patience restarts from there."""
    config, ref, _, states, root = dropout_runs
    last = _last_of_epoch(states, 1)
    ckpt = str(root / f"1_{last}.pickle")
    assert checkpoint.load_iterator_state(ckpt)["steps_done"] == last
    resumed = _port(config, root / "c", tensorboard=False, restore=ckpt)
    log = resumed.train()
    assert [e["epoch"] for e in log] == [2]
    _assert_params(_port_params(resumed), _port_params(ref), 1e-5, 1e-6)


def test_generator_state_of_another_device_keeps_the_seeded_stream(
        dropout_runs, tmp_path, capsys):
    """A CUDA generator state does not fit a CPU generator: the resume
    says so once and keeps the run's seeded stream."""
    import pickle
    config, _, _, _, root = dropout_runs
    with open(root / "2_1.pickle", "rb") as f:
        payload = pickle.load(f)
    payload["iterator_state"]["torch_generator_device"] = "cuda"
    ckpt = tmp_path / "cuda_state.pickle"
    with open(ckpt, "wb") as f:
        pickle.dump(payload, f)
    resumed = _port(config, tmp_path / "run", tensorboard=False,
                    restore=str(ckpt))
    seeded = resumed.generator.get_state()
    capsys.readouterr()
    resumed._resume_epoch()
    out = capsys.readouterr().out
    assert out.count("keeps the seeded dropout stream") == 1
    assert torch.equal(resumed.generator.get_state(), seeded)


def test_validation_and_prediction_draw_nothing_from_the_generator(
        dropout_runs, tmp_path):
    config = dropout_runs[0]
    runner = _port(config, tmp_path, tensorboard=False)
    before = runner.generator.get_state()
    runner.run_epoch("validation", runner.valid_processed, False)
    runner.predict(VALID)
    assert torch.equal(runner.generator.get_state(), before)
    runner.run_epoch("training", runner.train_processed, True)
    assert not torch.equal(runner.generator.get_state(), before)


def test_iterator_state_encoding_round_trips_as_jax_encodes_it(
        dropout_runs):
    from ggnn_tpu.training.checkpoint import \
        _encode_iterator_state as jax_encode
    states = dropout_runs[3]
    state = dict(states[(2, 1)], key=np.arange(2, dtype=np.uint32))
    encoded = checkpoint._encode_iterator_state(state)
    json.dumps(encoded)
    jax_part = {k: v for k, v in state.items()
                if not k.startswith("torch_")}
    assert {k: v for k, v in encoded.items() if not k.startswith("torch_")
            } == jax_encode(jax_part)
    decoded = checkpoint._decode_iterator_state(encoded)
    for key, value in state.items():
        if key == "np_rng_state":
            for a, b in zip(decoded[key], value):
                np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_array_equal(decoded[key], value)
    assert decoded["torch_generator_state"].dtype == np.uint8


# ------------------------------------------------- resume across packages

@pytest.fixture(scope="module")
def cross_runs(tmp_path_factory):
    """Keep probabilities 1.0: JAX's uninterrupted run with summaries,
    JAX's run checkpointing every step, and the port's run checkpointing
    every step from JAX's initial weights, with summaries."""
    root = tmp_path_factory.mktemp("cross")
    jax_ref = _jax(_config(NO_DROPOUT, jax_resolve_config), root / "jref",
                   tensorboard=True)
    init = _flatten_named({"params": jax_ref.state["params"]})
    jax_ref.train()
    # The JAX Runner leaves its writers open, and a tensorboardX flush
    # does not drain the writer's queue: close them before reading.
    jax_ref.summaries.close()
    jax_int = _jax(_config(NO_DROPOUT, jax_resolve_config), root / "jint",
                   tensorboard=False, checkpoint_every_steps=1)
    (root / "jax_ckpts").mkdir()
    _interrupted(jax_runner_mod, jax_int, root / "jax_ckpts")
    port_int = _port(_config(NO_DROPOUT), root / "pint",
                     checkpoint_every_steps=1)
    port_int.params.load_state_dict(params_from_jax_weights(init))
    (root / "port_ckpts").mkdir()
    port_states = _interrupted(runner_mod, port_int, root / "port_ckpts")
    return jax_ref, port_int, port_states, root


def test_jax_mid_epoch_checkpoint_resumes_in_the_port(cross_runs, capsys):
    jax_ref, _, _, root = cross_runs
    ckpt = str(root / "jax_ckpts" / "2_1.pickle")
    resumed = _port(_config(NO_DROPOUT), root / "port_resumed",
                    tensorboard=False, restore=ckpt)
    log = resumed.train()
    assert "keeps the seeded dropout stream" in capsys.readouterr().out
    assert [e["epoch"] for e in log] == [2]
    assert resumed.train_step_id == jax_ref.train_step_id
    _assert_params(_port_params(resumed), _jax_params(jax_ref), 5e-4, 5e-5)


def test_port_mid_epoch_checkpoint_resumes_in_jax(cross_runs):
    jax_ref, _, port_states, root = cross_runs
    ckpt = str(root / "port_ckpts" / "2_1.pickle")
    it = jax_load_iterator_state(ckpt)
    saved = port_states[(2, 1)]
    assert it["epoch"] == saved["epoch"] == 2
    assert it["steps_done"] == saved["steps_done"] == 1
    assert it["np_rng_state"][0] == saved["np_rng_state"][0]
    for a, b in zip(it["np_rng_state"][1:], saved["np_rng_state"][1:]):
        np.testing.assert_array_equal(a, b)
    resumed = _jax(_config(NO_DROPOUT, jax_resolve_config),
                   root / "jax_resumed", tensorboard=False, restore=ckpt)
    log = resumed.train()
    assert [e["epoch"] for e in log] == [2]
    _assert_params(_jax_params(resumed), _jax_params(jax_ref), 5e-4, 5e-5)


# --------------------------------------------------------------- summaries

def _scalars(log_dir, monkeypatch):
    """{(split, tag): [(step, value)]} of a run's TensorBoard events, read
    by tensorboard's reader (through its own record reader: with
    TensorFlow importable it would load TensorFlow, for seconds)."""
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    from tensorboard.backend.event_processing.event_accumulator import \
        EventAccumulator
    out = {}
    runs = glob.glob(os.path.join(str(log_dir), "tb", "*"))
    assert len(runs) == 1, runs
    for split in ("train", "validation"):
        acc = EventAccumulator(os.path.join(runs[0], split))
        acc.Reload()
        for tag in acc.Tags()["scalars"]:
            out[split, tag] = [(e.step, e.value) for e in acc.Scalars(tag)]
    return out


def test_summaries_match_jax_tags_steps_and_values(cross_runs,
                                                   monkeypatch):
    jax_ref, port_run, _, root = cross_runs
    want = _scalars(root / "jref", monkeypatch)
    got = _scalars(root / "pint", monkeypatch)
    assert sorted(got) == sorted(want) == [
        ("train", "accuracy0"), ("train", "loss"),
        ("validation", "accuracy0"), ("validation", "loss")]
    for key in want:
        assert [s for s, _ in got[key]] == [s for s, _ in want[key]], key
        np.testing.assert_allclose([v for _, v in got[key]],
                                   [v for _, v in want[key]], rtol=5e-4,
                                   err_msg=str(key))
    assert [s for s, _ in got["train", "loss"]] == list(
        range(port_run.train_step_id))
    assert port_run.summaries.enabled is False   # train() closed it


def test_summaries_steps_persist_across_a_resume(cross_runs, monkeypatch):
    _, port_run, port_states, root = cross_runs
    resumed = _port(_config(NO_DROPOUT), root / "tb_resumed",
                    restore=str(root / "port_ckpts" / "2_1.pickle"))
    resumed.train()
    steps = [s for s, _ in
             _scalars(root / "tb_resumed", monkeypatch)["train", "loss"]]
    first_epoch = _last_of_epoch(port_states, 1)
    assert steps == list(range(first_epoch + 1, port_run.train_step_id))


def test_summaries_are_a_no_op_without_tensorboardx(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    sink = SummarySink(str(tmp_path), "run")
    assert sink.enabled is False
    sink.add_batch("train", 0, 1.0, [0.5], [0])
    sink.flush()
    sink.close()
    runner = _port(_config({**NO_DROPOUT, "num_epochs": 1}), tmp_path)
    runner.train()
    assert not os.path.exists(tmp_path / "tb")


# ---------------------------------------------------------------- profile

def test_profile_writes_one_chrome_trace_of_epoch_one(monkeypatch,
                                                      tmp_path):
    steps = []
    run_epoch = Runner.run_epoch

    def counted(self, name, processed, is_training):
        result = run_epoch(self, name, processed, is_training)
        steps.append((name, result[4]))
        return result

    monkeypatch.setattr(Runner, "run_epoch", counted)
    profile_dir = tmp_path / "profile"
    assert cli.main(["sparse", "--synthetic", "60", "--device", "cpu",
                     "--quiet", "--config", json.dumps(SMALL),
                     "--log_dir", str(tmp_path), "--profile",
                     str(profile_dir)]) == 0
    traces = os.listdir(profile_dir)
    assert len(traces) == 1 and traces[0].endswith("_epoch1_trace.json")
    with open(profile_dir / traces[0]) as f:
        events = json.load(f)["traceEvents"]
    ops = collections.Counter(e["name"] for e in events
                              if e.get("cat") == "cpu_op"
                              and e["name"].startswith("ggnn_tpu_torch::"))
    epoch1 = dict(steps)["epoch 1 (training)"]
    prop_steps = sum(SMALL["layer_timesteps"])
    # Epoch 1's training steps alone: not its validation, not epoch 2.
    # The GRU's K1/K2 forward and K3/K4 backward once a propagation step.
    assert ops == {"ggnn_tpu_torch::gather_segment_sum": prop_steps * epoch1,
                   "ggnn_tpu_torch::segment_scatter_sum":
                       (prop_steps - 1) * epoch1,
                   **{f"ggnn_tpu_torch::{op}": prop_steps * epoch1
                      for op in ("gru_gates", "gru_update", "gru_update_bwd",
                                 "gru_gates_bwd")}}
    # The port's spans are in it, a step each (utils/spans.py), and off
    # again after it, nothing of them kept.
    spans = collections.Counter(e["name"] for e in events
                                if e["name"].startswith("ggnn."))
    assert spans["ggnn.step"] == epoch1
    assert spans["ggnn.prefetch.wait"] == epoch1 + 1
    assert not span_recorder.on(False)
    assert span_recorder.drain() == ([], {"spans_dropped": 0})


# ------------------------------------------------------------- evaluation

EVAL_CONFIGS = {
    "sparse": {"batch_size": 300},
    "blocked": {"batch_size": 4},
    "gcn": {"batch_size": 300},
    "async": {"propagation_substeps": 40, "num_nodes": 400},
}


@pytest.mark.parametrize("variant", sorted(EVAL_CONFIGS))
def test_predict_matches_jax_predict_on_a_jax_checkpoint(variant, tmp_path):
    config_json = json.dumps({"hidden_size": 16, "num_epochs": 1,
                              **EVAL_CONFIGS[variant]})
    train = synthetic_molecules(40, seed=5)
    request = synthetic_molecules(14, seed=6)
    jax_runner = JaxRunner(variant, jax_resolve_config(
        variant, config_json=config_json), train_data=train,
        valid_data=request, log_dir=str(tmp_path), quiet=True,
        tensorboard=False)
    path = str(tmp_path / "jax.pickle")
    jax_save(path, jax_runner.config, jax_runner.state, 0, 0)
    port = Runner(variant, resolve_config(variant, config_json=config_json),
                  train_data=train, valid_data=request,
                  log_dir=str(tmp_path), quiet=True, device="cpu",
                  restore=path)
    want = np.concatenate([np.asarray(o)
                           for o in jax_runner.predict(request)], axis=1)
    got = np.concatenate(port.predict(request), axis=1)
    assert got.shape == (1, len(request))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_blocked_predict_returns_request_order(tmp_path):
    """Dense bucketing reorders the graphs; each row is its request's
    (oracle: one prediction a graph)."""
    config = resolve_config("blocked", config_json=json.dumps(
        {"num_epochs": 1, "hidden_size": 16, "batch_size": 4}))
    mols = synthetic_molecules(12, seed=9)
    runner = Runner("blocked", config, log_dir=str(tmp_path),
                    train_data=mols, valid_data=mols[:4], quiet=True,
                    device="cpu")
    runner.train()
    got = np.concatenate(runner.predict(mols), axis=1)
    want = np.concatenate([runner.predict([m])[0] for m in mols], axis=1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_use_graph_false_predict_reads_zeroed_states(tmp_path):
    """The readout sees zeroed final states, as the training loss did:
    two graphs with the same node features and different edges get the
    same prediction."""
    config = resolve_config("sparse", config_json=json.dumps(
        {"num_epochs": 1, "hidden_size": 16, "batch_size": 60,
         "use_graph": False}))
    mols = synthetic_molecules(20, seed=4)
    runner = Runner("sparse", config, log_dir=str(tmp_path),
                    train_data=mols, valid_data=mols[:5], quiet=True,
                    device="cpu")
    runner.train()
    g = dict(synthetic_molecules(1, seed=42)[0])
    g2 = dict(g, graph=[[0, 1, 1]])
    np.testing.assert_array_equal(runner.predict([g])[0],
                                  runner.predict([g2])[0])


def test_cli_trains_then_evaluates_the_restored_model(tmp_path, capsys):
    args = ["sparse", "--synthetic", "60", "--device", "cpu", "--config",
            json.dumps({"num_epochs": 1, "hidden_size": 8,
                        "batch_size": 300}),
            "--log_dir", str(tmp_path), "--quiet"]
    assert cli.main(args) == 0
    ckpts = glob.glob(str(tmp_path / "*_model_best.pickle"))
    assert len(ckpts) == 1
    capsys.readouterr()
    assert cli.main(args + ["--restore", ckpts[0], "--evaluate"]) == 0
    out = capsys.readouterr().out.splitlines()
    # example_evaluation: the 6 validation molecules' targets, then one
    # [1, 6] array of predictions.
    assert len([line for line in out if line.startswith("[[")]) >= 7
    assert len(glob.glob(str(tmp_path / "*_log.json"))) == 1
