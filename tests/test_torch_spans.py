"""The port's span recorder (`ggnn_tpu_torch/utils/spans.py`) and the
spans the port records where its host work happens, on the CPU: off by
default and then one shared context that records nothing; nesting,
parents, threads and attributes; the cap and its drop count; `pulls`,
the timed pulls of the consumer's and the producer's loops; the mirror
events a profiler sees, on the spans' clock; a CPU Runner's spans, and
the epochs function's on its replay path (the fake card of
tests/torch_fake_card.py stands in for the captures). The replay and
capture spans of real CUDA graphs are held on the card
(tests/test_torch_cuda.py)."""

import collections
import json
import threading
import time

import pytest
import torch

from ggnn_tpu_torch.data.synthetic import synthetic_molecules
from ggnn_tpu_torch.training.config import resolve_config
from ggnn_tpu_torch.training.runner import Runner
from ggnn_tpu_torch.utils import spans
from ggnn_tpu_torch.utils.prefetch import ThreadedIterator

import torch_fake_card

torch.set_num_threads(1)

SMALL = {"hidden_size": 16, "layer_timesteps": [2, 1],
         "residual_connections": {"1": [0]}, "batch_size": 300,
         "random_seed": 3}


@pytest.fixture
def recording():
    """Spans on for the test, with nothing kept from before; off and
    drained after."""
    spans.drain()
    was = spans.on(True)
    yield
    spans.on(was)
    spans.drain()


def _runner(tmp_path, n_train=60):
    config = resolve_config("sparse", config_json=json.dumps(SMALL))
    return Runner("sparse", config,
                  train_data=synthetic_molecules(n_train, seed=11),
                  valid_data=synthetic_molecules(20, seed=12),
                  log_dir=str(tmp_path), quiet=True, tensorboard=False,
                  device="cpu")


def test_off_by_default_one_shared_context_that_records_nothing():
    spans.drain()
    assert spans.on(False) is False
    first = spans.span("ggnn.test")
    assert spans.span("ggnn.test", step=3) is first
    with first:
        with spans.span("ggnn.test.inner"):
            pass
    assert spans.drain() == ([], {"spans_dropped": 0})


def test_nesting_parents_threads_and_attributes(recording):
    def worker():
        with spans.span("ggnn.pack.batch", step=1):
            time.sleep(1e-3)

    with spans.span("ggnn.outer") as outer:
        with spans.span("ggnn.inner", step=1):
            thread = threading.Thread(target=worker)
            thread.start()
            thread.join(timeout=10)
        with spans.span("ggnn.inner", step=2):
            pass
    assert not thread.is_alive()
    records, counters = spans.drain()
    assert counters == {"spans_dropped": 0}
    by_name = collections.defaultdict(list)
    for r in records:
        by_name[r.name].append(r)
    (top,) = by_name["ggnn.outer"]
    assert top.id == outer.id and top.parent == 0
    assert [r.attrs for r in by_name["ggnn.inner"]] == [{"step": 1},
                                                        {"step": 2}]
    assert all(r.parent == top.id for r in by_name["ggnn.inner"])
    assert all(top.start_ns <= r.start_ns <= r.end_ns <= top.end_ns
               for r in by_name["ggnn.inner"])
    (packed,) = by_name["ggnn.pack.batch"]
    # Another thread's span has no parent there, and its own thread.
    assert packed.parent == 0 and packed.thread != top.thread
    assert packed.thread == thread.ident and top.thread == \
        threading.get_ident()
    assert packed.attrs == {"step": 1}
    assert packed.end_ns - packed.start_ns >= 1_000_000
    # In the order they closed; ids unique.
    assert records[-1].name == "ggnn.outer"
    assert len({r.id for r in records}) == len(records)
    assert spans.drain() == ([], {"spans_dropped": 0})


def test_cap_counts_the_spans_it_drops(recording, monkeypatch):
    monkeypatch.setattr(spans, "CAP", 3)
    for i in range(5):
        with spans.span("ggnn.test", step=i):
            pass
    records, counters = spans.drain()
    assert [r.attrs["step"] for r in records] == [0, 1, 2]
    assert counters == {"spans_dropped": 2}
    with spans.span("ggnn.test"):
        pass
    records, counters = spans.drain()
    assert len(records) == 1 and counters == {"spans_dropped": 0}


def test_each_span_is_mirrored_in_a_profile_on_its_clock(recording):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for i in range(3):
            with spans.span("ggnn.test.mirrored", step=i):
                time.sleep(2e-3)
    with spans.span("ggnn.test.unprofiled"):
        pass
    records, _ = spans.drain()
    mirrored = sorted(e.start_ns() for e in
                      prof.profiler.kineto_results.events()
                      if e.name() == "ggnn.test.mirrored")
    ours = sorted(r.start_ns for r in records
                  if r.name == "ggnn.test.mirrored")
    assert len(mirrored) == len(ours) == 3
    for theirs, mine in zip(mirrored, ours):
        assert abs(theirs - mine) < 5_000_000
    assert "ggnn.test.unprofiled" not in {
        e.name() for e in prof.profiler.kineto_results.events()}


def test_a_cpu_runner_records_its_host_pipeline(recording, tmp_path):
    runner = _runner(tmp_path)
    epochs_fn, groups, steps = runner.device_epochs()
    epochs_fn(groups, 1)
    _, _, _, _, epoch_steps = runner.run_epoch(
        "epoch 1 (training)", runner.train_processed, True)
    records, counters = spans.drain()
    assert counters == {"spans_dropped": 0}
    names = collections.Counter(r.name for r in records)
    for name in ("ggnn.preprocess", "ggnn.epochs", "ggnn.epoch.read"):
        assert names[name] == 1, name
    assert names["ggnn.step"] == epoch_steps > 1
    # One wait a batch and one at the end; one pull a batch and the one
    # that finds the source exhausted.
    assert names["ggnn.prefetch.wait"] == epoch_steps + 1
    assert names["ggnn.pack.batch"] == epoch_steps + 1
    # Batch i is packed in the prefetch thread, stepped in this one.
    step_of = {r.attrs["step"]: r for r in records if r.name == "ggnn.step"}
    for packed in (r for r in records if r.name == "ggnn.pack.batch"
                   and r.attrs["step"] in step_of):
        stepped = step_of[packed.attrs["step"]]
        assert packed.thread != stepped.thread
        assert packed.end_ns <= stepped.start_ns
    # No CUDA graph on the CPU: no key walk, capture or replay.
    assert not {"ggnn.epochs.keys", "ggnn.capture",
                "ggnn.replay"} & set(names)


def test_the_epochs_function_walks_its_keys_before_the_first_replay(
        recording, tmp_path):
    runner = _runner(tmp_path, n_train=120)
    with torch_fake_card.fake_card() as captured:
        epochs_fn, groups, _ = runner.device_epochs()
        spans.drain()
        epochs_fn(groups, 2)
        epochs_fn(groups, 1)
    assert captured
    records, _ = spans.drain()
    calls = [r for r in records if r.name == "ggnn.epochs"]
    keys = [r for r in records if r.name == "ggnn.epochs.keys"]
    assert len(calls) == len(keys) == 2
    for call, walk in zip(calls, keys):
        assert walk.parent == call.id
        assert call.start_ns <= walk.start_ns <= walk.end_ns <= call.end_ns


def test_pulls_times_each_pull_and_the_one_that_finds_the_end(recording):
    def source():
        yield "a"
        time.sleep(1e-3)
        yield "b"
        raise KeyError("source fault")

    assert list(spans.pulls(["a", "b"], "ggnn.test.pull")) == [(0, "a"),
                                                               (1, "b")]
    records, _ = spans.drain()
    assert [r.attrs for r in records] == [{"step": 0}, {"step": 1},
                                          {"step": 2}]
    with pytest.raises(KeyError, match="source fault"):
        list(spans.pulls(source(), "ggnn.test.pull"))
    records, _ = spans.drain()
    # The failed pull's span closed; the slow pull's took its time.
    assert [r.attrs["step"] for r in records] == [0, 1, 2]
    assert records[1].end_ns - records[1].start_ns >= 1_000_000
    spans.on(False)
    assert list(spans.pulls(iter([None]), "ggnn.test.pull")) == [(0, None)]
    assert spans.drain() == ([], {"spans_dropped": 0})


def test_a_source_that_yields_none_still_raises_on_the_consumer():
    with pytest.raises(ValueError, match="must not be None"):
        list(ThreadedIterator(iter([1, None, 2])))
    assert list(ThreadedIterator(iter([1, 2]))) == [1, 2]
