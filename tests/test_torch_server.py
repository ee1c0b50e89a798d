"""The port's HTTP prediction server (ggnn_tpu_torch/server.py) on the
CPU: a counterpart of each server and dispatcher test of
tests/test_serving.py (the HTTP round trip, concurrent and coalesced
clients, error isolation, the fairness cap, warm-up, the CLI), the two
rules in which the port differs from the JAX server (a leader returns
once its own request is answered; no waiter tries the device lock while
its request is being served), and the answers against the JAX Predictor
on the same checkpoint at 2e-5 (the tolerance tests/test_torch_serving.py
holds the port's Predictor to)."""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from ggnn_tpu.serving import Predictor as JaxPredictor
from ggnn_tpu_torch.data.loader import DatasetMeta
from ggnn_tpu_torch.data.synthetic import synthetic_molecules
from ggnn_tpu_torch.models.base import ModelParams, init_output_heads
from ggnn_tpu_torch.serving import Predictor
from ggnn_tpu_torch.server import (CoalescingDispatcher, PredictionServer,
                                   main)
from ggnn_tpu_torch.training.checkpoint import save_checkpoint
from ggnn_tpu_torch.training.config import resolve_config
from ggnn_tpu_torch.training.variants import make_adapter

torch.set_num_threads(1)

SOLO = dict(rtol=1e-6, atol=1e-7)
MERGED = dict(rtol=1e-5, atol=1e-6)


def _checkpoint(path, variant="sparse", overrides=None, seed=0):
    """A random-weight checkpoint of `variant` (hidden 16) written by the
    port."""
    overrides = {"hidden_size": 16, "native_pack": False,
                 **(overrides or {})}
    config = resolve_config(variant, config_json=json.dumps(overrides))
    gen = torch.Generator().manual_seed(seed)
    adapter = make_adapter(variant, config, DatasetMeta(64, 4, 16))
    params = ModelParams(adapter.build_model(gen),
                         init_output_heads(gen, 16, config["task_ids"]))
    save_checkpoint(str(path), config, params, 0, 0)
    return str(path)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return _checkpoint(tmp_path_factory.mktemp("server") / "sparse.pickle")


def _predictor(path, variant="sparse", max_nodes=256, max_graphs=32):
    return Predictor.from_checkpoint(path, variant, max_nodes=max_nodes,
                                     max_graphs=max_graphs, device="cpu")


def _post(base, graphs, timeout=120):
    req = urllib.request.Request(
        f"{base}/predict", data=json.dumps({"graphs": graphs}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return np.asarray(json.load(r)["outputs"])


class _Serving:
    """A started server over `predictor`, shut down on exit."""

    def __init__(self, predictor, **kwargs):
        self.server = PredictionServer(predictor, port=0, **kwargs)

    def __enter__(self):
        self.server.warmup()
        self.server.start()
        host, port = self.server.address
        return self.server, f"http://{host}:{port}"

    def __exit__(self, *exc):
        self.server.shutdown()


def _clients(base, payloads):
    """Every payload POSTed from its own thread at once: (answers,
    errors); an HTTP error's answer is ("http_error", code)."""
    got = [None] * len(payloads)
    errors = []

    def client(i):
        try:
            got[i] = _post(base, payloads[i])
        except urllib.error.HTTPError as exc:
            got[i] = ("http_error", exc.code)
        except Exception as exc:  # surfaced in the main thread
            errors.append((i, exc))

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(payloads))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
    return got, errors


def test_prediction_server_http_roundtrip(ckpt):
    """/healthz and /predict over real HTTP agree with the in-process
    Predictor and with the JAX Predictor on the same checkpoint; a
    malformed request gets a 400 and the server keeps serving."""
    predictor = _predictor(ckpt)
    with _Serving(predictor) as (_, base):
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
            health = json.load(r)
        assert health == {"status": "ok", "variant": "sparse", "tasks": [0],
                          "max_nodes": 256, "max_graphs": 32,
                          "requests_served": 0, "device_calls": 0,
                          "coalesced_requests": 0}
        mols = synthetic_molecules(5, seed=9)
        got = _post(base, mols)
        assert got.shape == (1, 5)
        np.testing.assert_allclose(got, predictor(mols), **SOLO)
        want = JaxPredictor.from_checkpoint(ckpt, "sparse", max_nodes=256,
                                            max_graphs=32)(mols)
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)

        bad = urllib.request.Request(f"{base}/predict", data=b"{}")
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(bad, timeout=30)
        assert err.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(f"{base}/nope", timeout=30)
        assert err.value.code == 404
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
            health = json.load(r)
        assert health["requests_served"] == 1
        assert health["device_calls"] == 1


def test_prediction_server_concurrent_requests(ckpt):
    """Parallel clients interleave arbitrarily but each gets exactly its
    own answer."""
    predictor = _predictor(ckpt)
    payloads = [synthetic_molecules(3, seed=100 + i) for i in range(8)]
    want = [predictor(p) for p in payloads]
    with _Serving(predictor) as (_, base):
        got, errors = _clients(base, payloads)
    assert not errors, errors
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **MERGED)


def test_prediction_server_cli_entry():
    """--help parses (argparse wiring) without loading a checkpoint."""
    with pytest.raises(SystemExit) as exc:
        main(["--help"])
    assert exc.value.code == 0


def test_server_cli_serves_on_the_cpu_and_needs_cuda_otherwise(
        ckpt, monkeypatch):
    """`main` serves one request with --device cpu (its `ready` hook
    drives the listening server); without CUDA and without --device cpu
    it raises before listening."""
    mols = synthetic_molecules(2, seed=12)
    seen = {}

    def ready(server):
        host, port = server.address
        try:
            seen["out"] = _post(f"http://{host}:{port}", mols)
            with urllib.request.urlopen(f"http://{host}:{port}/healthz",
                                        timeout=30) as r:
                seen["health"] = json.load(r)
        finally:
            server.shutdown()

    main(["--checkpoint", ckpt, "--port", "0", "--device", "cpu",
          "--max-nodes", "64", "--max-graphs", "8"], ready=ready)
    np.testing.assert_allclose(
        seen["out"], _predictor(ckpt, max_nodes=64, max_graphs=8)(mols),
        **SOLO)
    assert seen["health"]["max_nodes"] == 64
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--checkpoint", ckpt, "--port", "0"])


def test_server_warmup_with_non_zero_task_ids(tmp_path):
    """Warm-up builds a valid probe graph when task_ids are not 0..K-1
    (targets are indexed by task id)."""
    path = _checkpoint(tmp_path / "task1.pickle",
                       overrides={"task_ids": [1], "layer_timesteps": [1],
                                  "residual_connections": {}})
    server = PredictionServer(_predictor(path, max_nodes=64, max_graphs=4),
                              port=0)
    server.warmup()
    assert server.health()["requests_served"] == 0
    server.shutdown()


def test_prediction_server_concurrent_single_and_microbatched(ckpt):
    """Batch-of-one requests (the fast pack) racing requests past the
    envelope (micro-batched inside the Predictor): each client gets the
    answer it would get alone."""
    predictor = _predictor(ckpt, max_nodes=96, max_graphs=8)
    payloads = [synthetic_molecules(1 if i % 2 else 24, seed=500 + i)
                for i in range(6)]
    want = [predictor(p) for p in payloads]
    with _Serving(predictor) as (_, base):
        got, errors = _clients(base, payloads)
    assert not errors, errors
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, **MERGED, err_msg=f"client {i}")


# ------------------------------------------------ request coalescing

class _StubPredictor:
    """Records every call's graph count and, while a call runs, the
    threads whose graphs it serves; optional delay, and a poison marker
    that raises."""

    def __init__(self, delay=0.0, poison=False):
        self.delay = delay
        self.poison = poison
        self.call_sizes = []
        self.serving = frozenset()

    def __call__(self, graphs):
        self.call_sizes.append(len(graphs))
        self.serving = frozenset(g.get("tid") for g in graphs)
        try:
            if self.delay:
                time.sleep(self.delay)
            if self.poison and any(g.get("poison") for g in graphs):
                raise ValueError("poisoned graph")
            # outputs [K=1, n]: each graph's "value", so that slicing is
            # verifiable per request.
            return np.asarray([[g["value"] for g in graphs]], np.float64)
        finally:
            self.serving = frozenset()


def _submit_all(disp, payloads, barrier=True):
    """Each payload submitted from its own thread: (answers, errors)."""
    got = [None] * len(payloads)
    errors = [None] * len(payloads)
    start = threading.Barrier(len(payloads))

    def client(i):
        if barrier:
            start.wait(timeout=30)
        try:
            got[i] = np.asarray(disp.submit(payloads[i]))
        except Exception as exc:
            errors[i] = exc

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(payloads))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    return got, errors


def test_coalescing_dispatcher_merges_concurrent_requests():
    """While the device is busy, queued requests merge into one Predictor
    call and every client gets exactly its own output columns."""
    stub = _StubPredictor(delay=0.05)
    disp = CoalescingDispatcher(stub)
    n_clients, per = 12, 3
    payloads = [[{"value": 100.0 * i + j} for j in range(per)]
                for i in range(n_clients)]
    got, errors = _submit_all(disp, payloads)
    assert errors == [None] * n_clients
    for i in range(n_clients):
        np.testing.assert_array_equal(
            got[i], [[100.0 * i + j for j in range(per)]])
    assert disp.device_calls < n_clients, stub.call_sizes
    assert disp.coalesced_requests >= n_clients - disp.device_calls
    assert sum(stub.call_sizes) == n_clients * per  # nothing dropped


def test_coalescing_dispatcher_sequential_requests_stay_single():
    """A lone request dispatches alone: the batch-of-one fast paths stay
    reachable under sequential traffic."""
    stub = _StubPredictor()
    disp = CoalescingDispatcher(stub)
    for i in range(4):
        np.testing.assert_array_equal(disp.submit([{"value": float(i)}]),
                                      [[float(i)]])
    assert stub.call_sizes == [1, 1, 1, 1]
    assert disp.coalesced_requests == 0


def test_coalescing_dispatcher_isolates_poisoned_request():
    """A malformed graph fails its own request only: the merged call's
    failure replays each member alone."""
    stub = _StubPredictor(delay=0.05, poison=True)
    disp = CoalescingDispatcher(stub)
    payloads = [[{"value": 1.0}], [{"value": 2.0, "poison": True}],
                [{"value": 3.0}]]
    got, errors = _submit_all(disp, payloads)
    np.testing.assert_array_equal(got[0], [[1.0]])
    np.testing.assert_array_equal(got[2], [[3.0]])
    assert got[1] is None and "poisoned" in str(errors[1])
    assert errors[0] is None and errors[2] is None


def test_coalescing_dispatcher_fairness_cap():
    """max_batch_graphs bounds one merged call; every request is still
    answered."""
    stub = _StubPredictor(delay=0.05)
    disp = CoalescingDispatcher(stub, max_batch_graphs=4)
    payloads = [[{"value": float(i)}, {"value": float(i) + 0.5}]
                for i in range(8)]
    got, errors = _submit_all(disp, payloads)
    assert errors == [None] * 8
    for i in range(8):
        np.testing.assert_array_equal(got[i], [[float(i), float(i) + 0.5]])
    assert max(stub.call_sizes) <= 4


def test_leader_returns_once_its_own_request_is_answered():
    """Under load with the cap at 4, the first submitter leads the first
    call and returns after at most 2 device calls (the JAX leader drains
    the whole queue: 5 calls here) while the others lead the rest."""
    stub = _StubPredictor(delay=0.1)
    disp = CoalescingDispatcher(stub, max_batch_graphs=4)
    calls_at_return = []

    def first():
        disp.submit([{"value": 0.0}, {"value": 0.5}])
        calls_at_return.append(disp.device_calls)

    leader = threading.Thread(target=first)
    leader.start()
    deadline = time.monotonic() + 30
    while not stub.call_sizes and time.monotonic() < deadline:
        time.sleep(0.001)
    payloads = [[{"value": float(i)}, {"value": float(i) + 0.5}]
                for i in range(1, 8)]
    got, errors = _submit_all(disp, payloads, barrier=False)
    leader.join(timeout=60)
    assert calls_at_return and calls_at_return[0] <= 2, calls_at_return
    assert errors == [None] * 7
    for i, g in enumerate(got, start=1):
        np.testing.assert_array_equal(g, [[float(i), float(i) + 0.5]])
    assert stub.call_sizes[0] == 2 and max(stub.call_sizes) <= 4
    assert disp.device_calls >= 5


class _WatchedLock:
    """The device lock, noting each acquire attempt made by a thread
    whose request the stub is serving at that moment."""

    def __init__(self, stub):
        self._lock = threading.Lock()
        self.stub = stub
        self.attempts = 0
        self.while_served = []

    def acquire(self, blocking=True, timeout=-1):
        self.attempts += 1
        if threading.get_ident() in self.stub.serving:
            self.while_served.append(threading.get_ident())
        return self._lock.acquire(blocking, timeout)

    def release(self):
        self._lock.release()


def test_no_waiter_polls_the_lock_while_its_request_is_served():
    """A waiter tries the device lock only while its request is
    unclaimed; once a leader has taken it into a call, the waiter sleeps
    on its request's event until the answer (the JAX waiters try the
    lock every 5 ms for as long as a call runs)."""
    stub = _StubPredictor(delay=0.2)
    disp = CoalescingDispatcher(stub)
    disp._device = lock = _WatchedLock(stub)
    n = 10
    got = [None] * n
    start = threading.Barrier(n)

    def client(i):
        start.wait(timeout=30)
        got[i] = disp.submit([{"value": float(i),
                               "tid": threading.get_ident()}])

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    for i in range(n):
        np.testing.assert_array_equal(got[i], [[float(i)]])
    assert len(stub.call_sizes) >= 2 and max(stub.call_sizes) > 1
    assert lock.while_served == []
    # An unclaimed waiter tries the lock on entry, once a POLL_S while the
    # first call runs and once at the hand-off: not every 5 ms of it.
    assert lock.attempts <= n * (stub.delay / disp.POLL_S + 2), lock.attempts


def test_prediction_server_coalesced_outputs_match_solo(ckpt):
    """Concurrent clients against the coalescing server get the answers
    of solo Predictor calls, and /healthz exposes the counters."""
    predictor = _predictor(ckpt)
    payloads = [synthetic_molecules(2, seed=300 + i) for i in range(6)]
    want = [predictor(p) for p in payloads]
    with _Serving(predictor) as (server, base):
        assert server._dispatcher is not None  # coalescing is the default
        got, errors = _clients(base, payloads)
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
            stats = json.load(r)
    assert not errors, errors
    for i in range(6):
        np.testing.assert_allclose(got[i], want[i], **MERGED,
                                   err_msg=f"client {i}")
    assert stats["requests_served"] == 6
    assert 1 <= stats["device_calls"] <= 6
    assert stats["coalesced_requests"] == 6 - stats["device_calls"]


def test_prediction_server_http_error_isolation(ckpt):
    """Under coalescing a malformed request gets its 400; concurrent
    well-formed requests still get 200s with the right outputs."""
    predictor = _predictor(ckpt)
    good = [synthetic_molecules(2, seed=400 + i) for i in range(4)]
    bad = [{"targets": [[0.0]], "graph": [[0, 1, 1]],
            "node_features": []}]  # empty features: a pack-time error
    want = [predictor(p) for p in good]
    with _Serving(predictor) as (_, base):
        got, errors = _clients(base, good + [bad])
    assert not errors, errors
    assert got[4] == ("http_error", 400), got[4]
    for i in range(4):
        assert not isinstance(got[i], tuple), got[i]
        np.testing.assert_allclose(got[i], want[i], **MERGED,
                                   err_msg=f"client {i}")


def test_prediction_server_no_coalesce(ckpt):
    """--no-coalesce serializes one device call a request; /healthz then
    carries no coalescing counters."""
    predictor = _predictor(ckpt)
    payloads = [synthetic_molecules(1, seed=700 + i) for i in range(4)]
    with _Serving(predictor, coalesce=False) as (server, base):
        got, errors = _clients(base, payloads)
        health = server.health()
    assert not errors, errors
    for g, p in zip(got, payloads):
        np.testing.assert_allclose(g, predictor(p), **SOLO)
    assert health["requests_served"] == 4 and "device_calls" not in health


def test_prediction_server_coalesces_async_variant(tmp_path):
    """Coalescing composes with the async variant's serving caches:
    concurrent one-graph requests merge into multi-graph packs and still
    match solo answers."""
    path = _checkpoint(tmp_path / "async.pickle", "async",
                       {"propagation_rounds": 2,
                        "propagation_substeps": 25})
    predictor = _predictor(path, "async", max_nodes=256, max_graphs=16)
    payloads = [synthetic_molecules(1, seed=500 + i) for i in range(5)]
    want = [predictor(p) for p in payloads]
    with _Serving(predictor) as (_, base):
        got, errors = _clients(base, payloads)
    assert not errors, errors
    for i in range(5):
        np.testing.assert_allclose(got[i], want[i], **MERGED,
                                   err_msg=f"client {i}")
