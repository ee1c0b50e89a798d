"""Persistent inference server: a Predictor behind a long-lived HTTP
endpoint, the port of `ggnn_tpu/server.py` (standard library only).

    GET  /healthz            -> {"status": "ok", variant, tasks,
                                 max_nodes, max_graphs, requests_served,
                                 device_calls, coalesced_requests}
    POST /predict            body {"graphs": [<reference graph JSON>, ...]}
                             -> {"outputs": [[...per task...]], "num_graphs": N}

A `ggnn_tpu_torch.serving.Predictor` (or an `ExportedPredictor` from a
`.ggnnx` artifact, export.py) stays resident on the GPU, and requests
that arrive while the device is busy coalesce: one thread, the leader,
packs the queued requests' graphs into one Predictor call and hands each
request its output columns. Two rules differ from the JAX server:

  * fairness: a leader serves queued requests in arrival order, at most
    `max_coalesced_graphs` graphs a call, and returns as soon as its own
    request is answered; it wakes the next queued request's thread,
    which leads the rest (the JAX leader drains the whole queue, so the
    cap bounds a call but not its own client's wait);
  * no polling behind the device: a waiter contends for the device lock
    only while its request is unclaimed, and otherwise waits on its own
    request's event, which the leader sets when it answers (the JAX
    waiters try the lock every 5 ms for as long as a call runs).

CLI:  python -m ggnn_tpu_torch.server --checkpoint run_model_best.pickle \
          --variant sparse --port 8099 [--device cpu]

The server runs on the GPU unless `--device cpu` is given, and exits
non-zero without CUDA.
"""

import argparse
import collections
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from ggnn_tpu_torch.serving import Predictor


class _Pending:
    """One queued /predict request awaiting its slice of a device call.
    `claimed` is set (under the queue lock) when a leader takes it into a
    call, `event` when it is answered; `wake` is its thread's doorbell,
    rung when it is answered or when the device is handed to it."""
    __slots__ = ("graphs", "event", "wake", "claimed", "outputs", "error")

    def __init__(self, graphs):
        self.graphs = graphs
        self.event = threading.Event()
        self.wake = threading.Event()
        self.claimed = False
        self.outputs = None
        self.error = None

    def answer(self):
        self.event.set()
        self.wake.set()


class CoalescingDispatcher:
    """Leader/follower request batching over one Predictor.

    A submitting thread enqueues its request. If the request is still
    unclaimed and the device lock is free, the thread leads: it takes
    queued requests in arrival order, up to `max_batch_graphs` graphs a
    call (None: all of them), into merged Predictor calls until its own
    request is answered, then releases the device and wakes the thread
    of the oldest request still queued. A thread that does not lead
    waits on its request's `wake`: without a timeout once a leader has
    claimed the request, and for `POLL_S` at most while it is unclaimed
    (the timeout only backs up the hand-off). With one client every
    request is dispatched alone and takes the Predictor's batch-of-one
    fast paths.

    If a merged call fails (one malformed graph poisons the union), the
    batch is retried per request so the error lands only on the
    offender.
    """

    POLL_S = 0.05

    def __init__(self, predictor, max_batch_graphs: Optional[int] = None):
        self.predictor = predictor
        self.max_batch_graphs = max_batch_graphs
        self._queue = collections.deque()
        self._qlock = threading.Lock()
        self._device = threading.Lock()
        self.device_calls = 0
        self.coalesced_requests = 0

    def submit(self, graphs) -> np.ndarray:
        req = _Pending(list(graphs))
        with self._qlock:
            self._queue.append(req)
        while not req.event.is_set():
            # Under the queue lock, so that no leader claims the request
            # between the check and the try.
            with self._qlock:
                lead = not req.claimed and self._device.acquire(
                    blocking=False)
            if lead:
                try:
                    self._drain(req)
                finally:
                    self._device.release()
                    self._hand_off()
                continue
            req.wake.wait(None if req.claimed else self.POLL_S)
            req.wake.clear()
        if req.error is not None:
            raise req.error
        return req.outputs

    # -- internals ------------------------------------------------------

    def _hand_off(self):
        """Wake the thread of the oldest unclaimed request, which takes
        the device next."""
        with self._qlock:
            if self._queue:
                self._queue[0].wake.set()

    def _drain(self, own: _Pending):
        """Device lock held: serve queued requests in arrival order, up
        to the cap a call, until `own` is answered."""
        cap = self.max_batch_graphs
        while not own.event.is_set():
            with self._qlock:
                batch, n = [], 0
                while self._queue:
                    m = len(self._queue[0].graphs)
                    if batch and cap is not None and n + m > cap:
                        break
                    r = self._queue.popleft()
                    r.claimed = True
                    batch.append(r)
                    n += m
            if not batch:
                return
            self._run(batch)

    def _run(self, batch):
        # The finally backstop answers every dequeued request even if
        # something escapes the handlers below: an unanswered request
        # would leave its submitter waiting forever.
        try:
            self.device_calls += 1
            self.coalesced_requests += len(batch) - 1
            if len(batch) == 1:
                req = batch[0]
                try:
                    req.outputs = np.asarray(self.predictor(req.graphs))
                except Exception as exc:
                    req.error = exc
                req.answer()
                return
            merged = [g for r in batch for g in r.graphs]
            try:
                out = np.asarray(self.predictor(merged))  # [K, total]
            except Exception:
                # Isolate the offending request(s): replay individually
                # so well-formed neighbours still get answers.
                for r in batch:
                    self._run([r])
                return
            offset = 0
            for r in batch:
                m = len(r.graphs)
                r.outputs = out[:, offset:offset + m]
                offset += m
                r.answer()
        finally:
            for r in batch:
                if not r.event.is_set():
                    if r.error is None:
                        r.error = RuntimeError(
                            "prediction dispatch failed before producing "
                            "this request's outputs")
                    r.answer()


class _HTTPServer(ThreadingHTTPServer):
    """The standard threading server with a listen backlog for many
    concurrent clients: socketserver's default of 5 drops connections
    when a few dozen arrive at once, and each dropped one waits a second
    to retry."""
    request_queue_size = 128


class PredictionServer:
    """ThreadingHTTPServer wrapper owning one Predictor."""

    def __init__(self, predictor: Predictor, host: str = "127.0.0.1",
                 port: int = 0, coalesce: bool = True,
                 max_coalesced_graphs: Optional[int] = None):
        """`max_coalesced_graphs` bounds one merged device call (the
        dispatcher's fairness cap); None merges every queued request."""
        self.predictor = predictor
        self._lock = threading.Lock()  # stats only (dispatch is below)
        self._dispatcher = CoalescingDispatcher(
            predictor, max_batch_graphs=max_coalesced_graphs) \
            if coalesce else None
        self._requests_served = 0
        server = self

        class Handler(BaseHTTPRequestHandler):
            # Quiet by default.
            def log_message(self, fmt, *args):
                pass

            def _reply(self, code: int, payload: dict):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path != "/healthz":
                    return self._reply(404, {"error": "unknown path"})
                self._reply(200, server.health())

            def do_POST(self):
                if self.path != "/predict":
                    return self._reply(404, {"error": "unknown path"})
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    request = json.loads(self.rfile.read(length))
                    graphs = request["graphs"]
                    if not graphs:
                        raise ValueError("empty graph list")
                    outputs = server.predict(graphs)
                except Exception as exc:  # surface as a 400, keep serving
                    return self._reply(400, {"error": str(exc)})
                self._reply(200, {"outputs": outputs.tolist(),
                                  "num_graphs": outputs.shape[1]})

        self._httpd = _HTTPServer((host, port), Handler)
        self._thread: Optional[threading.Thread] = None
        self._serving = False

    def health(self) -> dict:
        """The /healthz payload."""
        p = self.predictor
        payload = {
            "status": "ok",
            "variant": p.variant,
            "tasks": p.task_ids,
            "max_nodes": p.max_nodes,
            "max_graphs": p.max_graphs,
            "requests_served": self._requests_served,
        }
        if self._dispatcher is not None:
            payload["device_calls"] = self._dispatcher.device_calls
            payload["coalesced_requests"] = \
                self._dispatcher.coalesced_requests
        return payload

    # ------------------------------------------------------------ predict

    def predict(self, graphs) -> np.ndarray:
        if self._dispatcher is not None:
            out = self._dispatcher.submit(graphs)
            with self._lock:
                self._requests_served += 1
            return out
        with self._lock:
            out = self.predictor(graphs)
            self._requests_served += 1
            return out

    def warmup(self):
        """One tiny self-loop graph through the full pack -> forward path
        before accepting traffic; the counters then start at 0."""
        annotation = self.predictor.meta.annotation_size
        # Targets are indexed by task id, so the list is sized by the
        # largest id, not the count.
        n_targets = max(self.predictor.task_ids) + 1
        g = {"targets": [[0.0] for _ in range(n_targets)],
             "graph": [[0, 1, 1]],
             "node_features": [[1.0] + [0.0] * (annotation - 1)] * 2}
        self.predict([g])
        self._requests_served = 0
        if self._dispatcher is not None:
            self._dispatcher.device_calls = 0
            self._dispatcher.coalesced_requests = 0

    # ------------------------------------------------------------- serve

    @property
    def address(self):
        host, port = self._httpd.server_address[:2]
        return host, port

    def start(self):
        """Serve in a background thread (returns immediately)."""
        self._serving = True
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    def serve_forever(self):
        self._serving = True
        self._httpd.serve_forever()

    def shutdown(self):
        # socketserver.shutdown() blocks until serve_forever acknowledges:
        # on a server that never started it would wait forever.
        if self._serving:
            self._httpd.shutdown()
            self._serving = False
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="ggnn_tpu_torch.server",
        description="Serve a ggnn_tpu checkpoint over HTTP on an NVIDIA "
                    "GPU (PyTorch port)")
    parser.add_argument("--checkpoint", required=True,
                        help="pickle checkpoint of either package, a "
                             "reference TF1 pickle, or a .ggnnx "
                             "deployment artifact of this package "
                             "(ggnn_tpu_torch.export)")
    # Defaults are applied after parsing, so that the artifact branch can
    # tell a flag that was given from a default.
    parser.add_argument("--variant", default=None,
                        help="model variant (default sparse; ignored "
                             "for .ggnnx artifacts, which bake it in)")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8099)
    parser.add_argument("--max-nodes", type=int, default=None,
                        help="serving envelope (default 2048; ignored "
                             "for .ggnnx artifacts)")
    parser.add_argument("--max-graphs", type=int, default=None,
                        help="serving envelope (default 256; ignored "
                             "for .ggnnx artifacts)")
    parser.add_argument("--annotation-size", type=int, default=None)
    parser.add_argument("--max-coalesced-graphs", type=int, default=None,
                        help="fairness cap: max graphs merged into one "
                             "coalesced device call (default unbounded)")
    parser.add_argument("--no-coalesce", action="store_true",
                        help="serialize requests one device call each")
    parser.add_argument("--device", default=None,
                        help="device to serve on (default: the GPU; "
                             "'cpu' for the CPU)")
    return parser


def load_for_serving(args) -> Predictor:
    """The Predictor that `args` (of `build_parser`) name; fills the
    envelope and variant defaults in `args`."""
    if args.checkpoint.endswith(".ggnnx"):
        from ggnn_tpu_torch.export import load_predictor
        predictor = load_predictor(args.checkpoint, device=args.device)
        ignored = [flag for flag, given in
                   (("--variant", args.variant),
                    ("--max-nodes", args.max_nodes),
                    ("--max-graphs", args.max_graphs),
                    ("--annotation-size", args.annotation_size))
                   if given is not None]
        if ignored:
            print(f"note: {', '.join(ignored)} ignored — a .ggnnx "
                  "artifact bakes in its variant and serving envelope "
                  "(re-export to change them)", flush=True)
        args.variant = predictor.variant
        args.max_nodes = predictor.max_nodes
        args.max_graphs = predictor.max_graphs
        return predictor
    args.variant = args.variant or "sparse"
    args.max_nodes = 2048 if args.max_nodes is None else args.max_nodes
    args.max_graphs = 256 if args.max_graphs is None else args.max_graphs
    return Predictor.from_checkpoint(
        args.checkpoint, args.variant, max_nodes=args.max_nodes,
        max_graphs=args.max_graphs, annotation_size=args.annotation_size,
        device=args.device)


def main(argv=None, ready=None):
    """Serve until interrupted. `ready(server)`, when given, is called
    once the server listens (after its warm-up), from the serving
    thread's caller: a script that drives the server in-process starts
    its requests there and calls `server.shutdown()` when done."""
    args = build_parser().parse_args(argv)
    predictor = load_for_serving(args)
    server = PredictionServer(predictor, host=args.host, port=args.port,
                              coalesce=not args.no_coalesce,
                              max_coalesced_graphs=args.max_coalesced_graphs)
    print(f"warming up ({args.variant} on {predictor.device}, envelope "
          f"{args.max_nodes} nodes / {args.max_graphs} graphs)...",
          flush=True)
    server.warmup()
    host, port = server.address
    print(f"serving on http://{host}:{port} "
          f"(POST /predict, GET /healthz)", flush=True)
    if ready is not None:
        threading.Thread(target=ready, args=(server,), daemon=True).start()
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()


if __name__ == "__main__":
    main()
