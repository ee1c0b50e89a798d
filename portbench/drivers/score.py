"""Batch scoring through `Predictor.__call__`: a closed loop of `clients`
threads, each sending `request_graphs` molecules of the library at a
time, in an order drawn from the seed, at the envelope `max_nodes` /
`max_graphs`. Set-up scores one request, which captures the envelope's
forward. Every answer of the window is held to the reference's answer to
that molecule, in request order; a request that failed never answered,
which fails the check.

Mix parameters: `clients`, `request_graphs`, `max_nodes`, `max_graphs`.
"""

import sys
import threading
import time
from typing import Dict, List

import numpy as np
import torch

from portbench import check
from portbench.reference import common
from portbench.windows import Run, Window, free, span


class Driver:
    def __init__(self, run: Run):
        from portbench import program
        if not hasattr(run.reference, "pack"):
            raise ValueError(f"the reference {run.config['reference']!r} "
                             "packs no scoring batches")
        self.run = run
        t = run.traffic
        with run.stage("molecules"):
            self.library = run.corpus()
            self.library_json = self.library.as_json()
        size = self.library.num_graphs
        self.order = np.random.default_rng(
            [abs(run.seed), 1]).permutation(size)
        self.per_request = t["request_graphs"]
        with run.stage("weights and predictor"):
            self.weights = run.weights()
            self.predictor = program.predictor(
                run.config, self.weights, t["max_nodes"], t["max_graphs"],
                run.device)
        self.stats = run.stats(self.library)
        self.answers: Dict[int, np.ndarray] = {}
        self.failed = 0
        with run.stage("first request"):        # captures the envelope
            self.predictor(self.request(0))

    def ids(self, r: int) -> np.ndarray:
        size = len(self.order)
        return self.order[(r * self.per_request
                           + np.arange(self.per_request)) % size]

    def request(self, r: int) -> List[Dict]:
        return [self.library_json[i] for i in self.ids(r)]

    def window(self, seconds: float) -> Window:
        out = Window()
        lock = threading.Lock()
        state = {"next": 0, "stop": False}
        results, failures = [], []

        def client():
            while True:
                with lock:
                    if state["stop"]:
                        return
                    r = state["next"]
                    state["next"] += 1
                req = self.request(r)
                t0 = time.perf_counter()
                try:
                    with span("request"):
                        answer = self.predictor(req)
                except Exception as err:  # a failed request counts
                    failures.append((r, repr(err)))
                    continue
                finally:
                    lat = time.perf_counter() - t0
                results.append((r, lat, answer))

        threads = [threading.Thread(target=client, daemon=True)
                   for _ in range(self.run.traffic["clients"])]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        time.sleep(max(0.0, seconds - (time.perf_counter() - t0)))
        with lock:
            state["stop"] = True
        for th in threads:
            th.join()
        out.seconds = time.perf_counter() - t0
        out.attempted = state["next"]
        out.failed = self.failed = len(failures)
        for r, err in failures[:3]:
            print(f"request {r} failed: {err}", file=sys.stderr)
        out.latencies_s = [lat for _, lat, _ in results]
        out.graphs = len(results) * self.per_request
        self.answers = {r: a for r, _, a in results}
        run, budget = self.run, self.run.traffic["max_nodes"] + 1
        batches = [b for r in self.answers
                   for b in run.reference.pack(self.library.num_atoms,
                                               self.ids(r), budget)]
        work = run.reference.work(run.model, run.hidden, run.edge_types,
                                  self.stats, batches, False)
        out.flops, out.agg_bytes = work["flops"], work["agg_bytes"]
        return out

    def release(self) -> None:
        del self.predictor
        free(self.run.device)

    def reference(self, precision: str = None) -> np.ndarray:
        """The reference's answer to every molecule of the library."""
        run, ref = self.run, self.run.reference
        p = run.products(precision)
        answers = np.empty(self.library.num_graphs, np.float64)
        for ids, v in ref.pack(self.library.num_atoms,
                               np.arange(self.library.num_graphs),
                               run.model["batch_size"]):
            batch = ref.make_batch(self.library.take(ids), v, run.hidden,
                                   run.device)
            answers[ids] = common.predict(
                p, ref.forward, self.weights, run.model,
                batch).double().cpu().numpy()
        return answers

    def numbers(self, got: Dict[int, np.ndarray],
                want: np.ndarray) -> Dict[str, float]:
        """The gap of the answers to requests {r: [1, n]} from the
        answers `want` to the library's molecules, in request order."""
        if not got:
            return {"answer_gap": float("inf")}
        rs = sorted(got)
        return {"answer_gap": check.answer_gap(
            torch.from_numpy(np.concatenate([got[r][0] for r in rs])),
            torch.from_numpy(np.concatenate([want[self.ids(r)]
                                             for r in rs])))}

    def control(self, precision: str) -> Dict[int, np.ndarray]:
        """The answers the reference in `precision` would have given to
        the window's requests, shaped as the port's."""
        low = self.reference(precision)
        return {r: low[self.ids(r)][None] for r in self.answers}

    def outputs(self) -> Dict[int, np.ndarray]:
        """What the timed path produced: each answered request's answers."""
        return self.answers

    def check(self) -> Dict[str, float]:
        if self.failed:
            return {"answer_gap": float("inf")}
        return self.numbers(self.outputs(), self.reference())

