"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

The cell is an entry of `workloads` in BENCHMARK.json; its configuration
is `portbench/configs/<config>.json` (whose `reference` names the plain
reference's model, `portbench/reference/<reference>.py`), its traffic
mix `portbench/traffic/<traffic>.json` (whose `entry` names the window's
driver, `portbench/drivers/<entry>.py`), its limits
`portbench/limits/<workload>.json`, each end-to-end metric
`portbench/end_to_end/<metric>.py` and each per-layer metric
`portbench/metrics/<metric>.py`. Set-up builds
the molecules and weights from the seed on the card and the port's entry
over them; the window drives it for `--seconds`; then the port's state is
freed and what the window produced is held to the plain reference.

The last line of standard output is the result as JSON: with `--trace 0`
the cell's end-to-end metrics, with `--trace 1` its per-layer metrics
from a `torch.profiler` trace of a window of at most `TRACED_SECONDS`.
The numbers compared, each beside its limit, are the result's last key
and the last lines of standard error. Without a card, with fewer cards
than the cell asks for, or where JAX or the JAX package was loaded, it
prints no result and exits non-zero.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from portbench import check, windows  # noqa: E402
from portbench.trace import Tracer  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "ggnn_tpu")
# A traced run traces at most this much of the window: a dense epoch
# replays ~30,000 kernels a second, and reading the trace of a whole 45-s
# window took ~400 s, past a run's time limit.
TRACED_SECONDS = 10.0


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


class Cell:
    """A workload of BENCHMARK.json with its configuration, traffic mix,
    limits and metrics, found by name."""

    def __init__(self, name: str, bench: dict = None):
        bench = bench or load_json(ROOT, "BENCHMARK.json")
        found = [w for w in bench["workloads"] if w["name"] == name]
        if not found:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        self.workload = found[0]
        self.name = name
        entry = [c for c in bench["configs"]
                 if c["name"] == self.workload["config"]][0]
        self.config = load_json(ROOT, entry["file"])
        if (self.config["name"], self.config["source"]) != (entry["name"],
                                                            entry["source"]):
            raise SystemExit(f"{entry['file']} is not the configuration "
                             f"{entry['name']!r} of BENCHMARK.json")
        self.traffic = load_json(HERE, "traffic",
                                 f"{self.workload['traffic']}.json")
        self.limits = load_json(HERE, "limits", f"{name}.json")
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]


def reader(metric: str):
    """The `read(reading)` of metrics/<metric>.py."""
    return windows.load("metrics", metric).read


def end_to_end(metric: str):
    """The `read(window, setup_s)` of end_to_end/<metric>.py."""
    return windows.load("end_to_end", metric).read


def driver_class(cell: Cell):
    """The `Driver` of drivers/<entry>.py, the cell's mix's `entry`."""
    return windows.load("drivers", cell.traffic["entry"]).Driver


def set_precision(config: dict) -> None:
    """The backend's TF32 switches as the configuration states them."""
    torch.backends.cuda.matmul.allow_tf32 = bool(config["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(config["tf32"])


class Reading:
    """What a per-layer metric reads: the trace summary and the window."""

    def __init__(self, trace, window):
        self.trace = trace
        self.window = window


def device_info(device, count: int, trace=None) -> dict:
    info = {"platform": "gpu" if device.type == "cuda" else device.type,
            "kind": (torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu"),
            "count": count,
            "memory_peak_bytes": (torch.cuda.max_memory_allocated(device)
                                  if device.type == "cuda" else 0)}
    if trace is not None:
        info["busy_s"] = trace.busy_s
        info["window_s"] = trace.window_s
    return info


def loaded_forbidden():
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: torch.device, count: int = 1, started: float = None):
    """The result of one run, the numbers compared with their limits its
    last key."""
    set_precision(cell.config)
    run = windows.Run(cell.config, cell.traffic, seed, device,
                      windows.log_dir())
    driver = driver_class(cell)(run)
    windows.sync(device)
    setup_s = time.perf_counter() - (STARTED if started is None else started)
    for stage, stage_s in run.stages:
        print(f"set-up {stage} {stage_s:.3f} s", file=sys.stderr)
    tracer = Tracer(trace, device)
    gc.collect()
    with tracer.window():
        window = driver.window(min(seconds, TRACED_SECONDS) if trace
                               else seconds)
    t0 = time.perf_counter()
    summary = tracer.summary()
    if trace:
        print(f"trace read {time.perf_counter() - t0:.3f} s",
              file=sys.stderr)
    info = device_info(device, count, summary)
    metrics = {}
    if trace:
        reading = Reading(summary, window)
        for m in cell.per_layer:
            value = reader(m["name"])(reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            value = end_to_end(m["name"])(window, setup_s)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    driver.release()
    numbers = driver.check()
    # JSON has no infinity: a number that is not finite prints as null.
    checks = {k: {"value": numbers[k] if math.isfinite(numbers[k]) else None,
                  "limit": cell.limits[k]} for k in cell.limits}
    result = {"correct": check.verdict(numbers, cell.limits),
              "attempted": window.attempted, "failed": window.failed,
              "metrics": metrics, "device": info}
    if trace and summary is not None:
        result["breakdown"] = {"device_ops": summary.device_ops,
                               "idle_gaps": summary.idle_gaps}
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    cell = Cell(args.workload)
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      device, count=chips)
    found = loaded_forbidden()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
