"""The readings a cell's limits are set from, at the cell's own size.

    python3 portbench/readings.py --workload <name> --seeds 1 2 3 ...
        [--control 3] [--seconds 2] [--out FILE]

For each seed, in one process: the run's set-up and a short window, the
port's state freed, and then

  * the program's reading: the numbers compared, the port against the
    reference, as a run computes them;
  * on the first `--control` seeds, the control's: the reference
    computed in the precision below the configuration's (TF32 products
    for float32 with TF32 off) put in the port's place, against the
    reference in the configuration's precision;
  * on the same seeds, for a training cell, the fault "half of the
    batch left out, the mean taken over the rest", planted in the
    reference put in the port's place. The fault "a step that returns its
    state unchanged" needs no run: it reads 1 by change_gap's measure.

Each seed's readings are a JSON line on standard output (and in `--out`).
The benchmark's runs never run this; a test runs it at a small size.
"""

import argparse
import contextlib
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from portbench import run as bench_run  # noqa: E402
from portbench import windows  # noqa: E402
from portbench.reference import common  # noqa: E402


@contextlib.contextmanager
def half_batch_loss():
    """The reference's loss over the first half of each batch's
    molecules only, the mean taken over them."""
    loss_of = common.loss_of

    def half(pred, targets):
        keep = max(1, pred.shape[0] // 2)
        return loss_of(pred[:keep], targets[:keep])

    common.loss_of = half
    try:
        yield
    finally:
        common.loss_of = loss_of


def readings(cell, seed: int, seconds: float, control: bool,
             device: torch.device) -> dict:
    bench_run.set_precision(cell.config)
    run = windows.Run(cell.config, cell.traffic, seed, device,
                      windows.log_dir())
    t0 = time.perf_counter()
    driver = bench_run.driver_class(cell)(run)
    windows.sync(device)
    setup_s = time.perf_counter() - t0
    driver.window(seconds)
    driver.release()
    out = {"workload": cell.name, "seed": seed, "setup_s": setup_s}
    t0 = time.perf_counter()
    want = driver.reference()
    out["reference_s"] = time.perf_counter() - t0
    out["program"] = driver.numbers(driver.outputs(), want)
    if control:
        out["control"] = driver.numbers(
            driver.control(common.control_of(cell.config)), want)
        if isinstance(driver, windows.Training):
            with half_batch_loss():
                out["half_batch"] = driver.numbers(driver.reference(), want)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--control", type=int, default=3)
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--out")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench readings: no CUDA device", file=sys.stderr)
        return 2
    cell = bench_run.Cell(args.workload)
    device = torch.device("cuda", 0)
    for i, seed in enumerate(args.seeds):
        line = json.dumps(readings(cell, seed, args.seconds,
                                   i < args.control, device))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
