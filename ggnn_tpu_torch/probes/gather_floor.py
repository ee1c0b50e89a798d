"""The gather-floor probe on the card, the counterpart of
`benchmarks/probes/gather_floor.py`.

Measures what a bare row gather costs: the kernel B3
(`ops/kernels/gather_floor.py`, `csrc/gather_floor.cu`) copies NB x KE
rows of H floats out of an NP-row table by id, and nothing else, with
its row loads unrolled 1, 4 and 8 times, and its stores plain or, with
`--streaming`, evict-first (`__stcs`). For each unroll it reports the
time per call (`utils/timing.time_ms`: CUDA events around each call,
median of 50), ns per row, GB/s of the bytes the call must move, that
byte bound and the kernel's share of it, the plain version's and
`torch.index_select`'s times on the same inputs, the time of
`Tensor.zero_` on an output-sized tensor (what writing the output alone
costs on this card), the registers a thread of the kernel uses, and the kernel's max abs error against its plain
version, which must be 0 (a gather copies bits).

The inputs are the JAX probe's: `make_inputs(seed)` draws them from
`np.random.RandomState(seed)` in the same order, so both probes see the
same arrays bit for bit.

    python -m ggnn_tpu_torch.probes.gather_floor              # the card
    python -m ggnn_tpu_torch.probes.gather_floor --streaming  # __stcs
    python -m ggnn_tpu_torch.probes.gather_floor --device cpu  # plain only

The default device is the GPU; without CUDA the command exits non-zero.
On the CPU it checks the plain version and times nothing.
"""

import argparse
import json
import sys

import numpy as np
import torch

from ggnn_tpu_torch.ops.kernels import gather_floor
from ggnn_tpu_torch.utils.device import resolve_device
from ggnn_tpu_torch.utils.timing import gpu_name_and_power, time_ms

H = 128        # row width (f32)
KE = 96        # rows gathered per block
NB = 2048      # blocks per call
NP = 8192      # rows of the table (8192 * 128 * 4 = 4 MiB)

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet


def make_inputs(seed: int = 0, nb: int = NB, ke: int = KE, hidden: int = H,
                num_rows: int = NP):
    """(h [num_rows, hidden] f32, src [nb, ke] int32) as numpy arrays,
    drawn as the JAX probe draws them."""
    rng = np.random.RandomState(seed)
    h = rng.randn(num_rows, hidden).astype(np.float32)
    src = rng.randint(0, num_rows, size=(nb, ke)).astype(np.int32)
    return h, src


def bytes_moved(h: torch.Tensor, src: torch.Tensor):
    """(bytes, rows read) the call must move at least: the output written
    once, the ids read once and each table row some id names read
    once."""
    nb, ke = src.shape
    rows_read = int(torch.unique(src).numel())
    return 4 * (nb * ke * h.shape[1] + nb * ke + rows_read * h.shape[1]), \
        rows_read


def run(device=None, h=None, src=None, streaming: bool = False):
    """One record per unroll of the kernel on (h, src), `make_inputs(0)`
    where they are not given, on `device` (default: the GPU), with
    streaming stores if `streaming`. Raises if
    the kernel differs from its plain version by any bit. Times are
    taken on a CUDA device only; on the CPU they are None."""
    dev = resolve_device(device)
    if h is None or src is None:
        h, src = make_inputs(0)
    h = torch.as_tensor(h).to(dev).contiguous()
    src = torch.as_tensor(src).to(dev).contiguous()
    nb, ke = src.shape
    rows = nb * ke
    total_bytes, rows_read = bytes_moved(h, src)
    bound_ms = total_bytes / HBM_BYTES_PER_S * 1e3
    want = gather_floor.gather_rows_reference(h, src)
    timed = dev.type == "cuda"
    plain_ms = library_ms = write_ms = None
    if timed:
        idx = src.reshape(-1)          # the ids as index_select takes them
        plain_ms = time_ms(
            lambda: gather_floor.gather_rows_reference(h, src))[0]
        library_ms = time_ms(lambda: torch.index_select(h, 0, idx))[0]
        write_ms = time_ms(torch.empty_like(want).zero_)[0]
    records = []
    for unroll in gather_floor.UNROLLS:
        got = gather_floor.gather_rows(h, src, unroll, streaming)
        err = float((got - want).abs().max().item()) if rows else 0.0
        if not torch.equal(got, want):
            raise RuntimeError(f"gather_rows at unroll {unroll} differs from "
                               f"its plain version (max abs error {err})")
        rec = {"unroll": unroll, "streaming": streaming, "NB": nb, "KE": ke,
               "H": h.shape[1], "NP": h.shape[0], "rows": rows, "rows_read": rows_read,
               "bytes": total_bytes, "bound_ms": bound_ms,
               "bound_by": "bytes", "max_abs_err": err,
               "device": (torch.cuda.get_device_name(dev) if timed
                          else str(dev)),
               "ms": None, "host_ms": None, "ns_per_row": None,
               "gb_per_s": None, "bound_share": None,
               "plain_ms": plain_ms, "library_ms": library_ms,
               "write_ms": write_ms, "registers": None}
        if timed:
            ms, host_ms = time_ms(
                lambda: gather_floor.gather_rows(h, src, unroll, streaming))
            rec.update(
                ms=ms, host_ms=host_ms, ns_per_row=ms * 1e6 / rows,
                gb_per_s=total_bytes / (ms * 1e-3) / 1e9,
                bound_share=bound_ms / ms,
                registers=gather_floor.registers(
                    unroll, gather_floor.vectorized(h, got), streaming,
                    dev))
        records.append(rec)
    return records


def record_text(rec) -> str:
    stores = "streaming" if rec["streaming"] else "plain"
    head = (f"unroll {rec['unroll']}, {stores} stores [NB={rec['NB']} "
            f"KE={rec['KE']} "
            f"H={rec['H']} NP={rec['NP']}, {rec['rows_read']} rows read] ")
    tail = (f"bound {rec['bound_ms'] * 1e3:.3f} us ({rec['bytes']} bytes); "
            f"max_abs_err={rec['max_abs_err']:.3e}")
    if rec["ms"] is None:
        return f"{head}on {rec['device']}: times not measured; {tail}"
    return (f"{head}{rec['ms']:.6f} ms/call = {rec['ns_per_row']:.4f} "
            f"ns/row, {rec['gb_per_s']:.1f} GB/s, {rec['bound_share']:.1%} "
            f"of the {tail}; plain {rec['plain_ms']:.6f} ms, index_select "
            f"{rec['library_ms']:.6f} ms, zero_ of the output "
            f"{rec['write_ms']:.6f} ms; host {rec['host_ms']:.6f} ms/call;"
            f" {rec['registers']} registers")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Time a bare row gather (kernel B3) on the card at "
                    "unroll 1, 4 and 8.")
    parser.add_argument("--device", default=None,
                        help="default: the GPU; 'cpu' checks the plain "
                             "version and times nothing")
    parser.add_argument("--nb", type=int, default=NB)
    parser.add_argument("--ke", type=int, default=KE)
    parser.add_argument("--hidden", type=int, default=H)
    parser.add_argument("--np", dest="num_rows", type=int, default=NP)
    parser.add_argument("--streaming", action="store_true",
                        help="store the output with __stcs (evict-first)")
    args = parser.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except RuntimeError as err:
        print(f"gather_floor: {err}", file=sys.stderr)
        return 1
    h, src = make_inputs(0, args.nb, args.ke, args.hidden, args.num_rows)
    records = run(dev, h, src, streaming=args.streaming)
    if dev.type == "cuda":
        print(gpu_name_and_power())
    for rec in records:
        print(record_text(rec))
    print(json.dumps({"records": records}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
