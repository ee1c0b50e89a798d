"""The arithmetic of the per-layer metrics, which each file of
`portbench/metrics/` applies to the cells it names. Each takes a
`Reading` (the traced window's summary, and the window's work counted
from its batches) and returns nothing where it finds nothing to read.

  * device idle: the share of the traced window in which no kernel, copy
    or memset ran on the device, from the union of their intervals (not
    a sum), in %;
  * mfu: the products' FLOPs of every step or forward the window ran,
    counted from the batches by portbench/flops.py (a training step 3x
    its forward), over the traced window's seconds times the f32 peak
    outside the tensor cores (67 TFLOP/s, TF32 off; NVIDIA's data sheet
    at the card's full 700 W), in %;
  * aggregation roofline: the least time the window's sparse
    aggregations (B1) and, in training, their transposes (B2) need for
    their bytes at the HBM's 3.35 TB/s (portbench/flops.py counts them
    from the batches: source rows, indices and offsets read once, output
    written once), over the device seconds of the kernels named in
    `AGG_KERNELS`, in %. The work counted is the same whatever kernel
    does the aggregation.
"""

from portbench.flops import F32_OPS_PER_S, HBM_BYTES_PER_S

# B1 and B2 of ggnn_tpu_torch/csrc/ell_spmm.cu, one kernel body.
AGG_KERNELS = ("segment_sum_kernel",)


def device_idle(reading):
    trace = reading.trace
    if trace is None or trace.window_s <= 0 or trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)


def mfu(reading):
    trace, window = reading.trace, reading.window
    if trace is None or trace.busy_s <= 0 or not window.flops:
        return None
    return 100.0 * window.flops / (trace.window_s * F32_OPS_PER_S)


def agg_roofline(reading):
    trace, window = reading.trace, reading.window
    if trace is None or not window.agg_bytes:
        return None
    seconds = sum(trace.kernel_seconds(k) for k in AGG_KERNELS)
    if seconds <= 0:
        return None
    return 100.0 * window.agg_bytes / HBM_BYTES_PER_S / seconds
