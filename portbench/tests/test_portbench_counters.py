"""The FLOP and byte counters against hand counts on tiny shapes, and the
trace reader's union of device intervals."""

import numpy as np
import torch

from portbench import flops, trace


def test_dense_forward_flops_hand_count():
    # B 2, V 3, T 1, H 2, 1 step: bmm 2*2*3*1*3*2 = 72, transform
    # 2*6*1*2*2 = 48, GRU 2*6*(2+2)*6 = 288, edge bias 2*6*1*2 = 24,
    # readout 2*6*6 = 72.
    assert flops.dense_forward_flops(2, 3, 1, 2, 1) == 72 + 48 + 288 + 24 + 72


SPARSE = {"layer_timesteps": [2, 1], "residual_connections": {"1": [0]},
          "graph_rnn_cell": "GRU", "use_edge_bias": False}


def test_sparse_forward_flops_hand_count():
    # H 2, T 3, 5 atoms, 4 directed edges. Messages per step: per edge
    # 2*4*2*2 = 32, cheaper than per (target, type) 2*5*3*2*2 = 120.
    # Layer 0 (d_in 2), 2 steps: 32 + GRU 2*5*4*6 = 240; layer 1 (d_in
    # 4), 1 step: 32 + 2*5*6*6 = 360; readout 2*5*6 = 60.
    assert flops.sparse_forward_flops(SPARSE, 2, 3, 5, 4) == \
        2 * (32 + 240) + 32 + 360 + 60
    assert flops.step_flops(100, True) == 300
    assert flops.step_flops(100, False) == 100


def test_sparse_forward_flops_takes_the_cheaper_message_form():
    # 40 directed edges: per edge 2*40*2*2 = 640, per (target, type) 120.
    assert flops.sparse_forward_flops(SPARSE, 2, 3, 5, 40) == \
        2 * (120 + 240) + 120 + 360 + 60


def test_sparse_forward_flops_rnn_cell_and_edge_bias_hand_count():
    model = dict(SPARSE, graph_rnn_cell="RNN", use_edge_bias=True)
    # RNN cell: layer 0 2*5*4*2 = 80, layer 1 2*5*6*2 = 120; edge bias
    # [5, 3] x [3, 2] 2*5*3*2 = 60 a step.
    assert flops.sparse_forward_flops(model, 2, 3, 5, 4) == \
        2 * (32 + 60 + 80) + 32 + 60 + 120 + 60


def test_aggregation_bytes_hand_count():
    # 3 atoms, 4 directed edges, 2 used segments, 1 call, T 2, H 5.
    got = flops.aggregation_bytes(3, 4, 2, 1, 2, 5)
    assert got["forward"] == 4 * (3 * 5 + 4 + 6 + 1 + 6 * 5)
    assert got["transpose"] == 4 * (2 * 5 + 4 + 3 + 1 + 3 * 5)


def test_molecule_stats_hand_count():
    # Molecule 0: a triangle 0-1 (type 1), 1-2 (type 1), 0-2 (type 2);
    # molecule 1: one bond 0-1 (type 4).
    edges = np.array([[0, 1, 1], [1, 1, 2], [0, 2, 2], [0, 4, 1]])
    stats = flops.molecule_stats(np.array([3, 2]), edges, np.array([3, 1]),
                                 4)
    assert stats["atoms"].tolist() == [3, 2]
    assert stats["edges"].tolist() == [6, 2]
    # (target, type) pairs: atom 0 {1, 2}, atom 1 {1}, atom 2 {1, 2};
    # molecule 1: atoms 0 and 1 {4}.
    assert stats["segments_used"].tolist() == [5, 2]


class _Event:
    def __init__(self, name, device, start, dur):
        self._n, self._d, self._s, self._u = name, device, start, dur

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._u


def test_trace_busy_is_a_union_not_a_sum():
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    events = [_Event(trace.WINDOW, cpu, 0, 1_000_000),
              _Event("host_op", cpu, 500_000, 400_000),
              _Event("k1", cuda, 100_000, 300_000),
              _Event("k2", cuda, 200_000, 300_000),    # overlaps k1
              _Event("k3", cuda, 950_000, 200_000)]    # cut at the end
    s = trace.summarize(events)
    assert s.window_s == 1e-3
    assert abs(s.busy_s - (400_000 + 50_000) * 1e-9) < 1e-15
    assert abs(s.kernel_seconds("k") - (300_000 + 300_000 + 50_000) * 1e-9) \
        < 1e-15
    gaps = dict(s.idle_gaps)
    # 0-100 us: no host op; 500-950 us: host_op at its middle.
    assert abs(gaps["host outside any operator"] - 100_000e-9) < 1e-15
    assert abs(gaps["host_op"] - 450_000e-9) < 1e-15
