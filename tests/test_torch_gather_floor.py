"""The gather-floor kernel's wrapper (ggnn_tpu_torch/ops/kernels/
gather_floor.py) and its probe (ggnn_tpu_torch/probes/gather_floor.py)
against the JAX probe, benchmarks/probes/gather_floor.py.

The JAX probe's Pallas kernel `_gather_kernel` runs here as the JAX
package runs its Pallas kernels on the CPU, in interpret mode: its
module constants are patched to a small shape and `pallas_call` to
`interpret=True`; nothing in `benchmarks/` is edited. On the CPU the
wrapper runs its plain PyTorch version, held to the JAX kernel with
exact equality (a gather copies bits). The CUDA kernel itself is held
against its plain version on the card by tests/test_torch_cuda.py and
chip_smoke.py.
"""

import functools
import json
import os
import subprocess
import sys

import jax.experimental.pallas as pallas
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.probes import gather_floor as jax_probe
from ggnn_tpu_torch.ops.kernels import gather_floor
from ggnn_tpu_torch.probes import gather_floor as probe

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NB, KE, NP = 4, 8, 32


@pytest.mark.parametrize("h_dim", [128, 100, 37])
@pytest.mark.parametrize("unroll", [1, 4, 8])
def test_gather_rows_equals_the_jax_probe_kernel(monkeypatch, unroll, h_dim):
    for name, value in (("NB", NB), ("KE", KE), ("H", h_dim), ("NP", NP)):
        monkeypatch.setattr(jax_probe, name, value)
    monkeypatch.setattr(pallas, "pallas_call", functools.partial(
        pallas.pallas_call, interpret=True))
    h, src = probe.make_inputs(unroll * 10 + h_dim, NB, KE, h_dim, NP)
    want = np.asarray(jax_probe.make_gather(unroll)(jnp.asarray(h),
                                                    jnp.asarray(src)))
    np.testing.assert_array_equal(want, h[src])
    got = gather_floor.gather_rows(torch.from_numpy(h),
                                   torch.from_numpy(src), unroll)
    assert got.shape == (NB, KE, h_dim) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_make_inputs_reproduces_the_jax_probes_draws():
    assert (probe.H, probe.KE, probe.NB, probe.NP) == (
        jax_probe.H, jax_probe.KE, jax_probe.NB, jax_probe.NP)
    # The draws of benchmarks/probes/gather_floor.py:main, in its order.
    rng = np.random.RandomState(0)
    want_h = rng.randn(jax_probe.NP, jax_probe.H).astype(np.float32)
    want_src = rng.randint(0, jax_probe.NP, size=(jax_probe.NB,
                                                  jax_probe.KE)).astype(
        np.int32)
    h, src = probe.make_inputs(0)
    assert h.dtype == np.float32 and src.dtype == np.int32
    assert h.tobytes() == want_h.tobytes()
    assert src.tobytes() == want_src.tobytes()


@pytest.mark.parametrize("bad", ["h_dtype", "src_dtype", "h_rank",
                                 "src_rank", "non_contiguous", "unroll",
                                 "ke_not_multiple"])
def test_gather_rows_rejects_bad_inputs(bad):
    h = torch.randn(10, 4)
    src = torch.zeros(2, 8, dtype=torch.int32)
    unroll = 4
    error = ValueError
    if bad == "h_dtype":
        h, error = h.double(), TypeError
    elif bad == "src_dtype":
        src, error = src.long(), TypeError
    elif bad == "h_rank":
        h = h.reshape(10, 2, 2)
    elif bad == "src_rank":
        src = src.reshape(-1)
    elif bad == "non_contiguous":
        h = torch.randn(4, 10).t()
    elif bad == "unroll":
        unroll = 2
    elif bad == "ke_not_multiple":
        src = torch.zeros(2, 6, dtype=torch.int32)
    with pytest.raises(error):
        gather_floor.gather_rows(h, src, unroll)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    before = gather_floor.launches
    h = torch.randn(6, 3)
    src = torch.tensor([[5, 0, 5, 2]], dtype=torch.int32)
    got = gather_floor.gather_rows(h, src, 4)
    torch.testing.assert_close(got, h[src.long()], rtol=0, atol=0)
    empty = gather_floor.gather_rows(h, torch.zeros(0, 4, dtype=torch.int32),
                                     4)
    assert empty.shape == (0, 4, 3)
    assert gather_floor.launches == before


def test_probe_run_on_the_cpu_checks_and_times_nothing():
    h, src = probe.make_inputs(3, 6, 16, 20, 40)
    records = probe.run("cpu", h, src)
    assert [r["unroll"] for r in records] == [1, 4, 8]
    rows_read = len(np.unique(src))
    for rec in records:
        assert rec["max_abs_err"] == 0.0 and rec["ms"] is None
        assert rec["rows_read"] == rows_read
        assert rec["bytes"] == 4 * (6 * 16 * 20 + 6 * 16 + rows_read * 20)


def _probe_cli(*args):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "-m", "ggnn_tpu_torch.probes.gather_floor", *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)


def test_probe_cli_without_cuda_exits_non_zero():
    proc = _probe_cli()
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert "records" not in proc.stdout


def test_probe_cli_on_the_cpu_reports_error_zero():
    proc = _probe_cli("--device", "cpu", "--nb", "8", "--ke", "16",
                      "--hidden", "37", "--np", "50")
    assert proc.returncode == 0, proc.stderr
    records = json.loads(proc.stdout.strip().splitlines()[-1])["records"]
    assert [r["unroll"] for r in records] == [1, 4, 8]
    assert all(r["max_abs_err"] == 0.0 and r["ms"] is None
               for r in records)
