"""The GRU cell's fused gate and update math (ggnn_tpu_torch/ops/kernels/
gru.py) on the CPU: `FusedGRU`, which runs the kernels' plain versions
here, against autograd of the eager TF1 formula (`gradcheck` in float64;
f32 at the kernel tests' 1e-5 forward and 1e-4 gradient) and against the
JAX package's `gru_apply` and its gradient; the ops one by one, their
launch plan, and the counters, which stay 0 without a card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggnn_tpu.ops import cells as jax_cells
from ggnn_tpu_torch.ops import cells
from ggnn_tpu_torch.ops.kernels import gru, launch_counts

torch.set_num_threads(1)

H = 8
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
ACTS = {"tanh": torch.tanh, "relu": torch.relu}


def eager_step(x, h, w_g, b_g, w_c, b_c, act):
    """The TF1 GRU step as `GRUCell.step` ran it before the kernels, op
    by op under autograd."""
    d_in, hdim = x.shape[-1], h.shape[-1]
    xs = torch.matmul(x, torch.cat([w_g[:d_in], w_c[:d_in]], dim=1))
    gates = torch.sigmoid(xs[..., :2 * hdim] + torch.matmul(h, w_g[d_in:])
                          + b_g)
    r, u = gates.chunk(2, dim=-1)
    c = act(xs[..., 2 * hdim:] + torch.matmul(r * h, w_c[d_in:]) + b_c)
    return u * h + (1.0 - u) * c


def _inputs(rows, d_in, dtype, seed, lead=None, h_grad=True):
    gen = torch.Generator().manual_seed(seed)
    shape = (rows,) if lead is None else lead

    def rand(*s, grad=True):
        t = (0.5 * torch.randn(*s, generator=gen, dtype=torch.float64))
        return t.to(dtype).requires_grad_(grad)

    return [rand(*shape, d_in), rand(*shape, H, grad=h_grad),
            rand(d_in + H, 2 * H), rand(2 * H), rand(d_in + H, H), rand(H)]


def _grads(out, args, seed):
    """Gradients of a fixed random projection of `out` with respect to
    every input that requires one (None elsewhere)."""
    gen = torch.Generator().manual_seed(seed)
    weight = torch.randn(out.shape, generator=gen,
                         dtype=torch.float64).to(out.dtype)
    wanted = [a for a in args if a.requires_grad]
    got = iter(torch.autograd.grad((out * weight).sum(), wanted,
                                   allow_unused=True))
    return [next(got) if a.requires_grad else None for a in args]


@pytest.mark.parametrize("act", sorted(ACTS))
@pytest.mark.parametrize("mult", [1, 2, 3])
def test_fused_gru_gradcheck_float64(act, mult):
    """The hand-derived backward against finite differences, d_in = H,
    2H and 3H (the sparse model's residual layers)."""
    args = _inputs(5, mult * H, torch.float64, seed=mult)
    code = gru.ACTIVATIONS[act]
    assert torch.autograd.gradcheck(
        lambda *a: gru.FusedGRU.apply(*a, code), args)


@pytest.mark.parametrize("act", sorted(ACTS))
@pytest.mark.parametrize("mult", [1, 2, 3])
@pytest.mark.parametrize("rows", [0, 1, 37])
@pytest.mark.parametrize("h_grad", [True, False])
def test_fused_gru_matches_eager_autograd_f32(act, mult, rows, h_grad):
    args = _inputs(rows, mult * H, torch.float32, seed=rows + mult,
                   h_grad=h_grad)
    code = gru.ACTIVATIONS[act]
    got = gru.gru_step(*args, code)
    want = eager_step(*args, ACTS[act])
    torch.testing.assert_close(got, want, **FWD_TOL)
    got_grads = _grads(got, args, seed=7)
    want_grads = _grads(want, args, seed=7)
    assert (got_grads[1] is None) == (not h_grad)
    for g, w in zip(got_grads, want_grads):
        if w is None:
            assert g is None
        else:
            assert g.shape == w.shape
            torch.testing.assert_close(g, w, **GRAD_TOL)


def test_fused_gru_takes_leading_dims_and_no_grad():
    """3-D x and h go through as rows; under no_grad (a served forward,
    an exported program) the forward ops alone give the same bits."""
    args = _inputs(None, 2 * H, torch.float32, seed=3, lead=(3, 7))
    code = gru.ACTIVATIONS["tanh"]
    got = gru.gru_step(*args, code)
    assert got.shape == (3, 7, H)
    torch.testing.assert_close(got, eager_step(*args, torch.tanh), **FWD_TOL)
    with torch.no_grad():
        assert torch.equal(gru.gru_step(*args, code), got.detach())
    for g, w in zip(_grads(got, args, 1),
                    _grads(eager_step(*args, torch.tanh), args, 1)):
        torch.testing.assert_close(g, w, **GRAD_TOL)


@pytest.mark.parametrize("activation", ["tanh", "ReLU"])
@pytest.mark.parametrize("mult", [1, 3])
def test_gru_cell_gradient_matches_jax(activation, mult):
    """The cell's gradients (inputs, state, every weight) against
    `jax.grad` of the JAX package's `gru_apply`, f32 on the CPU."""
    d_in = mult * H
    rng = np.random.RandomState(mult)
    params = {"gates_kernel": rng.randn(d_in + H, 2 * H),
              "gates_bias": rng.randn(2 * H),
              "candidate_kernel": rng.randn(d_in + H, H),
              "candidate_bias": rng.randn(H)}
    params = {k: (0.5 * v).astype(np.float32) for k, v in params.items()}
    x = rng.randn(19, d_in).astype(np.float32)
    h = rng.randn(19, H).astype(np.float32)
    weight = rng.randn(19, H).astype(np.float32)
    _, jax_apply = jax_cells.make_cell("GRU", activation)

    def loss(p, xx, hh):
        return jnp.sum(jax_apply(p, xx, hh) * weight)

    want = jax.grad(loss, argnums=(0, 1, 2))(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x),
        jnp.asarray(h))
    cell = cells.make_cell("GRU", activation)(d_in, H,
                                              torch.Generator().manual_seed(0))
    cell.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    xt = torch.from_numpy(x).requires_grad_()
    ht = torch.from_numpy(h).requires_grad_()
    (cell.step(xt, ht) * torch.from_numpy(weight)).sum().backward()
    for name, param in cell.named_parameters():
        np.testing.assert_allclose(param.grad.numpy(),
                                   np.asarray(want[0][name]), **GRAD_TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want[1]),
                               **GRAD_TOL)
    np.testing.assert_allclose(ht.grad.numpy(), np.asarray(want[2]),
                               **GRAD_TOL)


def test_gru_ops_are_the_plain_versions_on_the_cpu():
    """Each op of the namespace on CPU tensors: K1 and K2 give the
    eager forward's g and h'; K3 then K4 give dxs, whose column sums the
    partials hold, and dh without its recurrent product."""
    n = 23
    gen = torch.Generator().manual_seed(4)
    xs, hg = torch.randn(n, 3 * H, generator=gen), torch.randn(
        n, 2 * H, generator=gen)
    h, hc, dn = (torch.randn(n, H, generator=gen) for _ in range(3))
    b_g, b_c = torch.randn(2 * H, generator=gen), torch.randn(
        H, generator=gen)
    ops = torch.ops.ggnn_tpu_torch
    g, rh = ops.gru_gates(xs, hg, b_g, h)
    torch.testing.assert_close(g, torch.sigmoid(xs[:, :2 * H] + hg + b_g),
                               rtol=0, atol=0)
    torch.testing.assert_close(rh, g[:, :H] * h, rtol=0, atol=0)
    c, h_new = ops.gru_update(xs, hc, b_c, g, h, gru.ACTIVATIONS["tanh"])
    u = g[:, H:]
    torch.testing.assert_close(c, torch.tanh(xs[:, 2 * H:] + hc + b_c),
                               rtol=0, atol=0)
    torch.testing.assert_close(h_new, u * h + (1 - u) * c, rtol=0, atol=0)
    dxs, dh, partials = ops.gru_update_bwd(dn, g, h, c,
                                           gru.ACTIVATIONS["tanh"])
    drh = torch.randn(n, H, generator=gen)
    ops.gru_gates_bwd(drh, h, g, dxs, dh, partials)
    r = g[:, :H]
    want = torch.cat([drh * h * r * (1 - r),
                      dn * (h - c) * u * (1 - u),
                      dn * (1 - u) * (1 - c * c)], dim=1)
    torch.testing.assert_close(dxs, want, **FWD_TOL)
    torch.testing.assert_close(dh, dn * u + drh * r, **FWD_TOL)
    torch.testing.assert_close(partials.sum(0), dxs.sum(0), **FWD_TOL)


@pytest.mark.parametrize("op,args", [
    ("gru_gates", lambda n: (torch.randn(n, 3 * H), torch.randn(n, 2 * H),
                             torch.randn(2 * H), torch.randn(n, H))),
    ("gru_update", lambda n: (torch.randn(n, 3 * H), torch.randn(n, H),
                              torch.randn(H), torch.rand(n, 2 * H),
                              torch.randn(n, H), 1)),
])
def test_gru_forward_ops_pass_opcheck(op, args):
    """The forward ops' registrations (schema, fake, CPU) as an exported
    program uses them."""
    torch.library.opcheck(getattr(torch.ops.ggnn_tpu_torch, op).default,
                          args(9))


@pytest.mark.parametrize("bad", ["dtype", "shape", "layout", "act"])
def test_gru_ops_refuse_what_the_kernels_do_not_take(bad):
    n = 6
    xs, hg, b_g, h = (torch.randn(n, 3 * H), torch.randn(n, 2 * H),
                      torch.randn(2 * H), torch.randn(n, H))
    if bad == "dtype":
        with pytest.raises(TypeError, match="dtype"):
            gru.gru_gates(xs, hg.double(), b_g, h)
    elif bad == "shape":
        with pytest.raises(ValueError, match="shape"):
            gru.gru_gates(xs[:, :2 * H], hg, b_g, h)
    elif bad == "layout":
        with pytest.raises(ValueError, match="contiguous"):
            gru.gru_gates(xs, torch.randn(2 * H, n).t(), b_g, h)
    else:
        g, _ = gru.gru_gates(xs, hg, b_g, h)
        with pytest.raises(ValueError, match="activation"):
            gru.gru_update(xs, torch.randn(n, H), torch.randn(H), g, h, 5)
        with pytest.raises(ValueError, match="tanh and relu"):
            cells.GRUCell(H, H, torch.Generator().manual_seed(0),
                          activation=torch.sigmoid)


@pytest.mark.parametrize("rows,hidden,vec,sms", [
    (100_000, 100, 4, 132), (100_000, 100, 1, 132), (7_424, 100, 4, 132),
    (1_024, 100, 4, 132), (1, 100, 4, 132), (100_000, 37, 1, 132),
    (5_000, 512, 4, 132), (33, 8, 4, 1)])
def test_launch_plan_covers_every_row_and_column(rows, hidden, vec, sms):
    plan = gru.launch_plan(rows, hidden, vec, sms)
    per_block = gru.ROW_THREADS * plan.rows_per_thread
    assert (plan.row_blocks - 1) * per_block < rows <= (
        plan.row_blocks * per_block)
    width = hidden // vec
    assert 1 <= plan.col_threads <= gru.COL_THREADS
    assert (plan.col_chunks - 1) * plan.col_threads < width <= (
        plan.col_chunks * plan.col_threads)
    assert 1 <= plan.rows_per_thread <= gru.MAX_ROWS_PER_THREAD
    # K3 and K4 share the partials' rows whatever their vector widths.
    assert plan.row_blocks == gru.launch_plan(rows, hidden, 1, sms).row_blocks
    if rows >= 100_000:
        # A full wave of 8 blocks an SM, not more than 16 rows a thread.
        assert plan.row_blocks >= gru.BLOCKS_PER_SM * sms * 0.9


def test_counters_stay_zero_on_the_cpu():
    before = launch_counts()
    args = _inputs(11, 2 * H, torch.float32, seed=5)
    cell = cells.make_cell("GRU", "tanh")(2 * H, H,
                                          torch.Generator().manual_seed(1))
    cell.step(args[0], args[1]).sum().backward()
    after = launch_counts()
    assert after["gru.launches"] == before["gru.launches"] == 0
    assert after["gru.backward_launches"] == 0
    assert gru.vector_width(100, torch.zeros(4)) == 4
    assert gru.vector_width(37, torch.zeros(4)) == 1
    assert gru.vector_width(100, torch.zeros(5)[1:]) == 1
