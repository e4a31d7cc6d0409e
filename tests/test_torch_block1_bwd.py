"""PyTorch port: block 1's backward (K3's plain version and the autograd
Function around K2 and K3) against the JAX package's ``block1_fused``
gradients, run in interpret mode as tests/test_block1_pallas.py runs
them, and against the port's own conv path."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from em_adapt_torch.ops import block1 as k23  # noqa: E402
from em_adapt_torch.ops.conv import conv2d_same  # noqa: E402
from em_adapt_torch.ops.pooling import max_pool_same  # noqa: E402
from em_adapt_tpu.ops.block1_pallas import block1_fused as jax_block1_fused  # noqa: E402

torch.set_num_threads(2)

LEAVES = ("dw1", "db1", "dw2", "db2")


def _inputs(seed, h, f=16, b=2, bias=0.1):
    """NHWC x, HWIO weights and an NHWC pooled gradient, numpy f32; with
    ``bias="large"`` biases of +2..+4 (the halo case)."""
    g = np.random.default_rng(seed)
    x = g.normal(size=(b, h, h, 3)).astype(np.float32)
    w1 = (g.normal(size=(3, 3, 3, f)) * 0.2).astype(np.float32)
    w2 = (g.normal(size=(3, 3, f, f)) * 0.1).astype(np.float32)
    if bias == "large":
        b1, b2 = (g.uniform(2.0, 4.0, size=(f,)).astype(np.float32) for _ in range(2))
    else:
        b1, b2 = ((g.normal(size=(f,)) * bias).astype(np.float32) for _ in range(2))
    oh = (h + 1) // 2
    dy = g.normal(size=(b, oh, oh, f)).astype(np.float32)
    return x, w1, b1, w2, b2, dy


def _jax_grads(x, w1, b1, w2, b2, dy, dtype=jnp.float32):
    """JAX's K3 (interpret mode): the weight cotangents for dy, as
    (dw1, db1, dw2, db2) numpy f32 in the JAX layouts."""
    _, vjp = jax.vjp(lambda *p: jax_block1_fused(jnp.asarray(x, dtype), *p, True),
                     *map(jnp.asarray, (w1, b1, w2, b2)))
    return [np.asarray(g, np.float32) for g in vjp(jnp.asarray(dy, dtype))]


def _port_grads(x, w1, b1, w2, b2, dy, dtype=torch.float32):
    """block1_bwd of the port on NCHW/OIHW tensors, back in the JAX layouts."""
    t = torch.from_numpy
    got = k23.block1_bwd(t(x).permute(0, 3, 1, 2).contiguous().to(dtype),
                         t(dy).permute(0, 3, 1, 2).contiguous().to(dtype),
                         t(w1).permute(3, 2, 0, 1), t(b1), t(w2).permute(3, 2, 0, 1), t(b2))
    assert all(g.dtype == torch.float32 for g in got)
    dw1, db1, dw2, db2 = got
    return [dw1.permute(2, 3, 1, 0).numpy(), db1.numpy(), dw2.permute(2, 3, 1, 0).numpy(),
            db2.numpy()]


def _assert_leaves_close(got, want, tol):
    for name, a, b in zip(LEAVES, got, want):
        assert a.shape == b.shape, name
        scale = max(float(np.abs(b).max()), 1e-8)
        np.testing.assert_allclose(a / scale, b / scale, rtol=tol, atol=tol, err_msg=name)


@pytest.mark.parametrize("h", [13, 41, 53])
def test_bwd_plain_matches_jax_kernel_f32(h):
    """f32, 13/41 one JAX strip, 53 three: 1e-4 of each leaf's scale, the
    bound of tests/test_block1_pallas.py::test_gradients_match_xla (the
    sums run in another order)."""
    args = _inputs(h, h)
    before = k23.bwd_launches
    _assert_leaves_close(_port_grads(*args), _jax_grads(*args), 1e-4)
    assert k23.bwd_launches == before  # a CPU tensor runs the plain version


def test_bwd_plain_matches_jax_kernel_large_bias():
    """Biases of +2..+4: the y1/y2 halo outside the image must stay zero,
    or relu(b) would leak into the border's gradients."""
    args = _inputs(7, 41, bias="large")
    _assert_leaves_close(_port_grads(*args), _jax_grads(*args), 1e-4)


def test_bwd_pool_ties_route_to_the_first_maximum():
    """The hand case of tests/test_block1_pallas.py::
    test_pool_tie_gradient_first_match: (4, 4) is the row-major first of a
    tied window and takes its gradient, (5, 5) keeps its three solo
    windows, so dw1's centre tap is 2*1 + 2*3 = 8 exactly; and integer-
    valued inputs (exact ties everywhere, a flat patch of 9-way ties)
    match JAX's kernel at 1e-5 of each leaf's scale."""
    f = 8
    w1 = np.zeros((3, 3, 3, f), np.float32)
    w1[1, 1, 0, :] = 1.0
    w2 = np.zeros((3, 3, f, f), np.float32)
    w2[1, 1] = np.eye(f)
    b = np.zeros(f, np.float32)
    x = np.zeros((1, 13, 13, 3), np.float32)
    x[0, 4, 4, 0] = x[0, 5, 5, 0] = 2.0
    ones = np.ones((1, 7, 7, f), np.float32)  # d sum(out) / d out
    dw1 = _port_grads(x, w1, b, w2, b, ones)[0]
    assert dw1[1, 1, 0, 0] == 8.0
    assert dw1[1, 1, 0, 0] == _jax_grads(x, w1, b, w2, b, ones)[0][1, 1, 0, 0]

    g = np.random.default_rng(4)
    xi = g.integers(0, 3, size=(2, 13, 13, 3)).astype(np.float32)
    xi[:, :4, :4] = 1.0
    w1r = g.integers(-2, 3, size=(3, 3, 3, f)).astype(np.float32)
    w2r = g.integers(-2, 3, size=(3, 3, f, f)).astype(np.float32)
    dy = np.full((2, 7, 7, f), 0.01, np.float32)
    args = (xi, w1r, b, w2r, b, dy)
    _assert_leaves_close(_port_grads(*args), _jax_grads(*args), 1e-5)


@pytest.mark.parametrize("h", [41, 53])
def test_bwd_plain_matches_jax_kernel_bf16(h):
    """bf16 x and dy. At 41 JAX runs one strip and rounds at the
    same points as the plain version (dz2 in bf16 per window, dz1 once
    before the dw1 product), so only f32 sums in another order part them:
    1e-5 of each leaf's scale. At 53 JAX runs three strips and rounds each
    strip's partial dz1 where strips overlap (as K3 does not: its tiles
    own their y1 positions), which moves dw1 by about 2^-9 relative at
    those rows: 2e-3 of its scale there, 1e-5 for the other leaves."""
    x, w1, b1, w2, b2, dy = _inputs(200 + h, h)
    xb, dyb = (np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)) for a in (x, dy))
    got = _port_grads(xb, w1, b1, w2, b2, dyb, torch.bfloat16)
    want = _jax_grads(xb, w1, b1, w2, b2, dyb, jnp.bfloat16)
    _assert_leaves_close(got[1:], want[1:], 1e-5)
    _assert_leaves_close(got[:1], want[:1], 2e-3 if h == 53 else 1e-5)


def _conv_path(x, w1, b1, w2, b2):
    h = torch.relu(conv2d_same(x, w1, b1))
    return max_pool_same(torch.relu(conv2d_same(h, w2, b2)), 3, 2)


def test_function_grads_equal_the_conv_path_f32():
    """The autograd Function (plain versions on the CPU) gives the weights
    the conv path's gradients at f32, within 1e-5 of each leaf's scale
    (sums in another order), returns them in the parameters' layout and
    dtype, and launches no kernel."""
    x, w1, b1, w2, b2, dy = _inputs(3, 41)
    t = torch.from_numpy
    xt = t(x).permute(0, 3, 1, 2).contiguous()
    dyt = t(dy).permute(0, 3, 1, 2).contiguous()
    grads = {}
    before = (k23.launches, k23.bwd_launches)
    for name, fn in (("fused", k23.block1_fused), ("conv", _conv_path)):
        ws = [torch.nn.Parameter(a.clone()) for a in (t(w1).permute(3, 2, 0, 1).contiguous(),
                                                      t(b1), t(w2).permute(3, 2, 0, 1).contiguous(),
                                                      t(b2))]
        out = fn(xt, *ws)
        assert out.requires_grad
        out.backward(dyt)
        grads[name] = [p.grad for p in ws]
        assert all(p.grad.shape == p.shape and p.grad.dtype == p.dtype for p in ws)
    assert (k23.launches, k23.bwd_launches) == before
    _assert_leaves_close([g.numpy() for g in grads["fused"]],
                         [g.numpy() for g in grads["conv"]], 1e-5)


def test_function_raises_where_x_needs_a_gradient():
    """Block 1 gives its input no gradient (JAX's stop_gradient contract);
    an x that needs one raises instead of getting a silent zero."""
    x, w1, b1, w2, b2, _ = _inputs(5, 13)
    t = torch.from_numpy
    xt = t(x).permute(0, 3, 1, 2).contiguous().requires_grad_(True)
    ws = (t(w1).permute(3, 2, 0, 1), t(b1), t(w2).permute(3, 2, 0, 1), t(b2))
    with pytest.raises(RuntimeError, match="no gradient"):
        k23.block1_fused(xt, *ws)
    with torch.no_grad():
        assert k23.block1_fused(xt, *ws).shape == (2, 16, 7, 7)


def test_bwd_rejects_a_dy_of_the_wrong_shape():
    x, w1, b1, w2, b2, dy = _inputs(6, 13)
    t = torch.from_numpy
    with pytest.raises(ValueError, match="dy must be"):
        k23.block1_bwd(t(x).permute(0, 3, 1, 2), t(dy)[:, :6].permute(0, 3, 1, 2),
                       t(w1).permute(3, 2, 0, 1), t(b1), t(w2).permute(3, 2, 0, 1), t(b2))
