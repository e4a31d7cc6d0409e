"""PyTorch port: TF-exact conv, pool and resize against the TF1 goldens
(tests/fixtures/tf_ops.npz) and against the JAX package on shared inputs."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from conftest import RESIZE_CASES  # noqa: E402
from em_adapt_torch.ops.conv import conv2d_same, same_padding  # noqa: E402
from em_adapt_torch.ops.pooling import max_pool_same  # noqa: E402
from em_adapt_torch.ops.resize import resize_bilinear_tf, resize_nearest_tf  # noqa: E402
from em_adapt_tpu.ops.conv import conv2d_same as conv2d_same_jax  # noqa: E402
from em_adapt_tpu.ops.pooling import max_pool_same as max_pool_same_jax  # noqa: E402

torch.set_num_threads(2)


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).detach().numpy()


def oihw(w: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(w)).permute(3, 2, 0, 1)


@pytest.mark.parametrize("name,size", RESIZE_CASES)
def test_resize_bilinear(tf_ops, name, size):
    got = resize_bilinear_tf(torch.from_numpy(tf_ops[f"resize_{name}_img"]), size).numpy()
    np.testing.assert_allclose(got, tf_ops[f"resize_{name}_bi"], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name,size", RESIZE_CASES)
def test_resize_nearest_bitexact(tf_ops, name, size):
    got = resize_nearest_tf(torch.from_numpy(tf_ops[f"resize_{name}_lab"]), size).numpy()
    np.testing.assert_array_equal(got, tf_ops[f"resize_{name}_nn"])


@pytest.mark.parametrize(
    "name,stride", [("s2_321", 2), ("s2_161", 2), ("s2_81", 2), ("s1_41", 1), ("s2_10", 2)]
)
def test_max_pool_same(tf_ops, name, stride):
    got = nhwc(max_pool_same(nchw(tf_ops[f"pool_{name}_x"]), 3, stride))
    np.testing.assert_array_equal(got, tf_ops[f"pool_{name}_y"])


def test_pool_chain_shapes():
    """321 -> 161 -> 81 -> 41, then 41 at stride 1 (output stride 8)."""
    x = torch.zeros(1, 1, 321, 321)
    for _ in range(3):
        x = max_pool_same(x, 3, 2)
    assert x.shape[2:] == (41, 41)
    assert max_pool_same(x, 3, 1).shape[2:] == (41, 41)


@pytest.mark.parametrize(
    "wkey,rate,want",
    [("conv_w3", 1, "conv_same"), ("conv_w3", 2, "conv_atrous2"), ("conv_w4", 4, "conv_atrous4_k4")],
    ids=["same", "atrous2", "atrous4_even_kernel"],
)
def test_conv_matches_tf(tf_ops, wkey, rate, want):
    # fc6's 4x4 kernel at rate 4 (reference deeplab.py:92) is the even case.
    got = nhwc(conv2d_same(nchw(tf_ops["conv_x"]), oihw(tf_ops[wkey]), rate=rate))
    np.testing.assert_allclose(got, tf_ops[want], atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("k,rate", [(4, 1), (2, 3), (3, 2), (1, 1)])
def test_conv_padding_matches_jax(k, rate):
    """Asymmetric SAME padding (even effective extent) goes through F.pad
    with the extra element high, as XLA's SAME does."""
    g = np.random.default_rng(k * 10 + rate)
    x = g.normal(size=(2, 11, 9, 3)).astype(np.float32)
    w = g.normal(size=(k, k, 3, 5)).astype(np.float32)
    b = g.normal(size=(5,)).astype(np.float32)
    want = np.asarray(conv2d_same_jax(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), rate=rate))
    got = nhwc(conv2d_same(nchw(x), oihw(w), torch.from_numpy(b), rate=rate))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_same_padding_extra_element_high():
    assert same_padding(3, 1) == (1, 1)
    assert same_padding(4, 4) == (6, 6)  # fc6: effective extent 13
    assert same_padding(4, 1) == (1, 2)
    assert same_padding(1, 1) == (0, 0)


@pytest.mark.parametrize("size,stride", [(9, 2), (10, 2), (8, 1), (7, 1)])
def test_pool_tie_gradient_matches_jax(size, stride):
    """Tied windows (values from a tiny integer range, and a flat zero
    region as after a ReLU): the gradient goes to the first row-major
    maximum, as XLA's SelectAndScatter routes it. Forward and gradient
    equal jax.grad of the JAX package's max_pool_same."""
    g = np.random.default_rng(size * 3 + stride)
    x = g.integers(0, 3, size=(2, size, size, 4)).astype(np.float32)
    x[:, : size // 2, : size // 2] = 0.0
    out_n = -(-size // stride)
    cot = g.normal(size=(2, out_n, out_n, 4)).astype(np.float32)

    def loss_jax(v):
        return jnp.sum(max_pool_same_jax(v, 3, stride) * cot)

    want_y = np.asarray(max_pool_same_jax(jnp.asarray(x), 3, stride))
    want_g = np.asarray(jax.grad(loss_jax)(jnp.asarray(x)))

    xt = nchw(x).clone().requires_grad_(True)
    y = max_pool_same(xt, 3, stride)
    (y * nchw(cot)).sum().backward()
    np.testing.assert_array_equal(nhwc(y), want_y)
    np.testing.assert_allclose(nhwc(xt.grad), want_g, atol=1e-6, rtol=1e-6)
