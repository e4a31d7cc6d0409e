"""PyTorch port: the dense CRF on a device (``em_adapt_torch/eval/
crf_device.py``) and the per-image upsample inside a bucket
(``ops/resize.py::resize_bilinear_tf_padded``), run on the CPU, against
the JAX package's ``eval/crf_tpu.py`` on the CPU and the host grid path."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from em_adapt_torch.config import EvalConfig  # noqa: E402
from em_adapt_torch.data.augment import resize_bilinear_np  # noqa: E402
from em_adapt_torch.eval import crf_device  # noqa: E402
from em_adapt_torch.eval.crf import (  # noqa: E402
    _bilateral_grid_filter,
    _gaussian_filter_xy,
    dense_crf,
)
from em_adapt_torch.ops.resize import resize_bilinear_tf_padded  # noqa: E402
from em_adapt_tpu.config import EvalConfig as JaxEvalConfig  # noqa: E402
from em_adapt_tpu.eval.crf_tpu import dense_crf_tpu, make_crf_tpu  # noqa: E402
from tests.test_crf import _two_region_case  # noqa: E402

torch.set_num_threads(2)
CPU = "cpu"
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "crf_tpu_fault_inputs.npz")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_spatial_and_bilateral_filters_match_the_host_ones():
    probs, rgb = _two_region_case()
    cfg = EvalConfig()
    q, mask = _t(probs)[None], torch.ones(1, *probs.shape[:2], 1)
    sp = crf_device._spatial_filter(q, mask, crf_device._gauss_taps(cfg.crf_g_sxy, 4.0))
    np.testing.assert_allclose(sp[0].numpy(), _gaussian_filter_xy(probs, cfg.crf_g_sxy),
                               atol=1e-5)
    grid_shape, flat = crf_device._bilateral_flat_index(
        _t(rgb)[None], sxy=cfg.crf_bi_sxy, srgb=cfg.crf_bi_srgb)
    bi = crf_device._splat_blur_slice(q, mask, flat, grid_shape, crf_device._gauss_taps(1.0, 2.0))
    np.testing.assert_allclose(
        bi[0].numpy(), _bilateral_grid_filter(probs, rgb, cfg.crf_bi_sxy, cfg.crf_bi_srgb),
        atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_device_crf_on_the_cpu_matches_jax_and_the_host_grid(seed):
    """Against JAX's crf_tpu on the CPU within 1e-5, and argmax-equal to
    the host grid path within 1e-4 (tests/test_crf_tpu.py:62-69)."""
    probs, rgb = _two_region_case(seed=seed, h=30, w=40)
    got = crf_device.dense_crf_device(probs, rgb, EvalConfig(), device=CPU)
    want = np.asarray(dense_crf_tpu(probs, rgb, JaxEvalConfig()))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    host = dense_crf(probs, rgb, EvalConfig(), method="grid")
    assert (got.argmax(-1) == host.argmax(-1)).all()
    assert np.abs(got - host).max() < 1e-4
    via = dense_crf(probs, rgb, EvalConfig(), method="tpu", device=CPU)
    np.testing.assert_array_equal(via, got)


def test_entry_point_needs_a_device_or_the_card(monkeypatch):
    """Without a device it runs on the card, and raises where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    probs, rgb = _two_region_case()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        crf_device.dense_crf_device(probs, rgb)


def test_bucket_padding_is_invisible_under_mask():
    probs, rgb = _two_region_case(seed=3)
    h, w, c = probs.shape
    base = crf_device.dense_crf_device(probs, rgb, num_iterations=3, device=CPU)
    ph, pw = h + 9, w + 130  # the padding adds a spatial cell of the grid
    probs_p = np.zeros((ph, pw, c), np.float32)
    probs_p[:h, :w] = probs
    rgb_p = np.full((ph, pw, 3), 255, np.uint8)
    rgb_p[:h, :w] = rgb
    mask = np.zeros((ph, pw), np.float32)
    mask[:h, :w] = 1
    padded = crf_device.dense_crf_device(probs_p, rgb_p, num_iterations=3, mask=mask, device=CPU)
    np.testing.assert_allclose(padded[:h, :w], base, rtol=0, atol=1e-5)


def test_batched_equals_per_image_and_a_rerun_is_bit_equal():
    """One grid with a batch axis gives each image what it gets alone, and
    the splat sums each cell in pixel order, so a rerun is bit-equal."""
    cases = [_two_region_case(seed=s, h=20, w=28) for s in range(3)]
    probs = np.stack([p for p, _ in cases])
    rgbs = np.stack([r for _, r in cases])
    masks = np.ones(probs.shape[:3], np.float32)
    fn = crf_device.make_crf_device(EvalConfig(), num_iterations=4, device=CPU)
    batched = fn(probs, rgbs, masks).numpy()
    assert torch.equal(fn(probs, rgbs, masks), torch.from_numpy(batched))
    for i, (p, r) in enumerate(cases):
        single = crf_device.dense_crf_device(p, r, num_iterations=4, device=CPU)
        np.testing.assert_allclose(batched[i], single, rtol=0, atol=1e-6)


def test_grid_geometry_matches_jax_and_refuses_int32_overflow():
    from em_adapt_tpu.eval.crf_tpu import _grid_geometry as jax_geometry

    for h, w in ((500, 375), (384, 512), (512, 512), (1, 1)):
        gy, gx, gc, flat = crf_device._grid_geometry(h, w, 121.0, 5.0)
        jgy, jgx, jgc, jflat = jax_geometry(h, w, 121.0, 5.0)
        assert (gy, gx, gc) == (jgy, jgx, jgc)
        np.testing.assert_array_equal(flat, jflat)
    assert crf_device.grid_cells(512, 512) == 5 * 5 * 52 ** 3 == 3_515_200
    assert crf_device.grid_cells(384, 512) == 4 * 5 * 52 ** 3 == 2_812_160
    with pytest.raises(ValueError, match="exceeds int32"):
        crf_device._grid_geometry(4000, 4000, 3.0, 1.0)


SIZES = [(37, 41), (20, 33), (9, 11), (36, 13), (1, 1)]


def test_padded_upsample_matches_jax_dynamic_and_the_host_resize():
    """At the sizes of tests/test_crf_tpu.py:104-126, one batch in one
    bucket: equal to resize_bilinear_np to the bit, and to JAX's
    resize_bilinear_tf_dynamic within its 1e-5."""
    from em_adapt_tpu.ops.resize import resize_bilinear_tf_dynamic

    x = np.random.default_rng(3).normal(size=(len(SIZES), 9, 11, 4)).astype(np.float32)
    bucket = (37, 41)
    got = resize_bilinear_tf_padded(_t(x), SIZES, bucket)
    assert got.shape == (len(SIZES), *bucket, 4) and got.dtype == torch.float32
    for i, (oh, ow) in enumerate(SIZES):
        mine = got[i, :oh, :ow].numpy()
        np.testing.assert_array_equal(mine, resize_bilinear_np(x[i], (oh, ow)))
        dyn = np.asarray(resize_bilinear_tf_dynamic(
            jnp.asarray(x[i]), jnp.asarray([oh, ow], np.int32), bucket))[:oh, :ow]
        np.testing.assert_allclose(mine, dyn, atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="exceeds the bucket"):
        resize_bilinear_tf_padded(_t(x[:1]), [(38, 5)], bucket)


def test_committed_fault_fixture_refines_to_valid_probabilities():
    """tests/fixtures/crf_tpu_fault_inputs.npz (the batch that faulted the
    TPU runtime under vmap): 2 of its 6 images, 2 iterations, batched on
    the CPU, valid probabilities within 1e-5 of JAX's make_crf_tpu."""
    d = np.load(FIXTURE)
    probs, rgb = d["probs"][:2], d["rgb"][:2]
    assert probs.shape[1:] == (129, 129, 4) and rgb.dtype == np.uint8
    mask = np.ones(probs.shape[:3], np.float32)
    out = crf_device.make_crf_device(EvalConfig(), num_iterations=2, device=CPU)(
        probs, rgb, mask).numpy()
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out.sum(-1), 1.0, atol=1e-4)
    want = np.asarray(make_crf_tpu(JaxEvalConfig(), num_iterations=2)(
        jnp.asarray(probs), jnp.asarray(rgb), jnp.asarray(mask)))
    np.testing.assert_allclose(out, want, rtol=0, atol=1e-5)


def test_filter_on_the_cpu_takes_the_plain_path_and_launches_nothing():
    """On a CPU tensor ``_filter1d`` is ``_filter1d_plain`` (into a given
    buffer too) and K4's launch count stays 0, through a whole refine."""
    g = np.random.default_rng(5)
    x = _t(g.normal(size=(2, 4, 5, 3, 22)).astype(np.float32))
    taps = crf_device._gauss_taps(1.0, 2.0)
    before = crf_device.launches
    for axis in range(1, 5):
        want = crf_device._filter1d_plain(x, taps, axis)
        assert torch.equal(crf_device._filter1d(x, taps, axis), want)
        spare = torch.full_like(x, float("nan"))
        assert crf_device._filter1d(x, taps, axis, out=spare) is spare
        assert torch.equal(spare, want)
    probs, rgb = _two_region_case(seed=4, h=12, w=16)
    crf_device.dense_crf_device(probs, rgb, num_iterations=2, device=CPU)
    assert crf_device.launches == before


def test_filter_kernel_refuses_a_cpu_tensor():
    """K4's wrapper takes CUDA tensors only: no fallback to the plain path."""
    x = torch.zeros(2, 3, 4)
    with pytest.raises(ValueError, match="unsupported device"):
        crf_device.filter1d_kernel(x, crf_device._gauss_taps(1.0, 2.0), 1)
