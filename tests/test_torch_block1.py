"""PyTorch port: the fused block1 forward (K2's plain version) against the
JAX package's ``block1_fused`` run in interpret mode, as
tests/test_block1_pallas.py runs it; the wrapper's gradient contract and
refusals; the "auto" rule."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from em_adapt_torch.config import ModelConfig  # noqa: E402
from em_adapt_torch.models.deeplab import DeepLabLargeFOV, init_params  # noqa: E402
from em_adapt_torch.ops import block1 as k2  # noqa: E402
from em_adapt_tpu.ops.block1_pallas import block1_fused as jax_block1_fused  # noqa: E402

torch.set_num_threads(2)


def _inputs(seed, h, f=16, b=2, bias=0.1):
    """NHWC x and HWIO weights (the JAX layouts), numpy f32. ``bias`` is
    the scale of N(0, 1) biases, or with ``"large"`` biases of +2..+4 that
    would leak relu(b) into the border if the halo were not masked."""
    g = np.random.default_rng(seed)
    x = g.normal(size=(b, h, h, 3)).astype(np.float32)
    w1 = (g.normal(size=(3, 3, 3, f)) * 0.2).astype(np.float32)
    w2 = (g.normal(size=(3, 3, f, f)) * 0.1).astype(np.float32)
    if bias == "large":
        b1, b2 = (g.uniform(2.0, 4.0, size=(f,)).astype(np.float32) for _ in range(2))
    else:
        b1, b2 = ((g.normal(size=(f,)) * bias).astype(np.float32) for _ in range(2))
    return x, w1, b1, w2, b2


def _port(x, w1, b1, w2, b2, dtype):
    """block1_fused of the port on NCHW/OIHW tensors, result NHWC f32."""
    t = torch.from_numpy
    out = k2.block1_fused(t(x).permute(0, 3, 1, 2).contiguous().to(dtype),
                          t(w1).permute(3, 2, 0, 1), t(b1), t(w2).permute(3, 2, 0, 1), t(b2))
    assert out.dtype == dtype
    return out.float().permute(0, 2, 3, 1).numpy()


def bf16_ulps(a, b):
    """Per-element distance in bf16 steps between two arrays of bf16 values
    (held as f32); +0 and -0 are the same step."""
    def ordered(v):
        bits = (np.asarray(v, np.float32).view(np.int32) >> 16).astype(np.int64)
        return np.where(bits < 0, -(bits & 0x7FFF), bits)

    return np.abs(ordered(a) - ordered(b))


@pytest.mark.parametrize("h", [33, 41])
@pytest.mark.parametrize("bias", [0.1, "large"])
def test_plain_matches_jax_kernel_f32(h, bias):
    """f32: rtol 1e-5 and atol 1e-5 of the output scale (the sums of 27
    and 144 products run in another order)."""
    x, w1, b1, w2, b2 = _inputs(h, h, bias=bias)
    want = np.asarray(jax_block1_fused(*map(jnp.asarray, (x, w1, b1, w2, b2)), True))
    before = k2.launches
    got = _port(x, w1, b1, w2, b2, torch.float32)
    assert k2.launches == before  # a CPU tensor runs the plain version
    assert got.shape == want.shape == (2, (h + 1) // 2, (h + 1) // 2, 16)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("h", [33, 41])
@pytest.mark.parametrize("bias", [0.1, "large"])
def test_plain_matches_jax_kernel_bf16(h, bias):
    """bf16 (x rounded to bf16, the weights rounded inside): at most one
    bf16 step apart per element (an f32 sum in another order may round to
    the neighbouring bf16 value); bit-equal in practice."""
    x, w1, b1, w2, b2 = _inputs(100 + h, h, bias=bias)
    xb = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    want = jax_block1_fused(jnp.asarray(x, jnp.bfloat16),
                            *map(jnp.asarray, (w1, b1, w2, b2)), True)
    assert want.dtype == jnp.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    got = _port(xb, w1, b1, w2, b2, torch.bfloat16)
    assert got.shape == want.shape
    assert bf16_ulps(got, want).max() <= 1


def test_fused_rejects_even_and_non_square_inputs():
    x, w1, b1, w2, b2 = _inputs(0, 13)
    t = torch.from_numpy
    ws = (t(w1).permute(3, 2, 0, 1), t(b1), t(w2).permute(3, 2, 0, 1), t(b2))
    for shape in ((1, 3, 12, 12), (1, 3, 13, 15)):
        with pytest.raises(ValueError, match="square odd"):
            k2.block1_fused(torch.zeros(shape), *ws)


def test_fused_rejects_weights_that_need_a_gradient():
    """Weights that need a gradient now run the autograd Function (K3's
    plain version on the CPU): the output carries a graph, its values are
    those of the no-gradient forward, and every weight gets a gradient; an
    x that needs one still raises (block 1 gives its input none)."""
    x, w1, b1, w2, b2 = _inputs(1, 13)
    t = torch.from_numpy
    ws = [torch.nn.Parameter(a) for a in (t(w1).permute(3, 2, 0, 1).contiguous(), t(b1),
                                          t(w2).permute(3, 2, 0, 1).contiguous(), t(b2))]
    xt = t(x).permute(0, 3, 1, 2)
    out = k2.block1_fused(xt, *ws)
    assert out.requires_grad and out.shape == (2, 16, 7, 7)
    with torch.no_grad():
        assert torch.equal(out, k2.block1_fused(xt, *ws))
    out.square().sum().backward()
    assert all(p.grad is not None and p.grad.abs().sum() > 0 for p in ws)
    with pytest.raises(RuntimeError, match="no gradient"):
        k2.block1_fused(xt.clone().requires_grad_(True), *ws)


def test_pallas_block1_refuses_training_and_even_inputs():
    """block1_impl="pallas" trains now (block 1's weights get gradients
    through the Function); even inputs still raise."""
    cfg = ModelConfig(num_classes=4, input_size=(33, 33), fc6_channels=8, width_multiplier=0.125,
                      block1_impl="pallas", compute_dtype="bfloat16")
    model = DeepLabLargeFOV(cfg).load_params(init_params(torch.Generator(), cfg))
    x = torch.zeros(1, 33, 33, 3)
    logits = model(x, train=True, generator=torch.Generator())
    assert logits.shape == (1, 5, 5, 4)
    logits.square().sum().backward()
    assert model.layers["conv1_1"].weight.grad is not None
    with torch.no_grad(), pytest.raises(ValueError, match="square odd"):
        model(torch.zeros(1, 32, 32, 3))
    with torch.no_grad():
        assert model(x).shape == (1, 5, 5, 4)


def test_auto_picks_the_kernel_where_it_applies():
    """block1_impl="auto": the fused block (K2, and K3 where a gradient
    flows) on the card in bf16 at full width on a square odd input, in
    inference and in training alike, where the H100 measured it faster;
    the conv path anywhere else. The rule reads only the device's type, so
    it is checked here without a card."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")

    def mode(h=321, device=cuda, **kw):
        cfg = ModelConfig(**{"fc6_channels": 8, "compute_dtype": "bfloat16",
                             "block1_impl": "auto", **kw})
        return DeepLabLargeFOV(cfg)._block1_mode(h, h, device)

    for grad in (False, True):  # with grad mode on, the weights need a gradient
        with torch.set_grad_enabled(grad):
            assert mode() == "pallas"
            assert mode(device=cpu) == "xla"
            assert mode(h=320) == "xla"
            assert mode(compute_dtype="float32") == "xla"
            assert mode(width_multiplier=0.5) == "xla"
            assert mode(block1_impl="xla") == "xla"


def test_the_k2_build_comparison_raises_without_a_card(capsys):
    """compare_block1_fwd_builds needs the card before it builds anything."""
    import os

    from em_adapt_torch.tools import compare_block1_fwd_builds as compare

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the tool would run for real")
    src = os.path.join(os.path.dirname(__file__), "..", "em_adapt_torch", "csrc", "block1_fwd.cu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compare.main([src])
    assert capsys.readouterr().out == ""


def test_the_k2_build_comparison_reads_sources_and_macros():
    from pathlib import Path

    from em_adapt_torch.tools.compare_block1_fwd_builds import parse_build

    assert parse_build("build/a.cu") == (Path("build/a.cu"), ())
    assert parse_build("b.cu:K2_SKIP_FETCH,K2_SKIP_CONV1") == (
        Path("b.cu"), ("K2_SKIP_FETCH", "K2_SKIP_CONV1"))


def test_k2_cases_cover_the_pipelines_edges():
    """chip_smoke.py's K2 cases (which the comparison tool runs too) keep
    the five first cases and, on a 132-SM card, hold a case where every CTA
    owns one tile of 7 x 8 pooled outputs, one with exactly 132 tiles, one
    where some CTAs own two, and ragged last tile rows and columns."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    cases = {(b, h, large) for _, b, h, large in chip_smoke.K2_CASES}
    assert {(6, 321, False), (1, 33, False), (1, 41, False), (1, 65, False),
            (2, 41, True)} <= cases
    sms = 132
    tiles = {}
    for b, h, _ in cases:
        oh = (h + 1) // 2
        tiles[(b, h)] = b * -(-oh // 7) * -(-oh // 8)
    assert tiles[(1, 33)] == 9 and tiles[(1, 161)] == sms
    assert any(sms < n < 2 * sms for n in tiles.values())
    assert tiles[(6, 321)] == 2898  # 21 or 22 tiles a CTA
    oh = (99 + 1) // 2  # B=3, 99^2: the last tile row one pooled row deep, the last column two
    assert (3, 99) in tiles and oh % 7 == 1 and oh % 8 == 2
