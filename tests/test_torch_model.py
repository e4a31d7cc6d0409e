"""PyTorch port: DeepLab-LargeFOV against the JAX package with shared
weights (logits and every gradient leaf), the TF1 model golden, the Caffe
init loader, and dropout's TF1 semantics."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from em_adapt_torch.config import ModelConfig  # noqa: E402
from em_adapt_torch.models.convert import from_jax_params, to_jax_params  # noqa: E402
from em_adapt_torch.models.deeplab import (  # noqa: E402
    DeepLabLargeFOV,
    dropout,
    init_params,
    layer_specs,
    load_caffe_init,
)
from em_adapt_tpu.config import ModelConfig as JaxModelConfig  # noqa: E402
from em_adapt_tpu.models import DeepLabLargeFOV as JaxDeepLab  # noqa: E402

torch.set_num_threads(2)

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
# Widths of tests/fixtures/model_small.npz: VGG x 0.125, fc6 48, 5 classes.
SMALL = dict(num_classes=5, input_size=(65, 65), fc6_channels=48, width_multiplier=0.125)
TINY = dict(num_classes=5, input_size=(33, 33), fc6_channels=32, width_multiplier=0.125)


def jax_params(kw, seed=0, scheme="he"):
    model = JaxDeepLab(JaxModelConfig(**kw, init_scheme=scheme))
    return model, jax.tree.map(np.asarray, model.init(jax.random.key(seed)))


def port_model(kw, params, **extra):
    return DeepLabLargeFOV(ModelConfig(**kw, **extra)).load_params(params)


def test_from_jax_params_round_trip():
    _, params = jax_params(TINY)
    state = from_jax_params(params)
    assert state["layers.fc6.weight"].shape == (32, 64, 4, 4)  # OIHW
    back = to_jax_params(state)
    assert set(back) == set(params)
    for name in params:
        for k in ("w", "b"):
            np.testing.assert_array_equal(back[name][k], params[name][k])
    back2 = to_jax_params(port_model(TINY, params))
    np.testing.assert_array_equal(back2["conv3_2"]["w"], params["conv3_2"]["w"])


def test_logits_match_jax_apply():
    """f32 logits with shared weights; sums run in another order, so the
    tolerance is rtol 1e-4 and atol 1e-5 of the logit scale."""
    jmodel, params = jax_params(TINY, seed=1)
    x = np.random.default_rng(1).normal(size=(2, 33, 33, 3)).astype(np.float32) * 40
    want = np.asarray(jmodel.apply(jax.tree.map(jnp.asarray, params), jnp.asarray(x)))
    with torch.no_grad():
        got = port_model(TINY, params).eval()(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 5, 5, 5)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * np.abs(want).max())


def test_logits_match_tf_reference_ops():
    """The TF1-kernel golden (tests/fixtures/model_small.npz)."""
    z = np.load(os.path.join(FIX, "model_small.npz"))
    names = [s[0] for s in layer_specs(ModelConfig(**SMALL))]
    params = {n: {"w": z[f"{n}_w"], "b": z[f"{n}_b"]} for n in names}
    with torch.no_grad():
        got = port_model(SMALL, params).eval()(torch.from_numpy(z["x"])).numpy()
    want = z["logits"]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-4 * max(np.abs(want).max(), 1.0), rtol=1e-4)


def test_gradients_match_jax_grad():
    """Every parameter's gradient against jax.grad, train=True at keep 1."""
    jmodel, params = jax_params(dict(TINY, dropout_keep_prob=1.0), seed=2)
    g = np.random.default_rng(2)
    x = g.normal(size=(2, 33, 33, 3)).astype(np.float32) * 40
    cot = g.normal(size=(2, 5, 5, 5)).astype(np.float32)

    def loss(p):
        return jnp.sum(jmodel.apply(p, jnp.asarray(x), train=True, rng=jax.random.key(0)) * cot)

    want = jax.grad(loss)(jax.tree.map(jnp.asarray, params))
    model = port_model(TINY, params, dropout_keep_prob=1.0)
    (model(torch.from_numpy(x), train=True, generator=torch.Generator())
     * torch.from_numpy(cot)).sum().backward()
    got = to_jax_params({k: p.grad for k, p in model.state_dict(keep_vars=True).items()})
    for name in params:
        for k in ("w", "b"):
            w = np.asarray(want[name][k])
            np.testing.assert_allclose(
                got[name][k], w, rtol=1e-4, atol=1e-5 * np.abs(w).max(), err_msg=f"{name}.{k}"
            )


def test_caffe_init_loading():
    """init_small.npy: every layer but fc8 copied bit-exact; fc8 is
    Xavier-uniform for w and b (reference deeplab.py:156-167)."""
    init_model = load_caffe_init(os.path.join(FIX, "init_small.npy"))
    params = init_params(torch.Generator().manual_seed(0), ModelConfig(**SMALL), init_model)
    np.testing.assert_array_equal(params["conv1_1"]["w"].numpy(), init_model["conv1_1"]["w"])
    np.testing.assert_array_equal(params["fc7"]["b"].numpy(), init_model["fc7"]["b"])
    w8 = params["fc8"]["w"].numpy()
    assert np.abs(w8 - init_model["fc8"]["w"]).max() > 1e-3
    assert np.abs(w8).max() <= np.sqrt(6.0 / (48 + 5))
    assert np.abs(params["fc8"]["b"].numpy()).max() <= np.sqrt(6.0 / 10)
    DeepLabLargeFOV(ModelConfig(**SMALL)).load_params(params)  # shapes fit
    bad = dict(init_model, conv1_1={"w": np.zeros((3, 3, 3, 9), np.float32), "b": np.zeros(9)})
    with pytest.raises(ValueError, match="conv1_1"):
        init_params(torch.Generator(), ModelConfig(**SMALL), bad)


@pytest.mark.parametrize("scheme", ["reference", "he"])
def test_random_init_matches_jax_statistics(scheme):
    cfg = dict(num_classes=4, fc6_channels=16)
    params = init_params(torch.Generator().manual_seed(0), ModelConfig(**cfg, init_scheme=scheme))
    _, jparams = jax_params(cfg, scheme=scheme)
    for name in ("conv1_1", "conv3_2", "fc8"):
        w, jw = params[name]["w"].numpy(), jparams[name]["w"]
        assert w.shape == jw.shape
        assert abs(w.std() - jw.std()) < 0.1 * jw.std(), name
        assert not params[name]["b"].any()


def test_dropout_keep_fraction_and_scaling():
    x = torch.ones(400, 500)
    y = dropout(x, 0.5, generator=torch.Generator().manual_seed(0))
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.5) < 0.01
    assert torch.all(y[kept] == 2.0)
    y7 = dropout(x, 0.7, generator=torch.Generator().manual_seed(1))
    assert abs((y7 != 0).float().mean().item() - 0.7) < 0.01
    assert torch.allclose(y7[y7 != 0], torch.tensor(1 / 0.7))
    mask = torch.rand(400, 500, generator=torch.Generator().manual_seed(2)) < 0.5
    assert torch.equal(dropout(x, 0.5, mask=mask), torch.where(mask, x / 0.5, 0.0))


def test_injected_masks_drive_the_forward():
    """Train mode: masks drawn from a generator and the same masks injected
    give the same logits; different draws differ; eval is deterministic."""
    _, params = jax_params(TINY)
    model = port_model(TINY, params, dropout_keep_prob=0.5)
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(2, 33, 33, 3)).astype(np.float32) * 40)
    with torch.no_grad():
        t1 = model(x, train=True, generator=torch.Generator().manual_seed(1))
        t2 = model(x, train=True, generator=torch.Generator().manual_seed(2))
        g = torch.Generator().manual_seed(1)
        masks = tuple(torch.rand(2, 32, 5, 5, generator=g) < 0.5 for _ in range(2))
        t3 = model(x, train=True, masks=masks)
        e1, e2 = model(x), model(x)
    assert torch.equal(t1, t3)
    assert (t1 - t2).abs().max() > 1e-3
    assert torch.equal(e1, e2)
    with pytest.raises(ValueError):
        model(x, train=True)


def test_uint8_input_normalized_like_jax():
    """The uint8 wire format is normalized in the model (BGR, Caffe mean)
    exactly as the JAX package's normalize_uint8_device."""
    from em_adapt_torch.data.augment import normalize_uint8
    from em_adapt_tpu.data.augment import normalize_uint8_device

    raw = np.random.default_rng(4).integers(0, 256, size=(2, 33, 33, 3), dtype=np.uint8)
    got = normalize_uint8(torch.from_numpy(raw)).numpy()
    np.testing.assert_array_equal(got, np.asarray(normalize_uint8_device(jnp.asarray(raw))))
    _, params = jax_params(TINY)
    model = port_model(TINY, params)
    with torch.no_grad():
        assert torch.equal(model(torch.from_numpy(raw)), model(torch.from_numpy(got)))


def test_weight_l2_and_predict_match_jax():
    jmodel, params = jax_params(TINY, seed=5)
    jp = jax.tree.map(jnp.asarray, params)
    model = port_model(TINY, params)
    np.testing.assert_allclose(model.weight_l2().item(), float(jmodel.weight_l2(jp)), rtol=1e-6)
    x = np.random.default_rng(5).normal(size=(1, 33, 33, 3)).astype(np.float32) * 40
    up_j, pred_j = jmodel.predict(jp, jnp.asarray(x))
    with torch.no_grad():
        up, pred = model.predict(torch.from_numpy(x))
    assert up.shape == (1, 33, 33, 5) and pred.shape == (1, 33, 33)
    np.testing.assert_allclose(up.numpy(), np.asarray(up_j), rtol=1e-4,
                               atol=1e-5 * np.abs(np.asarray(up_j)).max())


def test_output_stride_8_at_321():
    cfg = ModelConfig(num_classes=4, fc6_channels=8, width_multiplier=0.125)
    model = DeepLabLargeFOV(cfg).load_params(init_params(torch.Generator(), cfg))
    with torch.no_grad():
        assert model(torch.zeros(1, 321, 321, 3)).shape == (1, 41, 41, 4)
