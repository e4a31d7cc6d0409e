"""PyTorch port: int8 post-training quantization
(``em_adapt_torch/eval/quantize.py``) against the JAX package's
(``em_adapt_tpu/eval/quantize.py``) on the fixture model
(``tests/fixtures/model_small.npz``), and the ports of
``tests/test_quantize.py``'s cases with their thresholds. Its two mesh
cases (``test_quantized_model_composes_with_mesh_sharded_evaluator``,
``test_quantized_predict_shards_over_data_mesh``) run as a world of two
gloo processes (``tests/test_torch_parallel.py::run_world``): the port's
data axis is one process a card."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from em_adapt_torch import config as pcfg  # noqa: E402
from em_adapt_torch.eval import quantize as pq  # noqa: E402
from em_adapt_torch.models.deeplab import DeepLabLargeFOV, layer_specs  # noqa: E402
from em_adapt_tpu.eval import quantize as jq  # noqa: E402
from tests.test_model import SMALL_CFG, small_params_from_fixture  # noqa: E402

torch.set_num_threads(2)

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
# Widths of tests/fixtures/model_small.npz: VGG x 0.125, fc6 48, 5 classes.
PORT_CFG = pcfg.ModelConfig(num_classes=5, input_size=(65, 65), fc6_channels=48,
                            width_multiplier=0.125)


@pytest.fixture(scope="module")
def fixture_model():
    """(JAX params, numpy params, the port's float model, x [2,65,65,3])."""
    z = np.load(os.path.join(FIX, "model_small.npz"))
    params = small_params_from_fixture(z)
    np_params = jax.tree.map(np.asarray, params)
    model = DeepLabLargeFOV(PORT_CFG).load_params(np_params).eval()
    return params, np_params, model, z["x"]


@pytest.fixture(scope="module")
def jax_ranges(fixture_model):
    params, _, _, x = fixture_model
    return jq.observe_activation_ranges(SMALL_CFG, params, [jnp.asarray(x)])


@pytest.fixture(scope="module")
def port_ranges(fixture_model):
    _, _, model, x = fixture_model
    return pq.observe_activation_ranges(PORT_CFG, model, [x])


@pytest.fixture(scope="module")
def jax_qparams(fixture_model, jax_ranges):
    params = fixture_model[0]
    return jax.tree.map(np.asarray, jq.quantize_params(params, jax_ranges, SMALL_CFG))


@pytest.fixture(scope="module")
def qmodel(fixture_model):
    _, _, model, x = fixture_model
    return pq.quantize_model(PORT_CFG, model, [x])


@pytest.mark.parametrize("rate,kh,cin,cout,b,h", [
    (1, 3, 3, 21, 2, 9),    # K = 27, N = 21: both padded to multiples of 8
    (12, 3, 8, 16, 1, 29),  # rate 12: most taps land in the padding
    (4, 4, 8, 24, 2, 7),    # fc6's 4x4 kernel (even: TF's SAME pads high)
    (1, 1, 16, 5, 1, 3),    # 1x1, 9 rows: padded to 17
])
def test_conv_s8_bit_equal_to_jax(rate, kh, cin, cout, b, h):
    """s8 x s8 -> s32 SAME dilated conv: bit-equal to JAX's ``_conv_s8``,
    saturated extremes included."""
    rng = np.random.default_rng(100 * rate + kh)
    x8 = rng.integers(-127, 128, size=(b, h, h + 2, cin), dtype=np.int8)
    w8 = rng.integers(-127, 128, size=(kh, kh, cin, cout), dtype=np.int8)
    x8[0, 0, 0, :] = 127
    w8[0, 0, :, 0] = -127
    want = np.asarray(jq._conv_s8(jnp.asarray(x8), jnp.asarray(w8), rate))
    got = pq.conv_s8(torch.from_numpy(x8), torch.from_numpy(w8), rate)
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_observe_activation_ranges_match_jax(port_ranges, jax_ranges):
    assert set(port_ranges) == set(jax_ranges)
    for name, v in jax_ranges.items():
        assert port_ranges[name] == pytest.approx(v, rel=1e-6), name


def test_quantize_params_match_jax(fixture_model, jax_ranges, jax_qparams):
    """On JAX's ranges: ``w8`` bit-equal, ``scale`` and ``inv_sx`` within
    rtol 1e-7, ``b`` equal."""
    _, np_params, model, _ = fixture_model
    for source in (model, np_params):
        q = pq.quantize_params(source, jax_ranges, PORT_CFG)
        for name, want in jax_qparams.items():
            np.testing.assert_array_equal(q[name]["w8"].numpy(), want["w8"])
            np.testing.assert_allclose(q[name]["scale"].numpy(), want["scale"], rtol=1e-7)
            np.testing.assert_allclose(q[name]["inv_sx"].numpy(), want["inv_sx"], rtol=1e-7)
            np.testing.assert_array_equal(q[name]["b"].numpy(), want["b"])


def _s8_inputs_jax(params_q, x):
    """The s8 input of every layer in JAX's quantized forward (the steps
    of ``QuantizedDeepLabLargeFOV.apply``)."""
    h = jq._preprocess_uint8(jnp.asarray(x)).astype(jnp.float32)
    out = {}
    for name, _, _, _, _, rate in jq.layer_specs(SMALL_CFG):
        q = params_q[name]
        x8 = jnp.clip(jnp.round(h * q["inv_sx"]), -127, 127).astype(jnp.int8)
        out[name] = np.asarray(x8)
        h = jq._conv_s8(x8, q["w8"], rate).astype(jnp.float32) * q["scale"] + q["b"]
        if name != "fc8":
            h = jax.nn.relu(h)
        if name in jq.POOLS:
            h = jq.max_pool_same(h, window=3, stride=jq.POOLS[name])
    return out


def test_quantized_logits_match_jax_on_jax_qparams(fixture_model, jax_qparams, monkeypatch):
    """The port's quantized model on JAX's qparams against
    ``QuantizedDeepLabLargeFOV.apply``: relative L2 <= 1e-4, labels >=
    99.9% identical. It prints how many s8 activations of the port's own
    forward differ from JAX's (rounding ties alone may move one)."""
    x = fixture_model[3]
    jaxq = {k: {kk: jnp.asarray(vv) for kk, vv in v.items()} for k, v in jax_qparams.items()}
    want = jq.QuantizedDeepLabLargeFOV(SMALL_CFG).apply(jaxq, jnp.asarray(x))
    # JAX's predict: the TF1 bilinear upsample of these logits, then the argmax.
    want_labels = np.asarray(jnp.argmax(jq.resize_bilinear_tf(want, x.shape[1:3]), axis=3))
    want = np.asarray(want)
    jx = _s8_inputs_jax(jaxq, x)
    qm = pq.QuantizedDeepLabLargeFOV(PORT_CFG).load_qparams(jax_qparams)
    seen = {}
    real = pq.conv_s8

    def spy(x8, w8, rate):
        seen[len(seen)] = x8.numpy().copy()
        return real(x8, w8, rate)

    monkeypatch.setattr(pq, "conv_s8", spy)
    with torch.no_grad():
        got = qm(torch.from_numpy(x)).numpy()
        got_labels = qm.predict(torch.from_numpy(x))[1].numpy()
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    agree = float((got_labels == want_labels).mean())
    differ = {name: int((seen[i] != jx[name]).sum())
              for i, (name, *_) in enumerate(layer_specs(PORT_CFG))}
    print(f"relative L2 {rel:.3e}, labels {100 * agree:.4f}% identical; s8 inputs that "
          f"differ from JAX's per layer: {differ}")
    assert rel <= 1e-4, rel
    assert agree >= 0.999, agree


def test_weight_quantization_roundtrip_bound(fixture_model, port_ranges):
    """Per-channel symmetric int8: |w - w8*s| <= s/2 elementwise, and each
    layer's largest weight quantizes to ±127."""
    _, np_params, _, _ = fixture_model
    q = pq.quantize_params(np_params, port_ranges, PORT_CFG)
    for name in ("conv1_1", "fc6", "fc8"):
        w = np.asarray(np_params[name]["w"], np.float32)
        w8 = q[name]["w8"].numpy()
        s_w = np.max(np.abs(w), axis=(0, 1, 2)) / 127.0
        assert w8.dtype == np.int8
        assert np.all(np.abs(w - w8.astype(np.float32) * s_w) <= s_w * 0.5 + 1e-12)
        assert np.abs(w8).max() == 127


def test_calibration_ranges_positive_and_complete(fixture_model, port_ranges):
    x = fixture_model[3]
    assert set(port_ranges) == {n for n, *_ in layer_specs(PORT_CFG)}
    assert all(v > 0 for v in port_ranges.values())
    assert port_ranges["conv1_1"] == pytest.approx(float(np.max(np.abs(x))))


def test_quantized_logits_close_and_labels_agree(fixture_model, qmodel):
    """<8% relative logit error and >95% pixel agreement against the f32
    model (JAX's thresholds)."""
    _, _, model, x = fixture_model
    xt = torch.from_numpy(x)
    with torch.no_grad():
        lg, qlg = model(xt), qmodel(xt)
    rel = float(torch.linalg.norm(qlg - lg) / torch.linalg.norm(lg))
    assert rel < 0.08, rel
    agree = pq.quantization_agreement(PORT_CFG, model, qmodel, [x])
    assert agree["n_pixels"] == 2 * 65 * 65
    assert agree["pixel_agreement"] > 0.95, agree


def test_quantized_model_rejects_train(fixture_model, qmodel):
    with pytest.raises(ValueError, match="serving-only"):
        qmodel(torch.from_numpy(fixture_model[3]), train=True)


def test_quantized_model_composes_with_evaluator(fixture_model, qmodel):
    """The quantized model drops into ``Evaluator``: the fixed protocol and
    the VOC protocol (with the host CRF) score it."""
    from em_adapt_torch.eval.predict import Evaluator

    x = fixture_model[3]
    cfg = pcfg.ExperimentConfig(model=PORT_CFG, eval=pcfg.EvalConfig(batch_size=2,
                                                                     crf_iterations=1))
    ev = Evaluator(cfg, qmodel)
    label = np.zeros(x.shape[:3] + (1,), np.float32)
    miou, iou = ev.evaluate_fixed([{"image": x, "label": label}])
    assert 0.0 <= miou <= 1.0 and iou.shape == (PORT_CFG.num_classes,)

    class Raw:
        """Two raw images of other sizes and their labels."""
        def __init__(self):
            g = np.random.default_rng(1)
            self.items = [(g.integers(0, 256, size=(hw[0], hw[1], 3), dtype=np.uint8),
                           g.integers(0, 5, size=hw).astype(np.uint8))
                          for hw in ((40, 50), (61, 33))]

        def __len__(self):
            return len(self.items)

        def load_raw(self, i):
            return self.items[i]

    for use_crf in (False, True):
        miou, iou = ev.evaluate_voc(Raw(), use_crf=use_crf)
        assert 0.0 <= miou <= 1.0 and iou.shape == (PORT_CFG.num_classes,)


def test_quantized_export_roundtrip(fixture_model, qmodel):
    """The int8 program: ``export_program`` over the quantized model holds
    its 16 s8 products as ``aten._int_mm`` and no ``em_adapt::block1_fwd``
    node, and the reloaded program labels exactly as the live quantized
    model (a fresh process's load: ``tests/test_torch_export.py``)."""
    import io

    from em_adapt_torch.eval.export import BLOCK1_OP, export_program, load_predict_fn

    x = torch.from_numpy(fixture_model[3])
    cfg = pcfg.ExperimentConfig(model=PORT_CFG, eval=pcfg.EvalConfig(batch_size=2))
    ep = export_program(cfg, qmodel)
    targets = [str(n.target) for n in ep.graph.nodes]
    assert BLOCK1_OP not in targets and targets.count("aten._int_mm.default") == 16
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    _, pred = load_predict_fn(buf.getvalue())(x)
    with torch.no_grad():
        _, live = qmodel.predict(x)
    np.testing.assert_array_equal(pred.numpy(), live.numpy())


def test_uint8_wire_input_matches_float(fixture_model):
    """The uint8 wire holds for the quantized model: raw RGB and its
    preprocessed float give logits within 1e-3."""
    from em_adapt_torch.data.augment import BGR_MEAN

    np_params = fixture_model[1]
    raw = np.random.default_rng(0).integers(0, 256, size=(2, 65, 65, 3), dtype=np.uint8)
    pre = raw[..., ::-1].astype(np.float32) - BGR_MEAN
    qm = pq.quantize_model(PORT_CFG, np_params, [pre])
    with torch.no_grad():
        a = qm(torch.from_numpy(raw)).numpy()
        b = qm(torch.from_numpy(np.ascontiguousarray(pre))).numpy()
    np.testing.assert_allclose(a, b, atol=1e-3)


def test_quantized_model_moves_with_its_buffers(qmodel):
    """The qparams are buffers: the state dict holds every one of them,
    and the weights are int8."""
    sd = qmodel.state_dict()
    assert sd["layers.fc6.w8"].dtype == torch.int8
    assert set(sd) == {f"layers.{n}.{k}" for n, *_ in layer_specs(PORT_CFG)
                       for k in ("w8", "scale", "inv_sx", "b")}


@pytest.fixture(scope="module")
def int8_world(tmp_path_factory, fixture_model, qmodel):
    """The int8 model over a batch of 8 (the fixture's 2 images 4 times),
    4 rows on each of 2 gloo processes, and the labels it is scored on."""
    from tests.test_torch_parallel import run_world

    x8 = np.concatenate([fixture_model[3]] * 4)
    label = np.random.default_rng(3).integers(0, 5, size=x8.shape[:3] + (1,)).astype(np.float32)
    cfg = pcfg.ExperimentConfig(model=PORT_CFG, eval=pcfg.EvalConfig(batch_size=2))
    payload = dict(cfg=cfg, qmodel=qmodel, image=x8, label=label)
    return payload, run_world("_int8_world", 2, payload, tmp_path_factory.mktemp("int8"))


def test_quantized_model_composes_with_process_sharded_evaluator(qmodel, int8_world):
    """The int8 model under the process-sharded evaluation: each rank's
    fixed-protocol matrix of its rows, summed over the world, is the one
    process's matrix of all 8 rows exactly (the counterpart of the JAX
    package's mesh-sharded Evaluator)."""
    from em_adapt_torch.eval.predict import Evaluator

    payload, ranks = int8_world
    ev = Evaluator(payload["cfg"], qmodel)
    want = ev.confusion_fixed([{"image": payload["image"][i:i + 2],
                                "label": payload["label"][i:i + 2]} for i in range(0, 8, 2)])
    assert want.sum() == 8 * 65 * 65
    for summed, _ in ranks:
        np.testing.assert_array_equal(summed, want)


def test_quantized_predict_shards_over_a_world_of_two(qmodel, int8_world):
    """int8 predict over a world of 2: each rank's rows, stacked, are one
    process's labels of the batch of 8 exactly."""
    from em_adapt_torch.eval.predict import Evaluator

    payload, ranks = int8_world
    want = Evaluator(payload["cfg"], qmodel).predict_batch(payload["image"]).numpy()
    np.testing.assert_array_equal(np.concatenate([p for _, p in ranks]), want)
