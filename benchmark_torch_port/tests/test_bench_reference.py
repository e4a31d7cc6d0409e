"""The plain references agree with em_adapt_torch at a small size on the
CPU: the network, the E-step, the training step and the CRF."""

import numpy as np
import pytest
import torch

import weights
from reference import crf as ref_crf
from reference import model as ref


@pytest.fixture
def small():
    from em_adapt_torch.config import ModelConfig
    from em_adapt_torch.models.deeplab import DeepLabLargeFOV

    cfg = ModelConfig(width_multiplier=0.125, fc6_channels=32, input_size=(33, 33))
    params = weights.make("he", 3, torch.device("cpu"), fc6_channels=32, width=0.125)
    model = DeepLabLargeFOV(cfg).load_params(weights.hwio(params))
    return cfg, params, model


def test_forward_with_masks_equals_the_port_in_float32(small):
    cfg, params, model = small
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(5)
    image = torch.randint(0, 256, (2, 33, 33, 3), generator=gen, dtype=torch.uint8)
    masks = tuple(torch.rand(2, 32, 5, 5, generator=gen) < 0.5 for _ in range(2))
    with torch.no_grad():
        ours = ref.forward(params, image, masks=masks)
        port = model(image, train=True, masks=masks)
        np.testing.assert_allclose(ours.numpy(), port.numpy(), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(ref.forward(params, image).numpy(), model(image).numpy(),
                                   rtol=1e-4, atol=1e-5)


def test_estep_labels_equal_the_ports():
    from em_adapt_torch.config import EStepConfig
    from em_adapt_torch.ops.estep import estep_labels

    rng = np.random.default_rng(0)
    scores = torch.from_numpy(rng.normal(size=(3, 9, 9, 21)).astype(np.float32))
    label = np.zeros((3, 9, 9), np.uint8)
    label[:, 2:6, 3:8] = [[[4]], [[7]], [[20]]]
    label[1, 6:, :4] = 9
    label[:, 0] = 255
    orders = torch.stack([torch.from_numpy(rng.permutation(20) + 1) for _ in range(5)])
    label = torch.from_numpy(label)
    for impl in ("jax", "auto"):
        port = estep_labels(scores, label, orders.to(torch.int32), EStepConfig(impl=impl))
        assert torch.equal(ref.estep(scores, label, orders), port)


def test_draws_replay_the_ports_step():
    """The reference's masks and class orders are the port's draws: same
    generator, same calls, same order."""
    from em_adapt_torch.models.deeplab import dropout
    from em_adapt_torch.ops.estep import make_class_orders

    g1, g2 = torch.Generator().manual_seed(9), torch.Generator().manual_seed(9)
    x = torch.ones(2, 32, 5, 5)
    port_masks = [dropout(x, 0.5, generator=g1) != 0 for _ in range(2)]
    port_orders = make_class_orders(g1, 5, 21)
    masks, orders = ref.draws(g2, 2, 32, (5, 5), 0.5, 5, 21)
    assert all(torch.equal(a, b) for a, b in zip(port_masks, masks))
    assert torch.equal(port_orders.to(torch.int64), orders.to(torch.int64))


def test_fp8_rounds_to_three_mantissa_bits():
    x = torch.tensor([1.0, 1.0625, 1.125, -448.0, 0.0])
    y = ref.fp8(x)
    assert y[0] == 1.0 and y[2] == 1.125 and y[4] == 0.0
    assert abs(float(y[1]) - 1.0625) == pytest.approx(0.0625)  # between two fp8 steps


def test_resizes_equal_the_ports():
    from em_adapt_torch.data.augment import preprocess_eval
    from em_adapt_torch.ops.resize import resize_bilinear_tf_padded

    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, size=(47, 61, 3)).astype(np.uint8)
    port, _ = preprocess_eval(img, None, input_size=(33, 33))
    np.testing.assert_array_equal(ref_crf.network_input(img, (33, 33)), port)
    logits = torch.from_numpy(rng.normal(size=(1, 5, 5, 21)).astype(np.float32))
    up = resize_bilinear_tf_padded(logits, [(47, 61)], (64, 64))[0, :47, :61]
    assert torch.equal(ref_crf.resize_bilinear(logits[0], (47, 61)), up)


def test_crf_equals_the_card_crf_on_the_cpu():
    from em_adapt_torch.eval.crf_device import crf_refine

    rng = np.random.default_rng(2)
    h, w, c = 37, 45, 5
    logits = torch.from_numpy(rng.normal(size=(h, w, c)).astype(np.float32) * 2)
    probs = torch.softmax(logits, -1)
    rgb = torch.from_numpy(rng.integers(0, 256, size=(h, w, 3)).astype(np.uint8))
    kw = dict(bi_sxy=20.0, bi_srgb=40.0, bi_compat=10.0, g_sxy=3.0, g_compat=3.0, iterations=3)
    ours = ref_crf.dense_crf(probs, rgb, **kw)
    port = crf_refine(probs[None], rgb[None], torch.ones(1, h, w), **kw)[0]
    np.testing.assert_allclose(ours.numpy(), port.numpy(), rtol=1e-4, atol=1e-5)
