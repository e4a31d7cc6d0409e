"""PyTorch port on a CUDA card: the E-step kernel K1 against its plain
version and the reference goldens, and the fused block1 forward K2
against its plain version. Every test carries the ``gpu`` marker and
skips without a card (a CUDA kernel has no CPU mode).

The file needs neither JAX nor the shared conftest, so on a machine with
a card and no JAX it runs as:

    python -m pytest tests/test_torch_gpu.py -q --noconftest
"""

import glob
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

FIXTURES = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "fixtures", "estep_*.npz")))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _golden(path):
    z = np.load(path)
    kw = dict(bg_p=float(z["bg_p"]), fg_p=float(z["fg_p"]), num_iter=int(z["num_iter"]),
              suppress_others=bool(z["suppress"]), margin_others=float(z["margin"]))
    return z["scores"], z["label"].astype(np.float32), z["orders"].astype(np.int32), z["out"], kw


def _random(g, b, c=21, hw=41, num_iter=5):
    scores = g.normal(size=(b, hw, hw, c)).astype(np.float32)
    label = g.integers(0, c + 2, size=(b, hw, hw)).astype(np.float32)
    label[label >= c] = 255.0
    orders = np.stack([g.permutation(np.arange(1, c)) for _ in range(num_iter)]).astype(np.int32)
    return scores, label, orders, None, dict(num_iter=num_iter)


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_and_goldens(cuda_device):
    """Argmax identical, scores within 2e-5 and thresholds bit-equal to the
    plain version; argmax identical to the reference goldens."""
    from em_adapt_torch.ops import estep_kernel as k1
    from em_adapt_torch.ops.estep import estep_bisect

    g = np.random.default_rng(1)
    cases = [_golden(p) for p in FIXTURES] + [_random(g, 6), _random(g, 30)]
    assert len(FIXTURES) == 5
    for scores, label, orders, expected, kw in cases:
        s, lab, o = (torch.from_numpy(a).to(cuda_device) for a in (scores, label, orders))
        before = k1.launches
        out, th = estep_bisect(s, lab, o, **kw)
        assert k1.launches == before + 1
        out_p, th_p = estep_bisect(s.cpu(), lab.cpu(), o.cpu(), **kw)
        assert torch.equal(out.argmax(3).cpu(), out_p.argmax(3))
        np.testing.assert_allclose(out.cpu().numpy(), out_p.numpy(), atol=2e-5, rtol=0)
        assert torch.equal(th.cpu().view(torch.int32), th_p.view(torch.int32))
        if expected is not None:
            np.testing.assert_array_equal(out.argmax(3).cpu().numpy(), expected.argmax(3))
            np.testing.assert_allclose(out.cpu().numpy(), expected, atol=2e-5, rtol=0)


@pytest.mark.gpu
def test_cuda_estep_labels_match_sort_reference(cuda_device):
    from em_adapt_torch.config import EStepConfig
    from em_adapt_torch.ops.estep import estep_labels

    scores, label, orders, _, _ = _random(np.random.default_rng(2), 6)
    s, lab, o = (torch.from_numpy(a) for a in (scores, label, orders))
    got = estep_labels(s.to(cuda_device), lab.to(cuda_device), o.to(cuda_device), EStepConfig())
    want = estep_labels(s, lab, o, EStepConfig(impl="jax"))
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
def test_cuda_kernel_rejects_state_larger_than_shared_memory(cuda_device):
    """65x65 score maps (513x513 input): the state does not fit one block;
    the wrapper raises and names the ROADMAP item instead of falling back."""
    from em_adapt_torch.ops.estep import estep_bisect, make_class_orders

    s = torch.zeros(1, 65, 65, 21, device=cuda_device)
    lab = torch.zeros(1, 65, 65, device=cuda_device)
    o = make_class_orders(torch.Generator(cuda_device).manual_seed(0), 5, 21)
    with pytest.raises(ValueError, match="ROADMAP"):
        estep_bisect(s, lab, o)


def _block1_case(g, b, h, large_bias, device):
    """A normalized-range bf16 input (NCHW) and He-init weights (OIHW);
    with ``large_bias`` biases of the activations' own size, which would
    leak relu(b) into the border if the kernel did not mask its halo."""
    x = torch.from_numpy((g.uniform(0, 255, size=(b, 3, h, h)) - 117).astype(np.float32))
    w1 = torch.from_numpy((g.normal(size=(64, 3, 3, 3)) * np.sqrt(2 / 27)).astype(np.float32))
    w2 = torch.from_numpy((g.normal(size=(64, 64, 3, 3)) * np.sqrt(2 / 576)).astype(np.float32))
    if large_bias:
        b1, b2 = (torch.from_numpy(g.uniform(20, 60, size=64).astype(np.float32)) for _ in "12")
    else:
        b1, b2 = (torch.from_numpy((g.normal(size=64) * 0.1).astype(np.float32)) for _ in "12")
    return [t.to(device) for t in (x.to(torch.bfloat16), w1, b1, w2, b2)]


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,large_bias", [(1, 33, False), (1, 41, False), (1, 65, False),
                                            (6, 321, False), (2, 41, True)])
def test_block1_kernel_matches_plain(cuda_device, b, h, large_bias):
    """K2 against block1_plain on the same card: within one bf16 step per
    element (an f32 sum in another order may round to the neighbouring
    bf16 value), the step taken at no less than 2^-12 of the largest
    output (see ops/block1.py::bf16_close); bit-equal almost everywhere;
    with w2 the identity at the centre tap and b2 = 0, the pool of y1
    bit-equal to that of conv1_plain. Odd edge tiles and a large positive
    bias included."""
    from em_adapt_torch.device import set_precision
    from em_adapt_torch.ops import block1 as k2
    from em_adapt_torch.ops.pooling import max_pool_same

    set_precision("bfloat16")  # the plain version's f32 convolutions stay f32
    args = _block1_case(np.random.default_rng(h + b), b, h, large_bias, cuda_device)
    before = k2.launches
    got = k2.block1_fused(*args)
    torch.cuda.synchronize()
    assert k2.launches == before + 1
    want = k2.block1_plain(*args)
    assert got.shape == want.shape == (b, 64, (h + 1) // 2, (h + 1) // 2)
    assert got.dtype == torch.bfloat16
    assert bool(k2.bf16_close(got, want).all())
    assert float((k2.bf16_steps(got, want) == 0).float().mean()) > 0.999
    x, w1, b1, w2, b2 = args
    eye = torch.zeros_like(w2)
    eye[range(64), range(64), 1, 1] = 1
    pooled_y1 = k2.block1_fused(x, w1, b1, eye, torch.zeros_like(b2))
    assert torch.equal(pooled_y1, max_pool_same(k2.conv1_plain(x, w1, b1), 3, 2))


@pytest.mark.gpu
def test_auto_block1_runs_the_kernel_at_inference(cuda_device):
    """block1_impl="auto" at full width in bf16 launches K2 once per
    forward under no_grad, and not where a weight needs a gradient."""
    from em_adapt_torch.config import ModelConfig
    from em_adapt_torch.models.deeplab import DeepLabLargeFOV, init_params
    from em_adapt_torch.ops import block1 as k2

    cfg = ModelConfig(num_classes=4, input_size=(33, 33), fc6_channels=8,
                      compute_dtype="bfloat16", init_scheme="he")
    model = DeepLabLargeFOV(cfg).load_params(init_params(torch.Generator(), cfg)).to(cuda_device)
    x = torch.zeros(1, 33, 33, 3, device=cuda_device)
    before = k2.launches
    with torch.no_grad():
        assert model(x).shape == (1, 5, 5, 4)
    assert k2.launches == before + 1
    model(x)
    assert k2.launches == before + 1


@pytest.mark.gpu
def test_pallas_block1_needs_bf16_on_the_card(cuda_device):
    from em_adapt_torch.config import ModelConfig
    from em_adapt_torch.models.deeplab import DeepLabLargeFOV, init_params

    cfg = ModelConfig(num_classes=4, input_size=(33, 33), fc6_channels=8, block1_impl="pallas")
    model = DeepLabLargeFOV(cfg).load_params(init_params(torch.Generator(), cfg)).to(cuda_device)
    with torch.no_grad(), pytest.raises(ValueError, match="bfloat16"):
        model(torch.zeros(1, 33, 33, 3, device=cuda_device))
