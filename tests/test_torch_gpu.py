"""PyTorch port on a CUDA card: the E-step kernel K1 against its plain
version and the reference goldens. Every test carries the ``gpu`` marker
and skips without a card (a CUDA kernel has no CPU mode).

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
        pytest.skip("needs a CUDA card: the E-step kernel has no CPU mode")
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
