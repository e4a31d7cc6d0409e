"""PyTorch port: the native E-step binding (``ops/estep_native.py``, the
port's own g++ build of ``native/estep.cpp``) against the JAX package's
binding and the numpy oracle, its error codes, and
``estep_labels(impl="native")`` against K1's plain version."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from conftest import ESTEP_FIXTURES, load_estep_fixture  # noqa: E402
from em_adapt_torch.config import EStepConfig  # noqa: E402
from em_adapt_torch.ops import estep_kernel as k1  # noqa: E402
from em_adapt_torch.ops import estep_native as native  # noqa: E402
from em_adapt_torch.ops.estep import estep_labels  # noqa: E402
from em_adapt_torch.utils import build  # noqa: E402
from em_adapt_tpu.ops import estep_native as jax_native  # noqa: E402
from em_adapt_tpu.ops.estep_oracle import estep_oracle  # noqa: E402

torch.set_num_threads(2)


def _case(seed, b, hw, c=21, num_iter=5):
    g = np.random.default_rng(seed)
    scores = (g.normal(size=(b, hw, hw, c)) * 3).astype(np.float32)
    label = g.integers(0, c + 2, size=(b, hw, hw)).astype(np.float32)
    label[label >= c] = 255.0
    label[0, : hw // 2] = 0.0  # one image with a large background region
    orders = np.stack([g.permutation(np.arange(1, c)) for _ in range(num_iter)]).astype(np.int32)
    return scores, label, orders


@pytest.mark.parametrize("hw", [41, 65])
def test_native_bit_identical_to_jax_binding_and_labels_to_oracle(hw):
    """At the 321² and 513² score maps (41² and 65²): the port's library
    gives JAX's binding's output bit for bit (one source, one compiler,
    the same code flags); against the oracle the argmax is identical and
    the scores within JAX's own bound, 3e-5 (the oracle's final shift
    takes f32 means, the library f64 sums)."""
    scores, label, orders = _case(hw, 3, hw)
    got = native.estep_native(scores, label, orders)
    want = jax_native.estep_native(scores, label.astype(np.int32), orders)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    oracle = estep_oracle(scores, label, orders=orders)
    np.testing.assert_array_equal(got.argmax(3), oracle.argmax(3))
    np.testing.assert_allclose(got, oracle, atol=3e-5, rtol=0)


@pytest.mark.parametrize("path", ESTEP_FIXTURES, ids=[os.path.basename(p) for p in ESTEP_FIXTURES])
def test_native_matches_goldens_and_jax_binding(path):
    """The reference goldens: argmax identical, scores within 2e-5 (as
    ``tests/test_estep_native.py`` holds JAX's binding), and JAX's
    binding's bits."""
    scores, label, orders, expected, kw = load_estep_fixture(path)
    got = native.estep_native(scores, label, orders, **kw)
    np.testing.assert_array_equal(got.argmax(3), expected.argmax(3))
    np.testing.assert_allclose(got, expected, atol=2e-5, rtol=0)
    want = jax_native.estep_native(scores, label.astype(np.int32), orders, **kw)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_library_is_built_under_build_not_native():
    path = build.build_host("estep")
    assert path.parent == build.BUILD_DIR and path.name.startswith("libestep-")
    assert native._load()._name == str(path)


def _error_inputs(code):
    """Arguments of a raw ``emadapt_estep`` call that return ``code``."""
    scores, label, orders = _case(0, 2, 6, c=4, num_iter=2)
    args = dict(scores=scores, out=np.empty_like(scores), labels=label.astype(np.int32),
                orders=orders, b=2, h=6, w=6, c=4, num_iter=2, suppress_others=True,
                margin_others=1e-5, bg_p=0.4, fg_p=0.2)
    if code == 1:
        args["orders"] = None
    elif code == 2:
        args["c"] = 1
    elif code == 3:
        args["orders"] = np.full_like(orders, 4)
    elif code == 4:
        args["bg_p"] = 1.0
    return args


@pytest.mark.parametrize("code", [1, 2, 3, 4, 5])
def test_error_codes_raise_with_jax_reasons(code, monkeypatch):
    """Codes 1-4 come from the library on inputs that cause them (5, an
    allocation failure, cannot be caused on purpose); each code's
    RuntimeError says what JAX's binding says for it."""
    if code != 5:
        a = _error_inputs(code)
        rc = native.call(native._load(), a["scores"], a["out"], a["labels"], a["orders"],
                         a["b"], a["h"], a["w"], a["c"], a["num_iter"], a["suppress_others"],
                         a["margin_others"], a["bg_p"], a["fg_p"])
        assert rc == code

    class Lib:
        @staticmethod
        def emadapt_estep(*args):
            return code

    monkeypatch.setattr(native, "_load", lambda: Lib)
    monkeypatch.setattr(jax_native, "_load", lambda: Lib)
    scores, label, orders = _case(1, 1, 5, c=4, num_iter=2)
    with pytest.raises(RuntimeError) as got:
        native.estep_native(scores, label, orders, num_iter=2)
    with pytest.raises(RuntimeError) as want:
        jax_native.estep_native(scores, label.astype(np.int32), orders, num_iter=2)
    assert str(got.value) == str(want.value) and native.REASONS[code] in str(got.value)


def test_real_error_raises_and_bad_orders_shape_is_refused():
    scores, label, orders = _case(2, 1, 6, c=4, num_iter=2)
    with pytest.raises(RuntimeError, match="percentile out of range"):
        native.estep_native(scores, label, orders, num_iter=2, bg_p=1.0)
    with pytest.raises(ValueError, match="orders"):
        native.estep_native(scores, label, orders[:1], num_iter=2)


@pytest.mark.parametrize("hw", [41, 65])
def test_impl_native_labels_equal_plain_k1(hw):
    """``estep_labels(impl="native")`` equals K1's plain version's labels
    (impl "auto" on the CPU) pixel for pixel, on a view of NCHW logits as
    the training step passes them; no kernel launch."""
    scores, label, orders = _case(7 * hw, 2, hw)
    nchw = torch.from_numpy(scores).permute(0, 3, 1, 2).contiguous()
    s = nchw.permute(0, 2, 3, 1)
    lab, o = torch.from_numpy(label), torch.from_numpy(orders)
    before = k1.launches
    got = estep_labels(s, lab, o, EStepConfig(impl="native"))
    want = estep_labels(s, lab, o, EStepConfig(impl="auto"))
    assert k1.launches == before
    assert got.dtype == torch.int64 and got.device == s.device
    assert torch.equal(got, want)
