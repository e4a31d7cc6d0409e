"""PyTorch port: the E-step (sort reference and the kernel K1's plain
version) against the reference goldens, the numpy oracle and the JAX
package's Pallas kernel in interpret mode. The CUDA kernel itself is
tested on a card by tests/test_torch_gpu.py."""

import functools
import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from conftest import ESTEP_FIXTURES, load_estep_fixture  # noqa: E402
from em_adapt_torch.config import EStepConfig  # noqa: E402
from em_adapt_torch.ops import estep_kernel as k1  # noqa: E402
from em_adapt_torch.ops.estep import (  # noqa: E402
    derive_tags,
    estep,
    estep_bisect,
    estep_labels,
    make_class_orders,
)
from em_adapt_tpu.ops.estep_oracle import derive_tags as derive_tags_np  # noqa: E402
from em_adapt_tpu.ops.estep_oracle import estep_oracle  # noqa: E402
from em_adapt_tpu.ops.estep_pallas import estep_pallas  # noqa: E402

torch.set_num_threads(2)

IMPLS = ["sort", "bisect"]


def _load_chip_smoke():
    path = os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


#: chip_smoke.py's K1 edge cases, which the card runs too.
SMOKE = _load_chip_smoke()


def run(impl, scores, label, orders, **kw):
    """Port E-step on numpy inputs -> (scores [B,H,W,C], thresholds|None)."""
    s, lab, o = torch.from_numpy(scores), torch.from_numpy(label), torch.from_numpy(orders)
    if impl == "sort":
        return estep(s, lab, o, **kw).numpy(), None
    out, th = estep_bisect(s, lab, o, **kw)
    return out.numpy(), th.numpy()


def partition_thresholds(scores, label, orders, *, bg_p=0.4, fg_p=0.2, num_iter=5,
                         suppress_others=True, margin_others=1e-5):
    """The bias each visit of the numpy oracle's loop adds (np.partition,
    reference estep.py:73-76), [B, num_iter*C]; 0 where the class is absent."""
    from em_adapt_tpu.ops.estep_oracle import suppress_absent

    f = scores.astype(np.float32).copy()
    b, h, w, c = f.shape
    tags = derive_tags_np(label, c)
    if suppress_others:
        f = suppress_absent(f, tags, margin_others)
    k_bg, k_fg = int(h * w * bg_p), int(h * w * fg_p)
    cols = []
    for it in range(num_iter):
        for j in np.concatenate([[0], orders[it]]):
            k = k_bg if j == 0 else k_fg
            col = np.zeros(b, np.float32)
            for i in range(b):
                if tags[i, j]:
                    col[i] = np.partition((f[i].max(2) - f[i, :, :, j]).reshape(-1), k)[k]
                    f[i, :, :, j] += col[i]
            cols.append(col)
    return np.stack(cols, 1) if cols else np.zeros((b, 0), np.float32)


def random_case(g, b, h, w, c, num_iter, extra=2):
    scores = g.normal(size=(b, h, w, c)).astype(np.float32)
    label = g.integers(0, c + extra, size=(b, h, w)).astype(np.float32)
    label[label >= c] = 255.0
    orders = [g.permutation(np.arange(1, c)) for _ in range(num_iter)]
    return scores, label, np.array(orders, np.int32).reshape(num_iter, c - 1)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("path", ESTEP_FIXTURES, ids=[os.path.basename(p) for p in ESTEP_FIXTURES])
def test_matches_reference_goldens(path, impl):
    scores, label, orders, expected, kw = load_estep_fixture(path)
    got, th = run(impl, scores, label, orders, **kw)
    np.testing.assert_array_equal(got.argmax(3), expected.argmax(3))
    np.testing.assert_allclose(got, expected, atol=2e-5, rtol=0)
    if th is not None:
        want = partition_thresholds(scores, label, orders, **kw)
        np.testing.assert_array_equal(th.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("shape", [(2, 7, 9, 4), (2, 17, 17, 8)])
def test_bisect_matches_pallas_interpret(shape):
    """Same inputs through JAX's estep_pallas (interpret mode) and the
    port's K1 plain version: argmax identical, scores equal up to the
    final shift's summation order, thresholds bit-equal to np.partition."""
    g = np.random.default_rng(sum(shape))
    scores, label, orders = random_case(g, *shape, num_iter=3)
    want = np.asarray(estep_pallas(jnp.asarray(scores), jnp.asarray(label),
                                   jnp.asarray(orders), num_iter=3, interpret=True))
    got, th = run("bisect", scores, label, orders, num_iter=3)
    np.testing.assert_array_equal(got.argmax(3), want.argmax(3))
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)
    th_want = partition_thresholds(scores, label, orders, num_iter=3)
    np.testing.assert_array_equal(th.view(np.int32), th_want.view(np.int32))


def test_threshold_bitexact_single_class():
    """One present fg class, suppression off (tests/test_estep_pallas.py:90):
    the bias added is exactly np.partition's float, and the scores match
    the Pallas kernel and the oracle."""
    g = np.random.default_rng(0)
    scores = g.normal(size=(1, 8, 8, 3)).astype(np.float32)
    label = np.full((1, 8, 8), 2.0, np.float32)
    orders = np.array([[2, 1]], np.int32)
    kw = dict(num_iter=1, suppress_others=False)
    got, th = run("bisect", scores, label, orders, **kw)
    pallas = np.asarray(estep_pallas(jnp.asarray(scores), jnp.asarray(label),
                                     jnp.asarray(orders), interpret=True, **kw))
    oracle = estep_oracle(scores, label, orders=orders, **kw)
    diff = (scores[0].max(2) - scores[0, :, :, 2]).reshape(-1)
    k = int(64 * 0.2)
    assert th[0, 1].view(np.int32) == np.partition(diff, k)[k].view(np.int32)
    assert th[0, 0] == 0.0 and th[0, 2] == 0.0  # absent classes
    for want in (pallas, oracle):
        np.testing.assert_array_equal(got.argmax(3), want.argmax(3))
        np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)


@pytest.mark.parametrize("impl", IMPLS)
def test_edge_parameter_fuzz(impl):
    """Edge-of-parameter fuzz (tests/test_estep.py:176): k = 0, k near HW,
    all-negative scores with a single-class image, suppression off, zero
    margin, huge margin and offset. Argmax pixel-identical to the oracle,
    scores to 2e-5 scaled by the score magnitude."""
    g = np.random.default_rng(0)
    cases = [
        (2, 7, 9, 5, 0.0, 0.0, True, 1e-5, 0.0),
        (2, 7, 9, 5, 0.99, 0.99, True, 1e-5, 0.0),
        (3, 11, 11, 6, 0.4, 0.2, True, 1e-5, -100.0),
        (2, 8, 8, 4, 0.4, 0.2, False, 1e-5, 0.0),
        (2, 8, 8, 4, 0.4, 0.2, True, 0.0, 0.0),
        (1, 5, 5, 3, 0.7, 0.1, True, 1.0, 50.0),
    ]
    for i, (b, h, w, c, bg, fg, sup, margin, off) in enumerate(cases):
        scores, label, orders = random_case(g, b, h, w, c, num_iter=4)
        scores += np.float32(off)
        if i == 2:
            label[0] = 0.0
        kw = dict(bg_p=bg, fg_p=fg, num_iter=4, suppress_others=sup, margin_others=margin)
        want = estep_oracle(scores, label, orders=orders, **kw)
        got, th = run(impl, scores, label, orders, **kw)
        atol = 2e-5 * max(1.0, float(np.abs(want).max()))
        np.testing.assert_array_equal(got.argmax(3), want.argmax(3), err_msg=f"case {i}")
        np.testing.assert_allclose(got, want, atol=atol, rtol=0, err_msg=f"case {i}")
        if th is not None:
            th_want = partition_thresholds(scores, label, orders, **kw)
            np.testing.assert_array_equal(th.view(np.int32), th_want.view(np.int32))


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("variant", ["num_iter0", "no_suppress", "all_void"])
def test_special_cases_match_oracle(impl, variant):
    """num_iter=0 (no visits), suppression off, and labels of 255 only (no
    tag: no bias, only the suppression clamp)."""
    g = np.random.default_rng(5)
    num_iter = 0 if variant == "num_iter0" else 2
    scores, label, orders = random_case(g, 2, 9, 9, 5, num_iter=num_iter)
    if variant == "all_void":
        label[:] = 255.0
    kw = dict(num_iter=num_iter, suppress_others=variant != "no_suppress")
    want = estep_oracle(scores, label, orders=orders, **kw)
    got, th = run(impl, scores, label, orders, **kw)
    np.testing.assert_array_equal(got.argmax(3), want.argmax(3))
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    if th is not None:
        assert th.shape == (2, num_iter * 5)
        if variant == "all_void":
            assert not th.any()


def test_tags_and_suppression_match_jax():
    from em_adapt_tpu.ops.estep import derive_tags as derive_tags_jax
    from em_adapt_tpu.ops.estep import suppress_absent as suppress_jax
    from em_adapt_torch.ops.estep import suppress_absent

    g = np.random.default_rng(3)
    label = np.full((3, 6, 6), 255.0, np.float32)
    label[0, 0, 0] = 3
    label[1] = 0
    label[2, :3] = 4
    tags = derive_tags(torch.from_numpy(label), 5).numpy()
    np.testing.assert_array_equal(tags, np.asarray(derive_tags_jax(jnp.asarray(label), 5)))
    np.testing.assert_array_equal(tags, derive_tags_np(label, 5).astype(np.float32))
    scores = g.normal(size=(3, 6, 6, 5)).astype(np.float32)
    got = suppress_absent(torch.from_numpy(scores), torch.from_numpy(tags), 1e-5).numpy()
    want = np.asarray(suppress_jax(jnp.asarray(scores), jnp.asarray(tags), 1e-5))
    np.testing.assert_array_equal(got, want)


def test_make_class_orders():
    g = torch.Generator().manual_seed(0)
    orders = make_class_orders(g, 5, 21)
    assert orders.shape == (5, 20) and orders.dtype == torch.int32
    for row in orders.tolist():
        assert sorted(row) == list(range(1, 21))
    again = make_class_orders(torch.Generator().manual_seed(0), 5, 21)
    assert torch.equal(orders, again)
    assert make_class_orders(g, 0, 21).shape == (0, 20)


def test_estep_labels_dispatch():
    """impl 'auto'/'pallas' (K1), 'jax' (sort) and 'native' (the host
    library) give the oracle's labels; the CPU run of K1 is its plain
    version (no kernel launch); method 'fixed' is EM-Fixed's argmax for
    every impl; unknown values raise."""
    from em_adapt_torch.ops.estep import estep_fixed

    g = np.random.default_rng(9)
    scores, label, orders = random_case(g, 3, 9, 9, 6, num_iter=5)
    s, lab, o = (torch.from_numpy(a) for a in (scores, label, orders))
    before = k1.launches
    impls = ("auto", "pallas", "jax", "native")
    got = {impl: estep_labels(s, lab, o, EStepConfig(impl=impl)) for impl in impls}
    assert k1.launches == before
    want = estep_oracle(scores, label, orders=orders).argmax(3)
    for impl, weak in got.items():
        np.testing.assert_array_equal(weak.numpy(), want, err_msg=impl)
    fixed = estep_fixed(s, lab).argmax(3)
    for impl in impls:
        assert torch.equal(estep_labels(s, lab, o, EStepConfig(method="fixed", impl=impl)), fixed)
    with pytest.raises(ValueError, match="estep.impl"):
        estep_labels(s, lab, o, EStepConfig(impl="cuda"))
    with pytest.raises(ValueError, match="estep.method"):
        estep_labels(s, lab, o, EStepConfig(method="adapt"))
    with pytest.raises(ValueError, match="orders"):
        estep(s, lab, o[:2])


@functools.lru_cache(maxsize=None)
def _edge_case(case, h, w):
    """One K1 edge case: its inputs, the plain version's results at
    digit_bits=1 (the bisection) and np.partition's thresholds."""
    scores, label, orders, kw = SMOKE.k1_edge_case(case, h, w)
    args, kkw = SMOKE.k1_inputs(scores, label, orders, torch.device("cpu"), **kw)
    out1, th1 = k1.estep_plain(*args, **kkw, digit_bits=1)
    want_th = partition_thresholds(scores, label, orders, **kw)
    return scores, label, orders, kw, args, kkw, out1, th1, want_th


@pytest.mark.parametrize("digit_bits", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("h,w", [(7, 7), (20, 30), (41, 41)], ids=["hw49", "hw600", "hw1681"])
@pytest.mark.parametrize("case", SMOKE.K1_EDGE_CASES)
def test_search_width_keeps_every_bit(case, h, w, digit_bits):
    """K1's plain version with a round width of ``digit_bits`` bits (the
    kernel's K1_DIGIT_BITS) gives thresholds and outputs bit-equal to the
    bisection (``digit_bits=1``) and thresholds bit-equal to np.partition,
    on the edge cases: ties at the k-th value, all-zero, subnormal and
    +inf diffs, k = 0 and k = HW-1, void rows and an untagged image. At
    HW 49 it also agrees with JAX's estep_pallas in interpret mode:
    argmax identical and scores within 2e-6 of the largest score (the
    final shift is summed in another order); in the ``inf`` case the
    shift is exactly 0 in both, so the scores are bit-equal. JAX's CPU
    backend flushes subnormals to zero, so in the ``subnormal`` case the
    argmax and scores are held to the numpy oracle instead (bit-equal)."""
    scores, label, orders, kw, args, kkw, out1, th1, want_th = _edge_case(case, h, w)
    out, th = k1.estep_plain(*args, **kkw, digit_bits=digit_bits)
    assert torch.equal(th.view(torch.int32), th1.view(torch.int32))
    assert torch.equal(out.view(torch.int32), out1.view(torch.int32))
    np.testing.assert_array_equal(th.numpy().view(np.int32), want_th.view(np.int32))
    if h * w != 49:
        return
    got = out.reshape(2, 5, h, w).permute(0, 2, 3, 1).numpy()
    want = _pallas_edge(case)
    if case == "subnormal":
        oracle = estep_oracle(scores, label, orders=orders, **kw)
        np.testing.assert_array_equal(got.view(np.int32), oracle.view(np.int32))
        np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)
        return
    np.testing.assert_array_equal(got.argmax(3), want.argmax(3))
    if case == "inf":
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    else:
        np.testing.assert_allclose(got, want, atol=2e-6 * max(1.0, float(np.abs(want).max())),
                                   rtol=0)


@functools.lru_cache(maxsize=None)
def _pallas_edge(case):
    scores, label, orders, kw = SMOKE.k1_edge_case(case, 7, 7)
    return np.asarray(estep_pallas(jnp.asarray(scores), jnp.asarray(label), jnp.asarray(orders),
                                   interpret=True, **kw))


def test_search_rounds():
    """A present visit takes ceil(31 / R) block rounds: 31 for the
    bisection, 8 for the kernel's default R = 4."""
    assert [k1.search_rounds(r) for r in (1, 2, 3, 4, 5)] == [31, 16, 11, 8, 7]
    assert k1.search_rounds(k1.DIGIT_BITS) <= 8
