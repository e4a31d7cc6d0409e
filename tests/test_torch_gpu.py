"""PyTorch port on a CUDA card: the E-step kernel K1 against its plain
version and the reference goldens, the fused block1 forward K2 and
backward K3 against their plain versions, and a bf16 training step
through them. Every test carries the ``gpu`` marker and skips without a
card (a CUDA kernel has no CPU mode).

The file needs neither JAX nor the shared conftest, so on a machine with
a card and no JAX it runs as:

    python -m pytest tests/test_torch_gpu.py -q --noconftest
"""

import glob
import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

FIXTURES = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "fixtures", "estep_*.npz")))


def _load_chip_smoke():
    path = os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


#: chip_smoke.py, for K1's edge cases and the np.partition thresholds.
SMOKE = _load_chip_smoke()


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


@pytest.mark.gpu
@pytest.mark.parametrize("case", SMOKE.K1_EDGE_CASES)
def test_cuda_kernel_edge_cases_match_plain(cuda_device, case):
    """K1 on chip_smoke.py's edge cases at HW 49, 512, 600, 1024 and 1681
    (one, two and four pixels a thread): thresholds bit-equal to the
    plain version and to np.partition, argmax identical, scores within
    2e-5 (the final shift's sums run in another order)."""
    from em_adapt_torch.ops import estep_kernel as k1

    for h, w in SMOKE.K1_EDGE_SIZES:
        scores, label, orders, kw = SMOKE.k1_edge_case(case, h, w)
        args, kkw = SMOKE.k1_inputs(scores, label, orders, cuda_device, **kw)
        out, th = k1.estep_kernel(*args, **kkw)
        out_p, th_p = k1.estep_plain(*(a.cpu() for a in args), **kkw)
        torch.cuda.synchronize()
        assert torch.equal(th.cpu().view(torch.int32), th_p.view(torch.int32)), (h, w)
        want = SMOKE.partition_thresholds(scores, label, orders, **kw)
        np.testing.assert_array_equal(th.cpu().numpy().view(np.int32), want.view(np.int32))
        assert torch.equal(out.argmax(1).cpu(), out_p.argmax(1)), (h, w)
        np.testing.assert_allclose(out.cpu().numpy(), out_p.numpy(), atol=2e-5, rtol=0)


@pytest.mark.gpu
def test_cuda_kernel_is_reproducible(cuda_device):
    """Two K1 runs on the same inputs give the same bits."""
    from em_adapt_torch.ops import estep_kernel as k1

    inputs = [(*SMOKE.realistic_batch(np.random.default_rng(6), 6), SMOKE.K1_RECIPE),
              SMOKE.k1_edge_case("ties", 41, 41)]
    for scores, label, orders, recipe in inputs:
        args, kw = SMOKE.k1_inputs(scores, label, orders, cuda_device, **recipe)
        first, again = k1.estep_kernel(*args, **kw), k1.estep_kernel(*args, **kw)
        for a, b in zip(first, again):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.gpu
def test_cuda_kernel_builds_without_spills(cuda_device):
    """K1's three instances (1, 2 and 4 pixels a thread) spill no register
    within 128 (512 threads a block), and the build fixes the plain
    version's DIGIT_BITS a round: at most 8 rounds a present visit."""
    from em_adapt_torch.ops import estep_kernel as k1
    from em_adapt_torch.tools.bench_block1_bwd_parts import ptxas_report
    from em_adapt_torch.utils import build

    build.build("estep")
    for ppt in (1, 2, 4):
        report = ptxas_report(build.build_logs[("estep", ())], f"estep_kernelILi{ppt}E")
        assert report["spill_stores"] == report["spill_loads"] == 0, ppt
        assert report["registers"] <= 128, ppt
    assert k1._lib().em_estep_digit_bits() == k1.DIGIT_BITS
    assert k1.search_rounds(k1.DIGIT_BITS) <= 8


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
                                            (6, 321, False), (2, 41, True), (1, 161, False),
                                            (1, 177, False), (3, 99, False)])
def test_block1_kernel_matches_plain(cuda_device, b, h, large_bias):
    """K2 against block1_plain on the same card: within one bf16 step per
    element (an f32 sum in another order may round to the neighbouring
    bf16 value), the step taken at no less than 2^-12 of the largest
    output (see ops/block1.py::bf16_close); bit-equal almost everywhere;
    with w2 the identity at the centre tap and b2 = 0, the pool of y1
    bit-equal to that of conv1_plain. Odd edge tiles and a large positive
    bias included. The pipeline's edges on a 132-SM card: at 33^2 and 41^2
    every CTA owns one tile, at 161^2 exactly one each of 132, at 177^2 24
    of 132 CTAs own two (156 tiles), and at B=3, 99^2 (168 tiles) the last
    tile row is one pooled row deep and the last tile column two wide."""
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
def test_block1_kernel_builds_without_spills(cuda_device):
    """K2's build spills no register and its shared memory fits a block."""
    from em_adapt_torch.ops import block1 as k2
    from em_adapt_torch.tools.bench_block1_bwd_parts import ptxas_report
    from em_adapt_torch.utils import build

    build.build("block1_fwd")
    report = ptxas_report(build.build_logs[("block1_fwd", ())], "block1_fwd_kernel")
    assert report["spill_stores"] == report["spill_loads"] == 0
    assert report["registers"] <= 128
    assert 0 < k2._lib("block1_fwd").em_block1_fwd_smem_bytes() <= 232448


@pytest.mark.gpu
def test_block1_kernel_is_reproducible(cuda_device):
    """Each output element is one CTA's, summed in a fixed order whatever
    the timing of its producer and consumer warps: ten runs at B=6, 321^2
    give the same bits."""
    from em_adapt_torch.ops import block1 as k2

    args = _block1_case(np.random.default_rng(3), 6, 321, False, cuda_device)
    first = k2.block1_fused(*args)
    for _ in range(9):
        assert torch.equal(k2.block1_fused(*args), first)


@pytest.mark.gpu
def test_auto_block1_runs_the_kernel_at_inference(cuda_device):
    """block1_impl="auto" at full width in bf16 launches K2 once per
    forward under no_grad, and K2 then K3 once each where a gradient
    flows to block 1's weights."""
    from em_adapt_torch.config import ModelConfig
    from em_adapt_torch.models.deeplab import DeepLabLargeFOV, init_params
    from em_adapt_torch.ops import block1 as k23

    cfg = ModelConfig(num_classes=4, input_size=(33, 33), fc6_channels=8,
                      compute_dtype="bfloat16", init_scheme="he")
    model = DeepLabLargeFOV(cfg).load_params(init_params(torch.Generator(), cfg)).to(cuda_device)
    x = torch.zeros(1, 33, 33, 3, device=cuda_device)
    before = (k23.launches, k23.bwd_launches)
    with torch.no_grad():
        assert model(x).shape == (1, 5, 5, 4)
    assert (k23.launches, k23.bwd_launches) == (before[0] + 1, before[1])
    model(x).square().sum().backward()
    assert (k23.launches, k23.bwd_launches) == (before[0] + 2, before[1] + 1)


@pytest.mark.gpu
def test_pallas_block1_needs_bf16_on_the_card(cuda_device):
    from em_adapt_torch.config import ModelConfig
    from em_adapt_torch.models.deeplab import DeepLabLargeFOV, init_params

    cfg = ModelConfig(num_classes=4, input_size=(33, 33), fc6_channels=8, block1_impl="pallas")
    model = DeepLabLargeFOV(cfg).load_params(init_params(torch.Generator(), cfg)).to(cuda_device)
    with torch.no_grad(), pytest.raises(ValueError, match="bfloat16"):
        model(torch.zeros(1, 33, 33, 3, device=cuda_device))


def _bwd_case(g, b, h, kind, device):
    """K3's arguments (x, dy, w1, b1, w2, b2). "ties": integer-valued x with
    a flat patch and integer weights, so every y2 is an exact f32 sum and
    windows tie exactly; otherwise ``_block1_case``'s input, with biases
    U(20, 60) for "large bias"."""
    if kind == "ties":
        xi = g.integers(0, 3, size=(b, 3, h, h)).astype(np.float32)
        xi[:, :, :6, :6] = 1.0
        args = [torch.from_numpy(xi).to(torch.bfloat16),
                torch.from_numpy(g.integers(-2, 3, size=(64, 3, 3, 3)).astype(np.float32)),
                torch.zeros(64),
                torch.from_numpy(g.integers(-2, 3, size=(64, 64, 3, 3)).astype(np.float32)),
                torch.zeros(64)]
    else:
        args = _block1_case(g, b, h, kind == "large bias", "cpu")
    oh = (h + 1) // 2
    dy = torch.from_numpy(g.normal(size=(b, 64, oh, oh)).astype(np.float32)).to(torch.bfloat16)
    x, w1, b1, w2, b2 = (t.to(device) for t in args)
    return x, dy.to(device), w1, b1, w2, b2


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,kind", [(6, 321, "he"), (6, 321, "ties"), (1, 33, "he"),
                                      (2, 41, "large bias"), (2, 33, "ties"), (1, 65, "he"),
                                      (1, 161, "he"), (1, 161, "ties")])
def test_block1_bwd_kernel_matches_plain(cuda_device, b, h, kind):
    """K3 against block1_bwd_plain on the same card, each leaf: on
    integer-valued inputs (exact y2 on both sides) within 1e-4 of its
    scale; otherwise max|diff| within 1e-2 of it and a relative L2 within
    2e-3, where the two sum conv1_2 in another order and a y2 rounded to
    the neighbouring bf16 step reroutes a near-tied window (the bounds of
    chip_smoke.py::check_block1_bwd). Ragged edge tiles at every size. At
    B=1, 161^2 there are 238 tiles: on a 132-SM card CTAs with one tile and
    with two run side by side, so a CTA's first tile (its own x and dy
    loaded before the loop, its row stored) and its last (no loads for a
    next tile) meet both ways; at B=6, 321^2 every CTA has 40 or 41 tiles,
    at 33^2 fewer tiles than CTAs."""
    from em_adapt_torch.device import set_precision
    from em_adapt_torch.ops import block1 as k23

    set_precision("bfloat16")  # the plain version's f32 convolutions stay f32
    args = _bwd_case(np.random.default_rng(10 * h + b), b, h, kind, cuda_device)
    before = k23.bwd_launches
    got = k23.block1_bwd(*args)
    torch.cuda.synchronize()
    assert k23.bwd_launches == before + 1
    x, dy, w1, b1, w2, b2 = args
    want = k23.block1_bwd_plain(x, w1, b1, w2, b2, dy)
    tol_max, tol_l2 = (1e-4, 1e-4) if kind == "ties" else (1e-2, 2e-3)
    for name, g, w in zip(("dw1", "db1", "dw2", "db2"), got, want):
        assert g.shape == w.shape and g.dtype == torch.float32, name
        assert float((g - w).abs().max()) <= tol_max * float(w.abs().max()), name
        assert float((g - w).norm()) <= tol_l2 * float(w.norm()), name


@pytest.mark.gpu
def test_block1_bwd_kernel_is_reproducible(cuda_device):
    """Each address of a CTA's partial row has one writer thread, whose
    reductions land in tile order: ten runs at B=6, 321^2 give the same
    bits."""
    from em_adapt_torch.ops import block1 as k23

    args = _bwd_case(np.random.default_rng(3), 6, 321, "he", cuda_device)
    first = k23.block1_bwd(*args)
    for _ in range(9):
        again = k23.block1_bwd(*args)
        assert all(torch.equal(p, q) for p, q in zip(first, again))


@pytest.mark.gpu
def test_block1_bwd_variants_build_without_spills(cuda_device):
    """Every per-part build of csrc/block1_bwd.cu compiles with no spills;
    ``full`` is K3's own library, and ``skip_update`` keeps every HMMA of
    it (its later tiles' products are not dropped with their stores)."""
    from em_adapt_torch.tools import bench_block1_bwd_parts as parts
    from em_adapt_torch.utils import build

    paths = parts.build_variants()
    assert paths["full"] == build.build("block1_bwd")
    reports = parts.variant_reports(paths)
    for name, r in reports.items():
        assert r["spill_stores"] == r["spill_loads"] == 0, name
    assert reports["skip_update"]["hmma"] == reports["full"]["hmma"] > 0


@pytest.mark.gpu
def test_block1_bwd_full_variant_is_k3(cuda_device):
    from em_adapt_torch.ops import block1 as k23
    from em_adapt_torch.tools import bench_block1_bwd_parts as parts

    args = _bwd_case(np.random.default_rng(8), 6, 321, "he", cuda_device)
    got, want = parts.block1_bwd_parts(*args, "full"), k23.block1_bwd(*args)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["skip_fm", "skip_pool", "skip_conv2", "grads_only",
                                     "skip_dw2", "skip_dy1", "skip_dw1", "recompute_only"])
def test_block1_bwd_variant_matches_its_plain_version(cuda_device, variant):
    """Each variant with a definite function against its plain version on
    integer-valued inputs (exact y1 and y2 on both sides) at B=2, 65^2:
    within 1e-4 of each leaf's scale, and exactly 0 where it zeroes one."""
    from em_adapt_torch.device import set_precision
    from em_adapt_torch.tools import bench_block1_bwd_parts as parts

    set_precision("bfloat16")  # the plain version's f32 convolutions stay f32
    x, dy, w1, b1, w2, b2 = _bwd_case(np.random.default_rng(65), 2, 65, "ties", cuda_device)
    before = parts.launches
    got = parts.block1_bwd_parts(x, dy, w1, b1, w2, b2, variant)
    torch.cuda.synchronize()
    assert parts.launches == before + 1
    want = parts.block1_bwd_parts_plain(x, w1, b1, w2, b2, dy, variant)
    for name, g, w in zip(("dw1", "db1", "dw2", "db2"), got, want):
        assert g.shape == w.shape and g.dtype == torch.float32, name
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max()), name
        assert float((g - w).norm()) <= 1e-4 * float(w.norm()), name


@pytest.mark.gpu
def test_bf16_train_step_launches_k2_and_k3_once(cuda_device):
    """One bf16 training step with block1_impl="pallas" at full VGG width
    (33x33, a narrow head): K1, K2 and K3 each launch once, the loss and
    every gradient are finite, and block 1's weights get a gradient."""
    import dataclasses

    from em_adapt_torch.config import ExperimentConfig
    from em_adapt_torch.ops import block1 as k23
    from em_adapt_torch.ops import estep_kernel as k1
    from em_adapt_torch.train.trainer import Trainer

    cfg = ExperimentConfig()
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, num_classes=4, input_size=(33, 33), fc6_channels=8,
                                  compute_dtype="bfloat16", block1_impl="pallas"),
        data=dataclasses.replace(cfg.data, input_size=(33, 33)),
        train=dataclasses.replace(cfg.train, batch_size=2))
    trainer = Trainer(cfg, device=cuda_device)
    state = trainer.init_state()
    g = np.random.default_rng(0)
    label = np.zeros((2, 33, 33, 1), np.float32)
    label[:, 10:, :16] = 1
    batch = {"image": (g.normal(size=(2, 33, 33, 3)) * 40).astype(np.float32), "label": label}
    before = (k1.launches, k23.launches, k23.bwd_launches)
    metrics = trainer.train_step(state, batch)
    torch.cuda.synchronize()
    assert (k1.launches, k23.launches, k23.bwd_launches) == tuple(n + 1 for n in before)
    assert np.isfinite(float(metrics["loss"]))
    grads = [p.grad for p in state.model.parameters()]
    assert all(p is not None and bool(torch.isfinite(p).all()) for p in grads)
    assert float(state.model.layers["conv1_2"].weight.grad.abs().sum()) > 0
