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


#: The settings under which chip_smoke.py's "resume bf16" phase found two
#: uninterrupted bf16 runs, and a run resumed from its checkpoint, bit-equal
#: on an NVIDIA H100 80GB HBM3 (PERF.md §6): one of
#: chip_smoke.DETERMINISM_LEVELS.
RESUME_DETERMINISM = "default"


@pytest.fixture
def resume_determinism():
    saved = (torch.backends.cudnn.deterministic, torch.are_deterministic_algorithms_enabled())
    SMOKE.set_determinism(RESUME_DETERMINISM)
    yield
    torch.backends.cudnn.deterministic = saved[0]
    torch.use_deterministic_algorithms(saved[1])


def _small_trainer(device, save_dir, **model):
    import dataclasses

    from em_adapt_torch.config import CheckpointConfig, ExperimentConfig
    from em_adapt_torch.train.trainer import Trainer

    cfg = ExperimentConfig()
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, num_classes=4, input_size=(33, 33), fc6_channels=8,
                                  **model),
        data=dataclasses.replace(cfg.data, input_size=(33, 33), num_workers=2),
        optim=dataclasses.replace(cfg.optim, accum_steps=3, lr_schedule=((1, 1e-4),)),
        train=dataclasses.replace(cfg.train, batch_size=2),
        checkpoint=CheckpointConfig(save_dir=str(save_dir), save_every_steps=0))
    return Trainer(cfg, device=device, steps_per_epoch=4)


def _batches(trainer, start_step=0):
    from em_adapt_torch.data.pipeline import SyntheticVOC, batch_iterator

    return batch_iterator(SyntheticVOC(8, 4), trainer.cfg.data, batch_size=2, seed=0,
                          start_step=start_step)


@pytest.mark.gpu
def test_cuda_generator_state_round_trips(cuda_device, tmp_path):
    """A CUDA generator's state is a CPU byte tensor; saved with torch.save
    and set on a fresh CUDA generator, it draws the same numbers."""
    g = torch.Generator(cuda_device).manual_seed(3)
    torch.rand(10, generator=g, device=cuda_device)
    state = g.get_state()
    assert state.device.type == "cpu" and state.dtype == torch.uint8
    torch.save(state, tmp_path / "generator.pt")
    want = torch.rand(1000, generator=g, device=cuda_device)
    perm = torch.randperm(20, generator=g, device=cuda_device)
    other = torch.Generator(cuda_device)
    other.set_state(torch.load(tmp_path / "generator.pt", weights_only=True))
    assert torch.equal(torch.rand(1000, generator=other, device=cuda_device), want)
    assert torch.equal(torch.randperm(20, generator=other, device=cuda_device), perm)


@pytest.mark.gpu
def test_bf16_resume_on_the_card_is_bit_exact(cuda_device, tmp_path, resume_determinism):
    """bf16 with the fused block 1 (K1, K2, K3 once a step), accumulation
    3: a run stopped at step 4 (mid-window), saved, restored into a fresh
    Trainer and run to step 8 ends on the uninterrupted run's state (params,
    momentum, acc, mini_step, step, generator) and losses, bit for bit."""
    from em_adapt_torch.train.state import bitwise_diff

    model = dict(compute_dtype="bfloat16", block1_impl="pallas")
    control = _small_trainer(cuda_device, tmp_path / "control", **model)
    want = control.init_state()
    want_records = control.fit(want, _batches(control), num_steps=8)
    first = _small_trainer(cuda_device, tmp_path / "run", **model)
    state = first.init_state()
    first.fit(state, _batches(first), num_steps=4)
    first.checkpointer.save(state, "norm")
    first.checkpointer.close()
    trainer = _small_trainer(cuda_device, tmp_path / "run", **model)
    resumed = trainer.restore_state()
    assert resumed.step == 4 and resumed.optimizer.mini_step == 1
    records = trainer.fit(resumed, _batches(trainer, 4), num_steps=8)
    assert all((r["estep_launches"], r["block1_fwd_launches"], r["block1_bwd_launches"])
               == (1, 1, 1) for r in records)
    assert [r["loss"] for r in records] == [r["loss"] for r in want_records[4:]]
    assert bitwise_diff(resumed.state_dict(), want.state_dict()) == []


@pytest.mark.gpu
def test_async_save_of_cuda_state_then_in_place_update(cuda_device, tmp_path, monkeypatch):
    """An async save copies the CUDA state to the host before it returns:
    params, momentum, acc and the generator updated in place while the
    file is still being written do not reach it."""
    import copy
    import threading
    import time

    from em_adapt_torch.config import CheckpointConfig
    from em_adapt_torch.train.checkpoint import CheckpointManager
    from em_adapt_torch.train.state import bitwise_diff

    trainer = _small_trainer(cuda_device, tmp_path / "unused")
    state = trainer.init_state()
    trainer.fit(state, _batches(trainer), num_steps=4)  # one update made, acc mid-window
    want = copy.deepcopy(state.state_dict())
    real_save, started = torch.save, threading.Event()

    def slow_save(obj, f, *a, **kw):
        started.set()
        time.sleep(0.3)
        return real_save(obj, f, *a, **kw)

    monkeypatch.setattr(torch, "save", slow_save)
    ckpt = CheckpointManager(CheckpointConfig(save_dir=str(tmp_path), async_save=True))
    ckpt.save(state, "norm")
    assert started.wait(10)
    with torch.no_grad():
        for p in state.model.parameters():
            p.mul_(-2.0)
        for buf in state.optimizer.state_dict()["momentum"]:
            buf.add_(1.0)
        for a in state.optimizer.acc:
            a.add_(1.0)
    torch.rand(4, generator=state.generator, device=cuda_device)
    ckpt.close()
    assert bitwise_diff(state.state_dict(), want) != []
    assert bitwise_diff(want, ckpt.load("norm")) == []


def _sleepy_prefetcher(cycles):
    """A DevicePrefetcher whose copy stream spins ``cycles`` clock cycles
    before each batch's copies: its batches arrive on the card late."""
    from em_adapt_torch.data.pipeline import DevicePrefetcher

    class Sleepy(DevicePrefetcher):
        def _upload(self, batch, slot):
            torch.cuda._sleep(cycles)  # on the fill thread's current stream: the copy stream
            return super()._upload(batch, slot)

    return Sleepy


@pytest.mark.gpu
@pytest.mark.parametrize("wire", ["float32", "uint8"])
def test_prefetched_batches_are_the_host_batches_from_pinned_memory(cuda_device, wire):
    """Through the pinned ring, on the copy stream: every batch on the
    card equals its host batch bit for bit, ids pass through, and each
    ring slot's buffers are pinned host memory."""
    from em_adapt_torch.config import DataConfig
    from em_adapt_torch.data.pipeline import DevicePrefetcher, SyntheticVOC, batch_iterator

    cfg = DataConfig(input_size=(65, 65), num_workers=2, wire_dtype=wire)
    host = list(batch_iterator(SyntheticVOC(30, seed=2), cfg, batch_size=6, seed=1, epochs=1))
    with DevicePrefetcher(iter(host), cuda_device, depth=2) as pf:
        dev = list(pf)
        assert len(pf._ring) == 3 and all(
            buf.is_pinned() for slot in pf._ring for buf in slot.values())
        assert sorted(pf._ring[0]) == ["image", "label"]
    assert len(dev) == len(host) == 5
    for h, d in zip(host, dev):
        assert d["id"] == h["id"]
        for k in ("image", "label"):
            assert d[k].device.type == "cuda" and d[k].dtype == torch.from_numpy(h[k]).dtype
            np.testing.assert_array_equal(d[k].cpu().numpy(), h[k])


@pytest.mark.gpu
def test_consumer_waits_for_a_late_copy(cuda_device):
    """The hazard test: each batch's copies wait behind about 0.1 s of
    spinning on the copy stream. The consumer's stream must wait on the
    copy's event: a read on it right away still gives the host bytes."""
    g = np.random.default_rng(4)
    host = [{"image": g.normal(size=(6, 97, 97, 3)).astype(np.float32), "id": [str(i)]}
            for i in range(3)]
    pf = _sleepy_prefetcher(200_000_000)(iter(host), cuda_device, depth=2)
    try:
        for h in host:
            d = next(pf)
            got = (d["image"] * 1.0).cpu().numpy()  # a kernel and a copy on the current stream
            np.testing.assert_array_equal(got, h["image"])
    finally:
        pf.close()


@pytest.mark.gpu
def test_ring_refilled_ahead_of_its_copies_yields_no_mixed_batch(cuda_device):
    """The source is far faster than the copies (each waits behind about
    10 ms of spinning on the copy stream) and the consumer takes every
    batch at once: batch i still arrives as all i, so no slot of the ring
    was refilled while its copy was pending."""
    n = 12

    def source():
        for i in range(n):
            yield {"image": np.full((6, 129, 129, 3), i, np.float32),
                   "label": np.full((6, 129, 129, 1), i, np.uint8)}

    with _sleepy_prefetcher(20_000_000)(source(), cuda_device, depth=2) as pf:
        got = list(pf)
    torch.cuda.synchronize()
    assert len(got) == n
    for i, d in enumerate(got):
        for k in ("image", "label"):
            values = torch.unique(d[k]).cpu().tolist()
            assert values == [i], (i, k, values)


@pytest.mark.gpu
def test_fit_with_the_prefetcher_on_the_card_equals_fit_without(cuda_device, tmp_path):
    """A small bf16 run with K1, K2 and K3: data.prefetch=2 and
    data.prefetch=0 give the same losses and final state, bit for bit."""
    import dataclasses

    from em_adapt_torch.train.state import bitwise_diff

    runs = []
    for depth in (0, 2):
        trainer = _small_trainer(cuda_device, tmp_path / str(depth), compute_dtype="bfloat16",
                                 block1_impl="pallas")
        trainer.cfg = trainer.cfg.replace(data=dataclasses.replace(trainer.cfg.data,
                                                                   prefetch=depth))
        state = trainer.init_state()
        records = trainer.fit(state, _batches(trainer), num_steps=6)
        runs.append(([r["loss"] for r in records], state.state_dict()))
    assert runs[0][0] == runs[1][0] and len(runs[0][0]) == 6
    assert bitwise_diff(runs[0][1], runs[1][1]) == []


@pytest.mark.gpu
def test_fit_makes_no_host_sync_between_cadences(cuda_device, tmp_path):
    """A small bf16 run with K1, K2 and K3 through the prefetcher, with no
    log, eval or save cadence inside it, under
    ``torch.cuda.set_sync_debug_mode("error")``: no step makes the host
    wait for the card (a synchronizing call raises), from the first step
    on; the late loss reads wait on events, which the mode allows."""
    import dataclasses

    trainer = _small_trainer(cuda_device, tmp_path, compute_dtype="bfloat16",
                             block1_impl="pallas")
    trainer.cfg = trainer.cfg.replace(checkpoint=dataclasses.replace(
        trainer.cfg.checkpoint, snapshot_on_lr_drop=False))  # no "lr" save at step 4
    state = trainer.init_state()
    batches = _batches(trainer)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        records = trainer.fit(state, batches, num_steps=6)
    finally:
        torch.cuda.set_sync_debug_mode(0)
        batches.close()
    assert len(records) == 6 and all(np.isfinite(r["loss"]) for r in records)
    assert all((r["estep_launches"], r["block1_fwd_launches"], r["block1_bwd_launches"])
               == (1, 1, 1) for r in records)


@pytest.mark.gpu
def test_late_loss_check_equals_per_step_reads(cuda_device, tmp_path):
    """The losses fit reads one step late equal, bit for bit, those of the
    same steps with the loss read (and the card waited for) after each."""
    trainer = _small_trainer(cuda_device, tmp_path, compute_dtype="bfloat16",
                             block1_impl="pallas")
    state = trainer.init_state()
    late = [r["loss"] for r in trainer.fit(state, _batches(trainer), num_steps=6)]
    state = trainer.init_state()
    batches = _batches(trainer)
    read = [float(trainer.train_step(state, next(batches))["loss"]) for _ in range(6)]
    batches.close()
    assert late == read


@pytest.mark.gpu
@pytest.mark.parametrize("tag", ["norm", "best"])
def test_nan_on_a_save_step_is_never_written(cuda_device, tmp_path, tag):
    """Step 1, after which "norm" (every 2) or "best" (an eval every 2)
    would be saved, leaves NaN in the params and in its loss: fit raises
    and nothing is written. (The NaN is put into the state after the
    step's launch: a NaN image does not reach the loss in the same step
    in bf16, since the fused block 1's ReLU maps NaN to 0.)"""
    import dataclasses

    trainer = _small_trainer(cuda_device, tmp_path, compute_dtype="bfloat16",
                             block1_impl="pallas")
    cfg = trainer.cfg
    trainer.cfg = cfg.replace(
        checkpoint=dataclasses.replace(cfg.checkpoint, save_every_steps=2 if tag == "norm" else 0),
        train=dataclasses.replace(cfg.train, eval_every_steps=2 if tag == "best" else None))
    step = trainer.train_step

    def poisoned(state, batch):
        metrics = step(state, batch)
        if state.step == 2:  # step 1 has run
            with torch.no_grad():
                state.model.layers["fc8"].bias.fill_(float("nan"))
            metrics["loss"] = metrics["loss"] * float("nan")
        return metrics

    trainer.train_step = poisoned
    with pytest.raises(RuntimeError, match="training unhealthy at step 1: non-finite"):
        trainer.fit(trainer.init_state(), _batches(trainer), num_steps=4,
                    eval_fn=lambda s: 1.0)
    assert trainer.checkpointer.all_steps("norm") == trainer.checkpointer.all_steps("best") == []
    assert not (tmp_path / "best_metric.json").exists()
