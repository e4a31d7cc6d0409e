"""PyTorch port: K3's per-part builds (em_adapt_torch/tools/
bench_block1_bwd_parts.py), on the CPU. Each variant's plain version
against what it must compute (``full`` against ``block1_bwd_plain`` and
JAX's K3 in interpret mode, the switched-off products as zeros, the
substitutions against autograd or sums of the recomputed activations),
the build plumbing without nvcc, the per-part FLOP accounting, and the
tool's refusal to run without a card."""

import importlib.util
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from em_adapt_torch.ops import block1 as k23  # noqa: E402
from em_adapt_torch.tools import bench_block1_bwd_parts as parts  # noqa: E402
from em_adapt_torch.utils import build  # noqa: E402
from em_adapt_tpu.ops.block1_pallas import block1_fused as jax_block1_fused  # noqa: E402

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = [(1, 13), (2, 33)]


def _args(seed, b, h, dtype=torch.bfloat16, f=64):
    """(x, dy, w1, b1, w2, b2): NCHW x and dy in ``dtype``, OIHW f32
    weights and small f32 biases, from numpy."""
    g = np.random.default_rng(seed)
    oh = (h + 1) // 2
    x = torch.from_numpy(g.normal(size=(b, 3, h, h)).astype(np.float32) * 3).to(dtype)
    dy = torch.from_numpy(g.normal(size=(b, f, oh, oh)).astype(np.float32)).to(dtype)
    w1 = torch.from_numpy((g.normal(size=(f, 3, 3, 3)) * 0.2).astype(np.float32))
    w2 = torch.from_numpy((g.normal(size=(f, f, 3, 3)) * 0.06).astype(np.float32))
    b1, b2 = (torch.from_numpy((g.normal(size=f) * 0.1).astype(np.float32)) for _ in range(2))
    return x, dy, w1, b1, w2, b2


def _plain(args, variant):
    x, dy, w1, b1, w2, b2 = args
    return parts.block1_bwd_parts_plain(x, w1, b1, w2, b2, dy, variant)


def _y2(args):
    x, _, w1, b1, w2, b2 = args
    y1 = k23.conv1_plain(x, w1, b1)
    y2 = F.relu(F.conv2d(y1.float(), w2.to(x.dtype).float(), padding=1)
                + b2[None, :, None, None]).to(x.dtype)
    return y1, y2


@pytest.mark.parametrize("b,h", SIZES)
def test_full_is_block1_bwd_plain_to_the_bit(b, h):
    args = _args(h + b, b, h)
    x, dy, w1, b1, w2, b2 = args
    want = k23.block1_bwd_plain(x, w1, b1, w2, b2, dy)
    got = _plain(args, "full")
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_full_matches_the_jax_kernel():
    """``full`` in f32 against JAX's K3 (block1_fused's gradients, interpret
    mode) at 1e-4 of each leaf's scale, the bound of
    tests/test_torch_block1_bwd.py (the sums run in another order)."""
    x, dy, w1, b1, w2, b2 = _args(5, 2, 13, torch.float32, f=16)
    nhwc = lambda t: jnp.asarray(t.permute(0, 2, 3, 1).numpy())  # noqa: E731
    hwio = lambda t: jnp.asarray(t.permute(2, 3, 1, 0).numpy())  # noqa: E731
    _, vjp = jax.vjp(lambda *p: jax_block1_fused(nhwc(x), *p, True),
                     hwio(w1), jnp.asarray(b1.numpy()), hwio(w2), jnp.asarray(b2.numpy()))
    want = [np.asarray(g, np.float32) for g in vjp(nhwc(dy))]
    got = parts.block1_bwd_parts_plain(x, w1, b1, w2, b2, dy, "full")
    got = [got[0].permute(2, 3, 1, 0).numpy(), got[1].numpy(), got[2].permute(2, 3, 1, 0).numpy(),
           got[3].numpy()]
    for name, g, w in zip(("dw1", "db1", "dw2", "db2"), got, want):
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g / scale, w / scale, rtol=0, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("b,h", SIZES)
@pytest.mark.parametrize("variant,zeroed", [("skip_dw2", ("dw2",)), ("skip_dy1", ("dw1", "db1")),
                                            ("skip_dw1", ("dw1",))])
def test_skipped_products_zero_exactly_their_leaves(variant, zeroed, b, h):
    args = _args(3 * h + b, b, h)
    full = dict(zip(("dw1", "db1", "dw2", "db2"), _plain(args, "full")))
    got = dict(zip(("dw1", "db1", "dw2", "db2"), _plain(args, variant)))
    for leaf in full:
        assert got[leaf].shape == full[leaf].shape and got[leaf].dtype == torch.float32
        if leaf in zeroed:
            assert not bool(got[leaf].any()), leaf
            assert bool(full[leaf].any()), leaf  # the case exercises the leaf
        else:
            assert torch.equal(got[leaf], full[leaf]), leaf


@pytest.mark.parametrize("b,h", SIZES)
def test_skip_pool_is_the_gradient_of_half_the_sum_of_y2_squared(b, h):
    """dz2 := y2 is the gradient of 1/2 sum y2^2; in f32 (no rounding of
    y1, y2 or dz1) the variant equals torch.autograd through the plain
    block at 1e-5 of each leaf's scale (sums in another order)."""
    args = _args(7 * h + b, b, h, torch.float32)
    x, dy, w1, b1, w2, b2 = args
    ws = [t.clone().requires_grad_(True) for t in (w1, b1, w2, b2)]
    y1 = k23.conv1_plain(x, ws[0], ws[1])
    y2 = F.relu(F.conv2d(y1, ws[2], padding=1) + ws[3][None, :, None, None])
    want = torch.autograd.grad(0.5 * y2.square().sum(), ws)
    got = _plain(args, "skip_pool")
    for name, g, w in zip(("dw1", "db1", "dw2", "db2"), got, want):
        scale = float(w.abs().max())
        assert scale > 0, name
        assert float((g - w).abs().max()) <= 1e-5 * scale, name


def test_skip_fm_routes_each_window_to_its_corner():
    """h = 5, pooled 3 x 3: window (P, Q) covers y2 rows 2P-1..2P+1; its
    position (0, 0) is (2P - 1, 2Q - 1), padding for P = 0 or Q = 0. So
    only the four windows with P, Q >= 1 route, each to its own corner."""
    y2 = torch.ones(1, 1, 5, 5)
    dy = torch.arange(1.0, 10.0).reshape(1, 1, 3, 3)
    want = torch.zeros(1, 1, 5, 5)
    for p, q in ((1, 1), (1, 2), (2, 1), (2, 2)):
        want[0, 0, 2 * p - 1, 2 * q - 1] = dy[0, 0, p, q]
    assert torch.equal(parts.route_to_corner_plain(y2, dy), want)
    # and the variant masks the routed gradient by y2 > 0 before its sums
    args = _args(11, 1, 5)
    x, dy, *_ = args
    _, y2 = _y2(args)
    routed = torch.where(y2 > 0, parts.route_to_corner_plain(y2, dy), 0).float()
    assert torch.equal(_plain(args, "skip_fm")[3], routed.sum((0, 2, 3)))


@pytest.mark.parametrize("b,h", SIZES)
def test_recompute_only_sums_y1_and_y2(b, h):
    args = _args(5 * h + b, b, h)
    y1, y2 = _y2(args)
    dw1, db1, dw2, db2 = _plain(args, "recompute_only")
    assert not dw1.any() and not dw2.any()
    assert torch.equal(db1, y1.float().sum((0, 2, 3)))
    assert torch.equal(db2, y2.float().sum((0, 2, 3)))
    assert bool(db1.any()) and bool(db2.any())


def test_skip_conv2_and_grads_only_take_y1_for_y2():
    """With w2 the identity at its centre tap and b2 = 0, ``full``'s y2 is
    y1, so ``skip_conv2`` equals it to the bit; ``grads_only`` (dz2 := y1)
    gives db2 = sum y1 and dw2 = y1's correlation with itself."""
    x, dy, w1, b1, w2, b2 = _args(17, 2, 13)
    eye = torch.zeros_like(w2)
    eye[range(64), range(64), 1, 1] = 1
    args = (x, dy, w1, b1, eye, torch.zeros_like(b2))
    assert all(torch.equal(g, w) for g, w in zip(_plain(args, "skip_conv2"), _plain(args, "full")))
    y1 = k23.conv1_plain(x, w1, b1).float()
    _, _, dw2, db2 = _plain((x, dy, w1, b1, w2, b2), "grads_only")
    assert torch.equal(db2, y1.sum((0, 2, 3)))
    assert torch.equal(dw2, torch.nn.grad.conv2d_weight(y1, w2.shape, y1, padding=1))


def test_the_cpu_wrapper_runs_the_plain_versions_and_launches_nothing():
    args = _args(2, 1, 13)
    before = (parts.launches, k23.bwd_launches)
    for variant in parts.VARIANTS:
        if variant == "skip_update":
            with pytest.raises(ValueError, match="timing-only"):
                parts.block1_bwd_parts(*args, variant)
        else:
            got = parts.block1_bwd_parts(*args, variant)
            assert all(torch.equal(g, w) for g, w in zip(got, _plain(args, variant)))
    assert (parts.launches, k23.bwd_launches) == before
    with pytest.raises(ValueError, match="unknown K3 variant"):
        parts.block1_bwd_parts(*args, "skip_everything")


def test_variant_builds_are_distinct_from_production():
    """No defines: the production library's path, named as before; every
    variant its own file, carrying its macros; every macro of the table
    under an #if of csrc/block1_bwd.cu."""
    prod = build._target("block1_bwd")
    assert prod == build._target("block1_bwd", ())
    assert re.fullmatch(r"libblock1_bwd-[0-9a-f]{16}\.so", prod.name)
    targets = {n: build._target("block1_bwd", v.defines) for n, v in parts.VARIANTS.items()}
    assert targets["full"] == prod
    assert len(set(targets.values())) == len(targets)
    src = (build.CSRC / "block1_bwd.cu").read_text()
    for variant, v in parts.VARIANTS.items():
        for d in v.defines:
            assert d in targets[variant].name
            assert re.search(rf"^#if !?defined\({d}\)", src, re.M), d


def test_a_built_variant_is_reused_with_its_ptxas_report(tmp_path, monkeypatch):
    """A library built by an earlier process is reused and its ptxas
    report read back from beside it; one without a report is built again
    (here that needs nvcc, which the CPU machine lacks)."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "build_logs", {})
    defines = parts.VARIANTS["skip_fm"].defines
    target = build._target("block1_bwd", defines)
    target.write_bytes(b"")
    target.with_suffix(".log").write_text("ptxas info    : Used 128 registers")
    assert build.build("block1_bwd", defines) == target
    assert build.build_logs == {("block1_bwd", defines): "ptxas info    : Used 128 registers"}
    target.with_suffix(".log").unlink()
    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build("block1_bwd", defines)


def test_part_flops_sum_to_k3s_operations():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    flops = parts.part_flops(6, 321)
    needed = sum(n for _, n in flops.values())
    assert needed == chip_smoke.k3_flops(6, 321)[0] == 141_019_439_616
    assert all(e >= n for e, n in flops.values())  # executed work covers what is needed
    assert flops["conv1_1"][0] == 2 * 323 * 27 * 64 * 5346  # 5,346 tiles at B=6, 321^2


def test_every_part_switched_off_has_its_flop_count():
    flops = parts.part_flops(1, 33)
    for name, v in parts.VARIANTS.items():
        assert v.parts_off and set(v.parts_off) <= set(flops), name
    assert set(parts.VARIANTS["full"].parts_off) == set(flops) - {"first_match"}


def test_ptxas_report_reads_the_main_kernel():
    log = ("ptxas info    : Compiling entry function '_ZN4_GLOBAL17block1_bwd_reduceEPKf' for "
           "'sm_90a'\nptxas info    : Function properties for _ZN4_GLOBAL17block1_bwd_reduceEPKf\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
           "ptxas info    : Used 16 registers, 400 bytes cmem[0]\n"
           "ptxas info    : Compiling entry function '_ZN4_GLOBAL17block1_bwd_kernelEPK' for "
           "'sm_90a'\nptxas info    : Function properties for _ZN4_GLOBAL17block1_bwd_kernelEPK\n"
           "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads\n"
           "ptxas info    : Used 128 registers, used 1 barriers, 400 bytes cmem[0]\n")
    assert parts.ptxas_report(log) == dict(registers=128, spill_stores=8, spill_loads=4,
                                           static_smem=0)
    with pytest.raises(RuntimeError, match="no ptxas report"):
        parts.ptxas_report("nvcc: nothing")


def test_the_tool_raises_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the tool would run for real")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parts.main(["--batch", "1"])
    assert capsys.readouterr().out == ""


def test_the_build_comparison_raises_without_a_card(capsys):
    """compare_block1_bwd_builds needs the card before it builds anything;
    its cases are chip_smoke.py's K3 cases plus B=1, 161^2."""
    from em_adapt_torch.tools import compare_block1_bwd_builds as compare

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the tool would run for real")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compare.main([os.path.join(REPO, "em_adapt_torch", "csrc", "block1_bwd.cu")])
    assert capsys.readouterr().out == ""
    smoke = open(os.path.join(REPO, "chip_smoke.py")).read()
    for name, b, h, kind in compare.CASES:
        if h != 161:
            assert f'("{name}", {b}, {h}, "{kind}")' in smoke, name
