"""The yardstick's counts: FLOP from shapes against the program's own
count, the parameters, and the bytes bounds."""

import pytest

import work


def test_train_flops_at_321_batch_6():
    assert work.train_flops(321, 321, 6) == 4_532_042_506_752


def test_train_flops_agree_with_chip_smoke_and_scale_by_shape():
    chip_smoke = pytest.importorskip("chip_smoke")
    from em_adapt_torch.config import ModelConfig

    for size in (321, 513):
        cfg = ModelConfig(input_size=(size, size))
        assert work.train_flops(size, size, 6) == chip_smoke.conv_flops(cfg, 6)
    # Each layer's work scales with its own resolution: 161/81/41 at 321,
    # 257/129/65 at 513.
    ratio = work.train_flops(513, 513, 6) / work.train_flops(321, 321, 6)
    assert ratio == pytest.approx(11_411_659_399_680 / 4_532_042_506_752)
    assert work.train_flops(321, 321, 30) == 5 * work.train_flops(321, 321, 6)


def test_forward_is_a_third_of_the_step_but_conv1_1():
    fwd = work.forward_flops(321, 321, 6)
    conv1_1 = 2 * 27 * 64 * 321 * 321 * 6
    assert work.train_flops(321, 321, 6) == 3 * fwd - conv1_1


def test_parameters_against_the_port():
    from em_adapt_torch.config import ModelConfig
    from em_adapt_torch.models.deeplab import layer_specs

    assert work.num_params() == 65_140_565
    for cfg in (ModelConfig(), ModelConfig(width_multiplier=0.125, fc6_channels=32)):
        ours = [spec[:5] for spec in work.layers(fc6_channels=cfg.fc6_channels,
                                                 width=cfg.width_multiplier)]
        assert ours == [spec[:5] for spec in layer_specs(cfg)]


def test_block1_and_estep_bounds():
    fwd = work.block1_fwd(321, 321, 6)
    assert fwd["flops"] == 47_718_699_264
    assert fwd["bound_s"] == pytest.approx(fwd["flops"] / work.PEAK_BF16_FLOPS)
    bwd = work.block1_bwd(321, 321, 6)
    assert bwd["flops"] == 2 * 321 * 321 * 6 * (2 * 576 * 64 + 27 * 64)
    assert work.estep_bytes(6, 1681) == 2 * 6 * 21 * 1681 * 4 + 6 * 1681 * 4 + 105 * 4 + 6 * 105 * 4


def test_crf_bytes_match_the_card_crf_grid():
    from em_adapt_torch.eval.crf_device import grid_cells

    for h, w in ((384, 512), (375, 500), (500, 375), (200, 499), (512, 512)):
        assert work.crf_grid_cells(h, w) == grid_cells(h, w)
    # chip_smoke's bound of a 384x512 bucket: 7.387 ms at 3.35 TB/s.
    assert work.crf_bytes(384, 512) / work.HBM_BYTES_PER_S == pytest.approx(7.387e-3, rel=1e-3)


def test_shares_never_report_zero_for_nothing():
    assert work.roofline_percent(1e-3, 0) is None
    assert work.roofline_percent(1e-3, 2e-3) == pytest.approx(50.0)
