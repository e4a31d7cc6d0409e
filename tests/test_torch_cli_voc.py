"""PyTorch port: the command line on a VOC tree on the CPU. ``convert``
writes the JAX package's masks and exits 2 without an input; ``train``
reads the tree's "train" split through the prefetcher, ``train --resume``
continues to the uninterrupted run's state bit for bit, and ``eval
--fixed-size`` scores the "val" split, with and without the prefetcher."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("PIL")

from em_adapt_torch import config as pcfg  # noqa: E402
from em_adapt_torch.__main__ import main  # noqa: E402
from em_adapt_torch.data.pipeline import VOCSegmentation, batch_iterator  # noqa: E402
from em_adapt_torch.data.voc import VOC_CLASS_NAMES  # noqa: E402
from em_adapt_torch.eval.predict import Evaluator  # noqa: E402
from em_adapt_torch.models.deeplab import build_model  # noqa: E402
from em_adapt_torch.train.checkpoint import CheckpointManager  # noqa: E402
from em_adapt_torch.train.state import bitwise_diff  # noqa: E402
from em_adapt_tpu.data import voc as jvoc  # noqa: E402
from tests.test_torch_data import _pngs, write_voc_tree  # noqa: E402

torch.set_num_threads(2)

#: Small widths; the tree's 8 train images at batch 2 are 4 steps an epoch.
SMALL = ["--device", "cpu", "model.width_multiplier=0.125", "model.fc6_channels=8",
         "model.input_size=(33, 33)", "train.batch_size=2", "optim.accum_steps=2",
         "data.num_workers=2", "model.init_scheme=he", "optim.lr_schedule=((1, 0.0001),)",
         "checkpoint.save_every_steps=2", "eval.batch_size=2"]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A VOC tree whose masks went through the port's ``convert``; the
    overrides that point the data config at it."""
    root = tmp_path_factory.mktemp("pascal")
    main_path, txt = write_voc_tree(root)
    assert main(["convert", "--voc-seg", str(main_path / "SegmentationClass"),
                 "--out", str(main_path / "SegmentationClassAug")]) == 0
    return main_path, [f"data.main_path={main_path}", f"data.list_dir={txt}"]


def test_convert_needs_an_input(tmp_path, capsys):
    assert main(["convert", "--out", str(tmp_path / "out")]) == 2
    assert "need at least one of --voc-seg / --sbd-cls" in capsys.readouterr().err
    assert not (tmp_path / "out").exists()


def test_convert_writes_the_jax_packages_masks(tree, tmp_path):
    main_path, _ = tree
    jvoc.convert_dataset(str(main_path / "SegmentationClass"), None, str(tmp_path),
                         log=lambda *a: None)
    got, want = _pngs(main_path / "SegmentationClassAug"), _pngs(tmp_path)
    assert list(got) == list(want) and len(got) == 11
    for name in got:
        np.testing.assert_array_equal(got[name], want[name])


def _train(capsys, save_dir, data_args, *extra):
    assert main(["train", *extra, *SMALL, *data_args, f"checkpoint.save_dir={save_dir}"]) == 0
    return capsys.readouterr().out.strip().splitlines()


def _losses(lines):
    return [(r["step"], r["loss"]) for r in map(json.loads, lines) if "loss" in r]


def test_train_then_resume_on_a_voc_tree(tree, tmp_path, capsys):
    """`train --steps 3` then `train --resume --steps 6` on the tree end on
    the state of one `train --steps 6` run bit for bit, with its losses;
    the run crosses an epoch (4 steps) and the LR drop at step 4."""
    _, data_args = tree
    once = _train(capsys, tmp_path / "once", data_args, "--steps", "6")
    assert [s for s, _ in _losses(once)] == list(range(6))
    assert all(np.isfinite(v) for _, v in _losses(once))
    first = _train(capsys, tmp_path / "twice", data_args, "--steps", "3")
    resumed = _train(capsys, tmp_path / "twice", data_args, "--resume", "--steps", "6")
    assert resumed.pop(0) == "resumed from step 3"
    assert _losses(first) + _losses(resumed) == _losses(once)
    records = [json.loads(line) for line in once]
    assert all(r["wait_seconds"] >= 0.0 for r in records)
    ckpt = [CheckpointManager(pcfg.CheckpointConfig(save_dir=str(tmp_path / d)))
            for d in ("once", "twice")]
    assert ckpt[0].all_steps("norm") == ckpt[1].all_steps("norm") == [4, 6]
    assert bitwise_diff(ckpt[0].load("norm"), ckpt[1].load("norm")) == []


@pytest.mark.parametrize("prefetch", [2, 0])
def test_eval_on_the_val_split(tree, tmp_path, capsys, prefetch):
    """`eval --fixed-size` loads the latest "norm" params and prints the
    IoU and mIoU that Evaluator gives on the tree's "val" split (3 images,
    the last batch padded), with the prefetcher and without it."""
    _, data_args = tree
    _train(capsys, tmp_path, data_args, "--steps", "2")
    args = SMALL + data_args + [f"checkpoint.save_dir={tmp_path}", f"data.prefetch={prefetch}"]
    assert main(["eval", "--fixed-size", *args]) == 0
    out = capsys.readouterr().out.strip().splitlines()

    cfg = pcfg.apply_overrides(pcfg.ExperimentConfig(), args[2:])
    model = build_model(cfg.model, 0, torch.device("cpu"))
    assert CheckpointManager(cfg.checkpoint).restore_params(model, "norm") == 2
    val = batch_iterator(VOCSegmentation(cfg.data, "val"), cfg.data, batch_size=2, epochs=1,
                         train=False)
    miou, iou = Evaluator(cfg, model).evaluate_fixed(val)
    want = [f"  IoU[{VOC_CLASS_NAMES[i]}] = {v:.4f}" for i, v in enumerate(iou)]
    assert out == ["evaluating checkpoint step 2"] + want + [f"mIoU = {miou:.4f}"]
    assert len(iou) == 21
