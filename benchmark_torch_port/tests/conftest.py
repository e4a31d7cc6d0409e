"""Shared pieces of the benchmark's own tests: the benchmark's directory on
the path, the card fixture (decided inside the test, never at import), and
cells cut to a size the CPU holds (CPU tests only: the cells run at the
published widths)."""

import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for path in (BENCH, os.path.dirname(BENCH)):
    if path not in sys.path:
        sys.path.insert(0, path)

import pytest  # noqa: E402

#: A cell at a CPU's size: width 1/8, fc6 of 32, a 33x33 input.
SMALL = ("model.width_multiplier=0.125", "model.fc6_channels=32", "model.input_size=(33,33)")
SMALL_TRAIN = SMALL + ("train.batch_size=4", "model.block1_impl=pallas")
SMALL_EVAL = SMALL + ("eval.crf_iterations=2", "eval.crf_bi_srgb=40", "eval.batch_size=2",
                      "model.block1_impl=pallas")
#: Evaluation traffic at a CPU's size: ten small images in stretches of four.
SMALL_EVAL_TRAFFIC = dict(images=4, standard_share=0.0, side_range=[40, 90],
                          compare_images=3)


def small_ctx(workload: str, seed: int = 2 ** 31 + 17, seconds: float = 0.3):
    """A CPU run of ``workload`` at a small size."""
    import torch

    import harness

    ctx = harness.Context(workload=workload, seed=seed, seconds=seconds, trace=False,
                          device=torch.device("cpu"))
    if ctx.spec["driver"] == "train":
        extra = SMALL_TRAIN
        if ctx.config["data"].get("train_label_size"):
            extra += ("data.train_label_size=(5,5)",)
    else:
        extra = SMALL_EVAL
        ctx.traffic.update(SMALL_EVAL_TRAFFIC)
    ctx.extra_overrides = extra
    return ctx


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
