"""PyTorch port: the bf16 forward (conv path and fused block1), the
confusion matrix and mIoU, eval batches, ``Evaluator.evaluate_fixed`` and
the ``eval`` CLI, against the JAX package on shared weights and data."""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import em_adapt_tpu.config as jcfg  # noqa: E402
from em_adapt_torch import config as pcfg  # noqa: E402
from em_adapt_torch.data.pipeline import SyntheticVOC, batch_iterator  # noqa: E402
from em_adapt_torch.eval.miou import (  # noqa: E402
    ConfusionAccumulator,
    confusion_matrix,
    miou_from_confusion,
)
from em_adapt_torch.eval.predict import Evaluator  # noqa: E402
from em_adapt_torch.models.deeplab import DeepLabLargeFOV  # noqa: E402
from em_adapt_torch.ops import block1 as k2  # noqa: E402
from em_adapt_tpu.data.pipeline import SyntheticVOC as JaxSynth  # noqa: E402
from em_adapt_tpu.data.pipeline import batch_iterator as jax_batches  # noqa: E402
from em_adapt_tpu.models import DeepLabLargeFOV as JaxDeepLab  # noqa: E402

torch.set_num_threads(2)

TINY = dict(num_classes=5, input_size=(33, 33), fc6_channels=32, width_multiplier=0.125,
            init_scheme="he")


def _shared(kw, seed):
    jmodel = JaxDeepLab(jcfg.ModelConfig(**kw))
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.key(seed)))
    return jmodel, params


@pytest.mark.parametrize("block1_impl", ["xla", "pallas"])
def test_bf16_logits_match_jax_apply(block1_impl):
    """bf16 compute with shared weights, within the JAX package's own bf16
    bound (tests/test_block1_pallas.py::test_bfloat16_path: rtol = atol
    = 0.05); the JAX side runs its Pallas kernel in interpret mode."""
    kw = dict(TINY, compute_dtype="bfloat16", block1_impl=block1_impl)
    jmodel, params = _shared(kw, seed=3)
    x = np.random.default_rng(3).normal(size=(2, 33, 33, 3)).astype(np.float32) * 40
    with warnings.catch_warnings():
        # On a multi-device CPU backend the JAX package warns that its
        # kernel runs unsharded; the result is the same.
        warnings.simplefilter("ignore", UserWarning)
        want = np.asarray(jmodel.apply(jax.tree.map(jnp.asarray, params), jnp.asarray(x)))
    model = DeepLabLargeFOV(pcfg.ModelConfig(**kw)).load_params(params).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == want.shape == (2, 5, 5, 5)
    np.testing.assert_allclose(got.numpy(), want, rtol=0.05, atol=0.05)
    # The bf16 path really is bf16: it differs from the f32 forward.
    f32 = DeepLabLargeFOV(pcfg.ModelConfig(**TINY)).load_params(params).eval()
    with torch.no_grad():
        assert not torch.equal(got, f32(torch.from_numpy(x)))


def test_pallas_and_conv_block1_agree_in_the_model():
    """block1_impl "pallas" (bias added before the bf16 rounding) against
    "xla" (a bf16 bias added after it) in one bf16 model: JAX's bound
    rtol = atol = 0.05, and no K2 launch on the CPU."""
    _, params = _shared(TINY, seed=4)
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(2, 33, 33, 3)).astype(np.float32) * 40)
    out = {}
    before = k2.launches
    for impl in ("xla", "pallas"):
        cfg = pcfg.ModelConfig(**TINY, compute_dtype="bfloat16", block1_impl=impl)
        with torch.no_grad():
            out[impl] = DeepLabLargeFOV(cfg).load_params(params).eval()(x)
    assert k2.launches == before
    np.testing.assert_allclose(out["pallas"].numpy(), out["xla"].numpy(), rtol=0.05, atol=0.05)


def test_confusion_and_miou_equal_jax():
    from em_adapt_tpu.eval.miou import ConfusionAccumulator as JaxAcc
    from em_adapt_tpu.eval.miou import confusion_matrix as jax_cm
    from em_adapt_tpu.eval.miou import miou_from_confusion as jax_miou

    g = np.random.default_rng(0)
    jacc, acc = JaxAcc(6), ConfusionAccumulator(6)
    for shape in ((2, 9, 9), (3, 17, 5), (1, 33, 33)):
        pred = g.integers(-1, 8, size=shape)  # out-of-range predictions too
        gt = np.where(g.uniform(size=shape) < 0.2, 255, g.integers(0, 6, size=shape))
        want = np.asarray(jax_cm(jnp.asarray(pred), jnp.asarray(gt), 6))
        got = confusion_matrix(torch.from_numpy(pred), torch.from_numpy(gt).float(), 6)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want)
        jacc.update(jnp.asarray(pred), jnp.asarray(gt))
        acc.update(torch.from_numpy(pred), torch.from_numpy(gt))
    np.testing.assert_array_equal(acc.matrix(), jacc.matrix())
    (m, iou), (jm, jiou) = acc.result(), jacc.result()
    assert m == jm
    np.testing.assert_array_equal(np.nan_to_num(iou, nan=-1), np.nan_to_num(jiou, nan=-1))
    cm = np.array([[3, 1, 0], [0, 4, 0], [0, 0, 0]])
    assert miou_from_confusion(cm)[0] == jax_miou(cm)[0] == pytest.approx((0.75 + 0.8) / 2)
    assert ConfusionAccumulator(3).matrix().sum() == 0


@pytest.mark.parametrize("wire", ["float32", "uint8"])
def test_eval_batches_bit_identical_to_jax(wire):
    """train=False: dataset order, preprocess_eval, the tail padded with
    zero images, all-void labels and "__pad__" ids."""
    kw = dict(input_size=(33, 33), wire_dtype=wire)
    got = list(batch_iterator(SyntheticVOC(5, 21, seed=2), pcfg.DataConfig(**kw),
                              batch_size=2, epochs=1, train=False, num_workers=2))
    want = list(jax_batches(JaxSynth(5, 21, seed=2, category="val"), jcfg.DataConfig(**kw),
                            batch_size=2, epochs=1, train=False, drop_remainder=False,
                            pad_remainder=True, num_workers=2))
    assert len(got) == len(want) == 3
    assert got[-1]["id"] == ["synth_000004", "__pad__"]
    assert (got[-1]["label"][1] == 255).all() and not got[-1]["image"][1].any()
    for a, b in zip(got, want):
        assert a["id"] == b["id"]
        for k in ("image", "label"):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_evaluate_fixed_matches_jax_evaluator():
    """f32, shared weights and data: the same confusion matrix to the
    count as the JAX Evaluator's, and the same mIoU."""
    from em_adapt_tpu.eval.predict import Evaluator as JaxEvaluator

    kw = dict(TINY, num_classes=4)
    jmodel, params = _shared(kw, seed=5)
    data = dict(input_size=(33, 33), num_workers=2)
    jc = jcfg.ExperimentConfig(model=jcfg.ModelConfig(**kw), data=jcfg.DataConfig(**data),
                               eval=jcfg.EvalConfig(batch_size=2))
    pc = pcfg.ExperimentConfig(model=pcfg.ModelConfig(**kw), data=pcfg.DataConfig(**data),
                               eval=pcfg.EvalConfig(batch_size=2))

    def batches():
        return batch_iterator(SyntheticVOC(5, 4, seed=1), pc.data, batch_size=2, epochs=1,
                              train=False)

    jbatches = jax_batches(JaxSynth(5, 4, seed=1, category="val"), jc.data, batch_size=2,
                           epochs=1, train=False, drop_remainder=False, pad_remainder=True)
    want = JaxEvaluator(jc, jmodel).confusion_fixed(jax.tree.map(jnp.asarray, params), jbatches)
    ev = Evaluator(pc, DeepLabLargeFOV(pc.model).load_params(params))
    got = ev.confusion_fixed(batches())
    assert got.dtype == np.int64 and got.sum() > 0
    np.testing.assert_array_equal(got, want)
    miou, _ = ev.evaluate_fixed(batches())
    assert miou == miou_from_confusion(want)[0]
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        ev.evaluate_voc(SyntheticVOC(2, 4))


def test_eval_mode_accepts_bf16_and_pallas_training_does_not():
    """Both modes accept bf16 with the fused block1 now that it has its
    backward (K3); the CRF still waits for its item."""
    cfg = pcfg.apply_overrides(pcfg.ExperimentConfig(), ["model.compute_dtype=bfloat16",
                                                         "model.block1_impl=pallas"])
    pcfg.check_supported(cfg, "eval")
    pcfg.check_supported(cfg, "train")
    crf = pcfg.apply_overrides(pcfg.ExperimentConfig(), ["eval.use_crf=true"])
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        pcfg.check_supported(crf, "eval")
    port, ref = pcfg.EvalConfig(), jcfg.EvalConfig()
    assert (port.batch_size, port.use_crf) == (ref.batch_size, ref.use_crf)


def test_eval_cli_on_cpu(capsys, tmp_path):
    from em_adapt_torch.__main__ import main

    args = ["eval", "--synthetic", "5", "--fixed-size", "--device", "cpu",
            "model.width_multiplier=0.125", "model.fc6_channels=8", "model.num_classes=4",
            "model.input_size=(33, 33)", "eval.batch_size=2", "data.num_workers=1",
            "model.compute_dtype=bfloat16", "model.block1_impl=pallas", "model.init_scheme=he",
            f"checkpoint.save_dir={tmp_path}"]
    assert main(args) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "warning: no checkpoint found; evaluating fresh init"
    assert [line.split("]")[0] for line in out[1:5]] == [
        "  IoU[background", "  IoU[aeroplane", "  IoU[bicycle", "  IoU[bird"]
    miou = float(out[-1].removeprefix("mIoU = "))
    assert 0.0 <= miou <= 1.0
    for flag, item in (("--crf", "item 7"), ("--int8", "item 9")):
        with pytest.raises(NotImplementedError, match=item):
            main(args + [flag])
    with pytest.raises(NotImplementedError, match="item 7"):
        main([a for a in args if a != "--fixed-size"])
