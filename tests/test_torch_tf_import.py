"""PyTorch port: importing reference TF1 ``tf.train.Saver`` checkpoints
(``em_adapt_torch/models/tf_import.py`` and ``import-tf``), against the JAX
package's importer on the same checkpoint (``tests/test_tf_import.py``'s
four cases). The checkpoint is written in the reference's on-disk form by
that file's writer; TensorFlow is the writer and the reader, and the
module skips without it."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
tf = pytest.importorskip("tensorflow", reason="TensorFlow writes and reads the TF1 checkpoints")

from em_adapt_torch import config as pcfg  # noqa: E402
from em_adapt_torch.models.tf_import import load_tf_checkpoint_params, params_l2  # noqa: E402
from em_adapt_tpu.models import tf_import as jax_tf_import  # noqa: E402
from tests.test_tf_import import TINY as JAX_TINY  # noqa: E402
from tests.test_tf_import import _write_reference_checkpoint  # noqa: E402

torch.set_num_threads(2)

TINY = pcfg.ModelConfig(num_classes=4, input_size=(33, 33), fc6_channels=8)
ARCH = ["model.num_classes=4", "model.input_size=(33,33)", "model.fc6_channels=8"]


@pytest.fixture(scope="module")
def ref_ckpt(tmp_path_factory):
    root = tmp_path_factory.mktemp("tf_saver")
    return _write_reference_checkpoint(root / "norm", JAX_TINY)


def test_load_tf_checkpoint_params_roundtrips_and_equals_jax(ref_ckpt):
    """The port's params equal the TF variables and the JAX package's
    import of the same checkpoint, bit for bit; params_l2 equals JAX's."""
    weights, prefix = ref_ckpt
    params = load_tf_checkpoint_params(prefix, TINY)
    jparams = jax_tf_import.load_tf_checkpoint_params(prefix, JAX_TINY)
    assert set(params) == set(weights) == set(jparams)
    for name in weights:
        for k in ("w", "b"):
            assert params[name][k].dtype == np.float32
            np.testing.assert_array_equal(params[name][k], weights[name][k])
            np.testing.assert_array_equal(params[name][k], jparams[name][k])
    assert params_l2(params) == jax_tf_import.params_l2(jparams)
    assert params_l2(params) == pytest.approx(
        sum(float((v["w"] ** 2).sum() + (v["b"] ** 2).sum()) for v in weights.values()), rel=1e-6)


def test_load_tf_checkpoint_rejects_wrong_architecture(ref_ckpt):
    _, prefix = ref_ckpt
    with pytest.raises(ValueError, match="fc8_weights.*num_classes") as port_err:
        load_tf_checkpoint_params(prefix, pcfg.ModelConfig(num_classes=7, input_size=(33, 33),
                                                           fc6_channels=8))
    with pytest.raises(ValueError) as jax_err:
        jax_tf_import.load_tf_checkpoint_params(
            prefix, jax_tf_import.ModelConfig(num_classes=7, input_size=(33, 33), fc6_channels=8))
    assert str(port_err.value) == str(jax_err.value)
    with pytest.raises(ValueError, match="fc6_weights.*fc6_channels"):
        load_tf_checkpoint_params(prefix, pcfg.ModelConfig(num_classes=4, input_size=(33, 33),
                                                           fc6_channels=16))


def test_load_tf_checkpoint_rejects_non_reference_checkpoint(tmp_path):
    """A checkpoint without a reference variable raises KeyError naming it,
    with the JAX package's message."""
    tf1 = tf.compat.v1
    with tf.Graph().as_default():
        v = tf1.get_variable(name="conv1_1_weights", initializer=tf1.constant_initializer(0.0),
                             shape=(3, 3, 3, 64))
        saver = tf1.train.Saver(var_list=[v])
        with tf1.Session() as sess:
            sess.run(tf1.global_variables_initializer())
            prefix = saver.save(sess, str(tmp_path / "partial"))
    with pytest.raises(KeyError, match="conv1_1_bias") as port_err:
        load_tf_checkpoint_params(prefix, TINY)
    with pytest.raises(KeyError) as jax_err:
        jax_tf_import.load_tf_checkpoint_params(prefix, JAX_TINY)
    assert str(port_err.value) == str(jax_err.value)


def test_import_tf_cli_roundtrip_into_eval_and_predict(ref_ckpt, tmp_path, capsys):
    """``import-tf`` writes a port checkpoint ("norm", step 0, fresh
    optimizer) whose params equal the TF variables; ``train --warm-start``'s
    machinery, ``eval`` and ``predict`` load it."""
    from PIL import Image

    from em_adapt_torch.__main__ import main
    from em_adapt_torch.models.convert import to_jax_params
    from em_adapt_torch.train.checkpoint import CheckpointManager
    from em_adapt_torch.train.trainer import Trainer

    weights, prefix = ref_ckpt
    out = tmp_path / "imported"
    assert main(["import-tf", prefix, "--out", str(out), "--device", "cpu", *ARCH]) == 0
    printed = capsys.readouterr().out
    assert "weight L2 before the import" in printed
    assert f"weight L2 after the import: {params_l2(weights):.6f}" in printed

    saved = CheckpointManager(pcfg.CheckpointConfig(save_dir=str(out))).load("norm")
    assert saved["step"] == 0 and saved["optimizer"]["mini_step"] == 0
    assert all(m is None for m in saved["optimizer"]["momentum"])  # no update made yet

    cfg = pcfg.apply_overrides(pcfg.ExperimentConfig(), [*ARCH, "train.batch_size=2",
                                                         f"checkpoint.save_dir={tmp_path / 'u'}"])
    trainer = Trainer(cfg, device="cpu", steps_per_epoch=2)
    state = trainer.warm_start(trainer.init_state(), str(out))
    got = to_jax_params(state.model)
    for name in weights:
        np.testing.assert_array_equal(got[name]["w"], weights[name]["w"])
        np.testing.assert_array_equal(got[name]["b"], weights[name]["b"])
    assert state.step == 0

    assert main(["eval", "--synthetic", "2", "--fixed-size", "--device", "cpu", *ARCH,
                 "eval.batch_size=2", f"checkpoint.save_dir={out}"]) == 0
    assert "evaluating checkpoint step 0" in capsys.readouterr().out
    img = tmp_path / "a.jpg"
    Image.fromarray(np.random.default_rng(0).integers(0, 256, (40, 50, 3), np.uint8)).save(img)
    assert main(["predict", str(img), "--out", str(tmp_path / "masks"), "--checkpoint", str(out),
                 "--device", "cpu", *ARCH]) == 0
    assert "predicting with checkpoint step 0" in capsys.readouterr().out
    assert Image.open(tmp_path / "masks" / "a.png").size == (50, 40)
