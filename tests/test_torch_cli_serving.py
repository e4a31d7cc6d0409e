"""PyTorch port: the serving commands ``predict``, ``export``, ``import-tf``
and ``info`` (``em_adapt_torch/__main__.py``) on the miniature VOC tree of
``tests/test_e2e_voc.py``, against the JAX package's CLI
(``em_adapt_tpu/cli.py``), and the model registry."""

import os
import tomllib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
Image = pytest.importorskip("PIL.Image")

from em_adapt_torch.__main__ import main  # noqa: E402
from em_adapt_torch.config import ModelConfig  # noqa: E402
from em_adapt_torch.models import registry  # noqa: E402
from em_adapt_torch.models.deeplab import DeepLabLargeFOV, build_model  # noqa: E402
from tests.test_e2e_voc import voc_tree  # noqa: E402, F401  the miniature VOC tree

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["model.num_classes=21", "model.input_size=(33,33)", "model.fc6_channels=8",
         "model.width_multiplier=0.125"]


def _images(main_dir, n):
    return [str(main_dir / "JPEGImages" / f"2012_val{i:03d}.jpg") for i in range(n)]


def _lines(out: str) -> list[str]:
    return [ln for ln in out.splitlines() if " -> " in ln]


def test_predict_one_image(voc_tree, tmp_path, capsys):  # noqa: F811
    _, main_dir = voc_tree
    (img,) = _images(main_dir, 1)
    out = tmp_path / "preds"
    assert main(["predict", img, "--out", str(out), "--overlay", "--device", "cpu", *SMALL,
                 f"checkpoint.save_dir={tmp_path / 'nock'}"]) == 0
    printed = capsys.readouterr().out
    assert "warning: no checkpoint found; predicting with fresh init" in printed
    mask = Image.open(out / "2012_val000.png")
    assert mask.mode == "P" and mask.size == Image.open(img).size
    assert Image.open(out / "2012_val000_overlay.png").size == mask.size
    assert [ln.split(" -> ")[0] for ln in _lines(printed)] == [img]


def test_predict_batches_many_images_with_a_padded_tail(voc_tree, tmp_path, capsys):  # noqa: F811
    """eval.batch_size=2 over 3 images: a full chunk and a padded tail;
    every mask at its own image's size, the lines in input order, and each
    mask the one the image gets alone."""
    _, main_dir = voc_tree
    imgs = _images(main_dir, 3)
    out, alone = tmp_path / "batched", tmp_path / "alone"
    nock = f"checkpoint.save_dir={tmp_path / 'nock'}"
    assert main(["predict", *imgs, "--out", str(out), "--device", "cpu", *SMALL,
                 "eval.batch_size=2", nock]) == 0
    assert [ln.split(" -> ")[0] for ln in _lines(capsys.readouterr().out)] == imgs
    assert main(["predict", imgs[2], "--out", str(alone), "--device", "cpu", *SMALL,
                 "eval.batch_size=1", nock]) == 0
    for i, img in enumerate(imgs):
        mask = Image.open(out / f"2012_val{i:03d}.png")
        assert mask.mode == "P" and mask.size == Image.open(img).size
    np.testing.assert_array_equal(np.asarray(Image.open(out / "2012_val002.png")),
                                  np.asarray(Image.open(alone / "2012_val002.png")))


def _write_scaled_checkpoint(prefix, seed=0):
    """A reference TF1 Saver checkpoint at SMALL's widths with He-scaled
    weights (finite, well-separated logits)."""
    tf = pytest.importorskip("tensorflow", reason="TensorFlow writes the TF1 checkpoint")
    from em_adapt_tpu.config import ModelConfig as JaxModelConfig
    from em_adapt_tpu.models.deeplab import layer_specs

    cfg = JaxModelConfig(num_classes=21, input_size=(33, 33), fc6_channels=8,
                         width_multiplier=0.125)
    rng = np.random.default_rng(seed)
    tf1 = tf.compat.v1
    with tf.Graph().as_default():
        trainable = []
        for name, kh, kw, cin, cout, _ in layer_specs(cfg):
            w = (rng.normal(size=(kh, kw, cin, cout)) * np.sqrt(2.0 / (kh * kw * cin)))
            b = rng.normal(size=(cout,)) * 0.1
            for suffix, v in (("weights", w.astype(np.float32)), ("bias", b.astype(np.float32))):
                trainable.append(tf1.get_variable(name=f"{name}_{suffix}", shape=v.shape,
                                                  initializer=tf1.constant_initializer(v)))
        saver = tf1.train.Saver(var_list=trainable)
        with tf1.Session() as sess:
            sess.run(tf1.global_variables_initializer())
            return saver.save(sess, str(prefix), global_step=24000)


def test_predict_parity_with_jax_from_one_imported_tf_checkpoint(voc_tree, tmp_path, capsys):  # noqa: F811
    """One TF1 checkpoint imported by both packages' import-tf; both
    packages' predict write the same masks from it."""
    from em_adapt_tpu import cli as jax_cli

    _, main_dir = voc_tree
    imgs = _images(main_dir, 3)
    prefix = _write_scaled_checkpoint(tmp_path / "tf" / "norm")
    assert main(["import-tf", prefix, "--out", str(tmp_path / "port_ck"), "--device", "cpu",
                 *SMALL]) == 0
    assert jax_cli.main(["import-tf", prefix, "--out", str(tmp_path / "jax_ck"),
                         "--config", *SMALL]) == 0
    assert main(["predict", *imgs, "--out", str(tmp_path / "port"), "--checkpoint",
                 str(tmp_path / "port_ck"), "--device", "cpu", *SMALL, "eval.batch_size=2"]) == 0
    assert jax_cli.main(["predict", *imgs, "--out", str(tmp_path / "jax"), "--checkpoint",
                         str(tmp_path / "jax_ck"), "--config", *SMALL, "eval.batch_size=2"]) == 0
    printed = capsys.readouterr().out
    assert "predicting with checkpoint step 0" in printed
    for i in range(3):
        name = f"2012_val{i:03d}.png"
        port, ref = Image.open(tmp_path / "port" / name), Image.open(tmp_path / "jax" / name)
        assert port.mode == ref.mode == "P"
        assert port.getpalette() == ref.getpalette()
        np.testing.assert_array_equal(np.asarray(port), np.asarray(ref))
    assert len(np.unique(np.asarray(Image.open(tmp_path / "port" / "2012_val000.png")))) > 1


def test_export_cli_pt2_and_npy(tmp_path, capsys):
    """``export`` writes a program whose labels are the live model's, and
    an init.npy holding every layer of the checkpoint; ``--batch-size``
    fixes the program's batch."""
    from em_adapt_torch import config as pcfg
    from em_adapt_torch.eval.export import load_predict_fn
    from em_adapt_torch.models.convert import to_jax_params
    from em_adapt_torch.models.deeplab import load_caffe_init

    cfg = pcfg.apply_overrides(pcfg.ExperimentConfig(), SMALL)
    nock = f"checkpoint.save_dir={tmp_path / 'nock'}"
    pt2, npy = str(tmp_path / "p.pt2"), str(tmp_path / "w.npy")
    assert main(["export", "--out", pt2, "--batch-size", "3", "--device", "cpu", *SMALL,
                 nock]) == 0
    assert main(["export", "--out", npy, "--format", "npy", "--device", "cpu", *SMALL,
                 nock]) == 0
    assert "exporting fresh init" in capsys.readouterr().out
    live = build_model(cfg.model, cfg.train.seed, torch.device("cpu")).eval()
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(3, 33, 33, 3)).astype(np.float32)
                         * 50)
    with open(pt2, "rb") as f:
        _, labels = load_predict_fn(f.read())(x)
    with torch.no_grad():
        np.testing.assert_array_equal(labels.numpy(), live.predict(x)[1].numpy())
    loaded, want = load_caffe_init(npy), to_jax_params(live)
    for layer in want:
        np.testing.assert_array_equal(loaded[layer]["w"], want[layer]["w"])


def test_info_prints_versions_and_config(capsys):
    assert main(["info"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("em-adapt-torch ")
    assert f"torch {torch.__version__}" in out
    assert "model.name = deeplab_largefov" in out
    if not torch.cuda.is_available():
        assert "card: no CUDA device" in out


@pytest.mark.parametrize("command", [["predict", "x.jpg", "--out", "o"], ["export", "--out", "o"]])
def test_int8_raises_with_item_9(command, tmp_path, monkeypatch, capsys):
    """``--int8`` is ported (ROADMAP item 9a): it raises no
    NotImplementedError any more, only the JAX CLI's errors: ``predict``
    on an image that is not there; ``export --format npy`` with
    ``--int8`` or ``--calib-images`` exits 2 and writes nothing."""
    monkeypatch.chdir(tmp_path)
    if command[0] == "predict":
        with pytest.raises(FileNotFoundError):
            main([*command, "--int8", "--device", "cpu", *SMALL])
        return
    for extra in (["--int8"], ["--calib-images", "a.png"]):
        assert main([*command, "--format", "npy", *extra, "--device", "cpu", *SMALL]) == 2
        assert "apply only to --format pt2" in capsys.readouterr().err
    assert os.listdir(tmp_path) == []


def test_eval_int8_synthetic(tmp_path, capsys):
    """``eval --int8`` calibrates on the first eval batch and scores the
    int8 model by both protocols."""
    nock = f"checkpoint.save_dir={tmp_path / 'nock'}"
    for protocol in (["--fixed-size"], []):
        assert main(["eval", "--synthetic", "3", *protocol, "--int8", "--device", "cpu", *SMALL,
                     "eval.batch_size=2", nock]) == 0
        out = capsys.readouterr().out
        assert "int8 PTQ: calibrated on 2 images" in out
        miou = float(out.strip().splitlines()[-1].split("=")[1])
        assert 0.0 <= miou <= 1.0


def test_predict_int8_on_pngs(tmp_path, capsys, monkeypatch):
    """``predict --int8`` calibrates on the inputs (each decoded once) and
    writes a mask per image at its size."""
    g = np.random.default_rng(5)
    imgs = []
    for i, (w, h) in enumerate(((40, 30), (25, 47), (33, 33))):
        imgs.append(str(tmp_path / f"im{i}.png"))
        Image.fromarray(g.integers(0, 256, size=(h, w, 3), dtype=np.uint8)).save(imgs[-1])
    opened = []
    real_open = Image.open
    monkeypatch.setattr(Image, "open", lambda p, *a, **k: opened.append(str(p)) or real_open(
        p, *a, **k))
    out = tmp_path / "masks"
    assert main(["predict", *imgs, "--out", str(out), "--int8", "--device", "cpu", *SMALL,
                 "eval.batch_size=2", f"checkpoint.save_dir={tmp_path / 'nock'}"]) == 0
    printed = capsys.readouterr().out
    assert "int8 PTQ: calibrated on 3 input images" in printed
    assert [ln.split(" -> ")[0] for ln in _lines(printed)] == imgs
    assert sorted(opened) == sorted(imgs)
    for img in imgs:
        mask = Image.open(out / (os.path.basename(img)[:-4] + ".png"))
        assert mask.mode == "P" and mask.size == Image.open(img).size


@pytest.mark.parametrize("with_images", [False, True])
def test_export_int8_program_labels_as_the_live_int8_model(with_images, tmp_path, capsys):
    """``export --int8`` (with ``--calib-images`` or on 8 random uint8
    images): the program loads and labels as the live quantized model
    calibrated on the same images, and holds no K2 node."""
    import io

    from em_adapt_torch import config as pcfg
    from em_adapt_torch.data.augment import preprocess_eval
    from em_adapt_torch.eval.export import BLOCK1_OP, load_predict_fn
    from em_adapt_torch.eval.quantize import quantize_model

    cfg = pcfg.apply_overrides(pcfg.ExperimentConfig(), SMALL)
    g = np.random.default_rng(6)
    raws = [g.integers(0, 256, size=(50, 40, 3), dtype=np.uint8) for _ in range(2)]
    calib_args = []
    if with_images:
        for i, raw in enumerate(raws):
            calib_args.append(str(tmp_path / f"c{i}.png"))
            Image.fromarray(raw).save(calib_args[-1])
        calib = np.stack([preprocess_eval(r, None, input_size=(33, 33))[0] for r in raws])
    else:
        calib = np.random.default_rng(0).integers(0, 256, size=(8, 33, 33, 3), dtype=np.uint8)
    pt2 = str(tmp_path / "q.pt2")
    argv = ["export", "--out", pt2, "--int8", "--batch-size", "2", "--device", "cpu"]
    if calib_args:
        argv += ["--calib-images", *calib_args]
    assert main([*argv, *SMALL, f"checkpoint.save_dir={tmp_path / 'nock'}"]) == 0
    out = capsys.readouterr().out
    assert ("warning: --int8 without --calib-images" in out) != with_images
    live = quantize_model(cfg.model, build_model(cfg.model, cfg.train.seed, torch.device("cpu")),
                          [calib])
    x = torch.from_numpy(np.random.default_rng(7).normal(size=(2, 33, 33, 3)).astype(np.float32)
                         * 50)
    with open(pt2, "rb") as f:
        blob = f.read()
    _, labels = load_predict_fn(blob)(x)
    with torch.no_grad():
        np.testing.assert_array_equal(labels.numpy(), live.predict(x)[1].numpy())
    ep = torch.export.load(io.BytesIO(blob))
    assert BLOCK1_OP not in [str(n.target) for n in ep.graph.nodes]


@pytest.mark.parametrize("command", [
    ["predict", "x.jpg", "--out", "o"], ["export", "--out", "o"], ["import-tf", "p", "--out", "o"]])
def test_serving_commands_run_on_the_card_by_default(command, tmp_path, monkeypatch):
    """Without --device they ask for the card: here, with none, they raise
    before reading or writing anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    monkeypatch.chdir(tmp_path)
    if command[0] == "import-tf":
        from em_adapt_torch.models import tf_import

        monkeypatch.setattr(tf_import, "load_tf_checkpoint_params", lambda prefix, cfg: {})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(command)
    assert os.listdir(tmp_path) == []


def test_registry_unknown_name_matches_jax():
    from em_adapt_tpu.models import registry as jax_registry

    assert registry.get_model("deeplab_largefov") is DeepLabLargeFOV
    with pytest.raises(KeyError) as port_err:
        registry.get_model("segformer")
    with pytest.raises(KeyError) as jax_err:
        jax_registry.get_model("segformer")
    # The same message, each package naming the architectures it has (the
    # port's include DeepLab-v2 ResNet-101, which the JAX package lacks).
    jax_names, port_names = sorted(jax_registry._REGISTRY), sorted(registry._REGISTRY)
    assert port_names == sorted([*jax_names, "deeplab_v2_resnet101"])
    assert str(port_err.value) == str(jax_err.value).replace(str(jax_names), str(port_names))
    with pytest.raises(KeyError, match="unknown model 'segformer'"):
        build_model(ModelConfig(name="segformer"), 0, torch.device("cpu"))


def test_registered_model_is_what_build_model_builds(monkeypatch):
    monkeypatch.setattr(registry, "_REGISTRY", dict(registry._REGISTRY))

    @registry.register_model("narrow")
    class Narrow(DeepLabLargeFOV):
        pass

    cfg = ModelConfig(name="narrow", width_multiplier=0.125, fc6_channels=8, input_size=(33, 33))
    assert type(build_model(cfg, 0, torch.device("cpu"))) is Narrow


def test_console_script_names_the_port_main():
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    module, func = scripts["em-adapt-torch"].split(":")
    assert (module, func) == ("em_adapt_torch.__main__", "main")
    assert scripts["em-adapt"] == "em_adapt_tpu.cli:main"


@pytest.mark.parametrize("argv", [
    ["predict", "a.jpg", "b.jpg", "--out", "o", "--device", "cpu", "model.fc6_channels=8",
     "eval.batch_size=2"],
    ["predict", "a.jpg", "b.jpg", "model.fc6_channels=8", "eval.batch_size=2", "--out", "o"],
    ["predict", "a.jpg", "--out", "o", "b.jpg", "model.fc6_channels=8", "eval.batch_size=2"],
])
def test_predict_splits_images_from_overrides(argv, monkeypatch):
    """Images and overrides are told apart by their form, wherever the
    options stand between them."""
    import em_adapt_torch.__main__ as cli

    seen = {}
    monkeypatch.setattr(cli, "cmd_predict", lambda args: seen.update(vars(args)) or 0)
    assert cli.main(argv) == 0
    assert seen["inputs"] == ["a.jpg", "b.jpg"]
    assert seen["overrides"] == ["model.fc6_channels=8", "eval.batch_size=2"]


def test_unrecognized_arguments_still_fail():
    with pytest.raises(SystemExit):
        main(["info", "stray"])
    with pytest.raises(SystemExit, match="no image"):
        main(["predict", "model.fc6_channels=8", "--out", "o", "--device", "cpu"])


def test_eval_checkpoint_evaluates_that_checkpoint(tmp_path, capsys):
    """``eval --checkpoint DIR`` scores DIR's latest "norm" (not the default
    ``checkpoint.save_dir``, which is empty here), ``DIR:TAG`` that tag's,
    as ``em_adapt_tpu/cli.py``'s ``eval --checkpoint``; the mIoU is that
    of the checkpoint's parameters, not of a fresh init."""
    small = [*SMALL, "model.num_classes=4", "eval.batch_size=2"]
    ck, empty = tmp_path / "ck", tmp_path / "empty"
    assert main(["train", "--synthetic", "4", "--steps", "2", "--device", "cpu", *small,
                 "train.batch_size=2", "optim.accum_steps=1", "data.num_workers=1",
                 "train.calibrate_estep=false", "optim.base_lr=0.5",
                 f"checkpoint.save_dir={ck}"]) == 0
    capsys.readouterr()
    common = ["eval", "--synthetic", "3", "--device", "cpu", *small, f"checkpoint.save_dir={empty}"]
    assert main([*common]) == 0
    fresh = capsys.readouterr().out
    assert "fresh init" in fresh
    assert main(["eval", "--checkpoint", str(ck), *common[1:]]) == 0
    trained = capsys.readouterr().out
    assert "evaluating checkpoint step 2" in trained
    assert main(["eval", "--checkpoint", f"{ck}:norm", *common[1:]]) == 0
    assert capsys.readouterr().out == trained
    assert main(["eval", "--checkpoint", f"{ck}:best", *common[1:]]) == 0
    assert "fresh init" in capsys.readouterr().out  # no "best" was saved
    miou = [ln for ln in trained.splitlines() if ln.startswith("mIoU")]
    assert miou and miou != [ln for ln in fresh.splitlines() if ln.startswith("mIoU")]
