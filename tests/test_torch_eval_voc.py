"""PyTorch port: the VOC protocol (``Evaluator.confusion_voc`` on the host
and with the CRF on the model's device), ``ConfusionAccumulator.
update_host``, and the command line's ``eval`` and periodic VOC eval, on
the CPU, against the JAX package on weights carried over by
``models/convert.py``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import em_adapt_tpu.config as jcfg  # noqa: E402
from em_adapt_torch import config as pcfg  # noqa: E402
from em_adapt_torch.data.augment import preprocess_eval, resize_bilinear_np  # noqa: E402
from em_adapt_torch.eval import predict as ppredict  # noqa: E402
from em_adapt_torch.eval.crf import dense_crf  # noqa: E402
from em_adapt_torch.eval.miou import ConfusionAccumulator  # noqa: E402
from em_adapt_torch.eval.predict import Evaluator  # noqa: E402
from em_adapt_torch.models.deeplab import DeepLabLargeFOV  # noqa: E402
from em_adapt_tpu.eval.predict import Evaluator as JaxEvaluator  # noqa: E402
from em_adapt_tpu.models import DeepLabLargeFOV as JaxDeepLab  # noqa: E402

torch.set_num_threads(2)

MODEL = dict(num_classes=4, input_size=(33, 33), fc6_channels=8, width_multiplier=0.125,
             init_scheme="he")


class TinyVOC:
    """Five small images of different sizes (the JAX tests' _TinyVOC and
    two more, so that a batch of 2 leaves a tail), labels with a void band."""

    sizes = [(40, 50), (33, 44), (48, 37), (45, 45), (30, 52)]

    def __len__(self):
        return len(self.sizes)

    def load_raw(self, i):
        h, w = self.sizes[i]
        g = np.random.default_rng(77 + i)
        img = g.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
        img[:, : w // 2] //= 3  # two colour regions, so the bilateral kernel has edges
        label = g.integers(0, 4, size=(h, w)).astype(np.uint8)
        label[: h // 8] = 255
        return img, label


@pytest.fixture(scope="module")
def shared():
    jmodel = JaxDeepLab(jcfg.ModelConfig(**MODEL))
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.key(7)))
    return jmodel, params


def _configs(**ev):
    return (jcfg.ExperimentConfig(model=jcfg.ModelConfig(**MODEL), eval=jcfg.EvalConfig(**ev)),
            pcfg.ExperimentConfig(model=pcfg.ModelConfig(**MODEL), eval=pcfg.EvalConfig(**ev)))


def _port(pc, params):
    return Evaluator(pc, DeepLabLargeFOV(pc.model).load_params(params))


@pytest.mark.parametrize("use_crf", [False, True])
def test_confusion_voc_equals_jax(shared, use_crf):
    """f32, shared weights: the host protocol's confusion matrix equals the
    JAX Evaluator's to the count, without the CRF and with the host CRF
    (the lattice, 2 iterations), tail batch included."""
    jmodel, params = shared
    jc, pc = _configs(crf_iterations=2, crf_workers=2)
    want = JaxEvaluator(jc, jmodel).confusion_voc(
        jax.tree.map(jnp.asarray, params), TinyVOC(), use_crf=use_crf, batch_size=2)
    got = _port(pc, params).confusion_voc(TinyVOC(), use_crf=use_crf, batch_size=2)
    assert got.dtype == np.int64
    nonvoid = sum(int((TinyVOC().load_raw(i)[1] < 4).sum()) for i in range(5))
    assert got.sum() == nonvoid
    np.testing.assert_array_equal(got, want)


def test_update_host_equals_jax():
    from em_adapt_tpu.eval.miou import ConfusionAccumulator as JaxAcc

    g = np.random.default_rng(0)
    jacc, acc = JaxAcc(6), ConfusionAccumulator(6)
    for shape in ((9, 9), (17, 5), (33, 34)):
        pred = g.integers(-1, 8, size=shape)
        gt = np.where(g.uniform(size=shape) < 0.2, 255, g.integers(0, 6, size=shape))
        jacc.update_host(pred, gt.astype(np.uint8))
        acc.update_host(pred, gt.astype(np.uint8))
    np.testing.assert_array_equal(acc.matrix(), jacc.matrix())
    # The device part and the host part sum into one total.
    acc.update(torch.from_numpy(pred), torch.from_numpy(gt))
    jacc.update(jnp.asarray(pred), jnp.asarray(gt))
    np.testing.assert_array_equal(acc.matrix(), jacc.matrix())


def _host_grid_labels(ev, raw_img, iterations):
    img, _ = preprocess_eval(raw_img, None, input_size=ev.cfg.model.input_size)
    lg = ev.logits(img[None])[0].numpy()
    up = resize_bilinear_np(lg, raw_img.shape[:2])
    e = np.exp(up - up.max(-1, keepdims=True))
    return dense_crf(e / e.sum(-1, keepdims=True), raw_img, ev.cfg.eval,
                     num_iterations=iterations, method="grid").argmax(-1)


def test_device_path_agrees_with_the_host_grid_per_image(shared):
    """crf_impl="tpu" on the CPU: each image's labels from the batched
    post-process (bucket padding, the padded tail of size (1, 1)) agree
    with the host pipeline's grid CRF at >= 99.9% of pixels
    (tests/test_crf_tpu.py:200), and the protocol runs through it."""
    _, params = shared
    _, pc = _configs(crf_impl="tpu", crf_bucket=(48, 56), crf_buckets=(), crf_iterations=2,
                     use_crf=True)
    ev = _port(pc, params)
    ds = TinyVOC()
    raws = [ds.load_raw(i) for i in range(3)]
    imgs = np.stack([preprocess_eval(r[0], None, input_size=(33, 33))[0] for r in raws])
    logits = ev.logits(np.concatenate([imgs, np.zeros_like(imgs[:1])]))  # one padded row
    labels = ev.voc_post_device(logits, [r[0] for r in raws], (48, 56))
    assert labels.dtype == np.uint8 and labels.shape == (4, 48, 56)
    for i, (raw_img, _) in enumerate(raws):
        oh, ow = raw_img.shape[:2]
        agree = (labels[i, :oh, :ow] == _host_grid_labels(ev, raw_img, 2)).mean()
        assert agree >= 0.999, f"image {i}: agreement {agree}"
    cm = ev.confusion_voc(ds, batch_size=2)
    assert cm.sum() == sum(int((ds.load_raw(i)[1] < 4).sum()) for i in range(5))


def test_bucket_routing_and_the_oversize_error(shared, monkeypatch):
    """Images pad into the smallest bucket that holds them, the ceiling is
    used only when needed, a bucket larger than the ceiling is dropped,
    and the confusion matrix does not depend on the buckets (the masked
    CRF is padding-invariant)."""
    _, params = shared
    assert ppredict.crf_buckets(pcfg.EvalConfig()) == ((512, 512), [(384, 512), (512, 384),
                                                                    (512, 512)])
    ceiling, buckets = ppredict.crf_buckets(
        pcfg.EvalConfig(crf_bucket=(48, 56), crf_buckets=((40, 56), (56, 40), (400, 400))))
    assert buckets == [(40, 56), (56, 40), (48, 56)]
    assert ppredict.route(40, 50, ceiling, buckets) == (40, 56)
    assert ppredict.route(48, 37, ceiling, buckets) == (56, 40) != (48, 56)
    assert ppredict.route(45, 45, ceiling, buckets) == (48, 56)
    with pytest.raises(ValueError, match="exceeds eval.crf_bucket"):
        ppredict.route(50, 40, ceiling, buckets)  # (56, 40) would hold it: the ceiling decides
    seen = []
    real = Evaluator.voc_post_device

    def spy(self, logits, raw_imgs, bucket):
        seen.append((tuple(bucket), len(raw_imgs), logits.shape[0]))
        return real(self, logits, raw_imgs, bucket)

    monkeypatch.setattr(Evaluator, "voc_post_device", spy)
    results = {}
    for name, extra in (("buckets", ((40, 56), (56, 40), (400, 400))), ("one", ())):
        _, pc = _configs(crf_impl="tpu", crf_bucket=(48, 56), crf_buckets=extra,
                         crf_iterations=1, use_crf=True)
        seen.clear()
        results[name] = _port(pc, params).confusion_voc(TinyVOC(), batch_size=2)
        results[name + " seen"] = sorted(seen)
    # (40,50), (33,44), (30,52) -> (40,56): a full batch and a tail of one;
    # (48,37) -> (56,40); (45,45) -> the ceiling.
    assert results["buckets seen"] == [((40, 56), 1, 2), ((40, 56), 2, 2), ((48, 56), 1, 2),
                                       ((56, 40), 1, 2)]
    assert results["one seen"] == [((48, 56), 1, 2), ((48, 56), 2, 2), ((48, 56), 2, 2)]
    np.testing.assert_array_equal(results["buckets"], results["one"])
    _, small = _configs(crf_impl="tpu", crf_bucket=(16, 16), crf_iterations=1)
    with pytest.raises(ValueError, match="crf_bucket"):
        _port(small, params).confusion_voc(TinyVOC(), use_crf=True, batch_size=2)


def test_crf_impl_is_validated_eagerly(shared):
    """A typo in eval.crf_impl is refused with the JAX package's message
    by check_supported, so an Evaluator is never built to run it as the
    host CRF."""
    _, params = shared
    bad = pcfg.apply_overrides(pcfg.ExperimentConfig(), ["eval.crf_impl=device"])
    with pytest.raises(ValueError, match="eval.crf_impl must be 'host' or 'tpu', got 'device'"):
        pcfg.check_supported(bad, "eval")
    _, pc = _configs(crf_impl="TPU")
    with pytest.raises(ValueError, match="got 'TPU'"):
        _port(pc, params)


def test_host_crf_on_the_card_never_falls_back_to_the_grid(shared, monkeypatch):
    """Where the lattice does not build, the host CRF runs the grid with
    one worker on the CPU (the JAX package's rule) and raises for a model
    on the card."""
    from em_adapt_torch.eval import permutohedral

    _, params = shared
    _, pc = _configs(crf_iterations=1, crf_workers=3)
    monkeypatch.setattr(permutohedral, "available", lambda: False)
    workers = []
    real_pool = ppredict.ThreadPoolExecutor

    def pool(max_workers):
        workers.append(max_workers)
        return real_pool(max_workers=max_workers)

    monkeypatch.setattr(ppredict, "ThreadPoolExecutor", pool)
    ev = _port(pc, params)
    assert ev.confusion_voc(TinyVOC(), use_crf=True, batch_size=2).sum() > 0
    assert workers == [1]
    ev.device = torch.device("cuda", 0)
    with pytest.raises(RuntimeError, match="lattice did not build"):
        ev.confusion_voc(TinyVOC(), use_crf=True, batch_size=2)


CLI = ["--synthetic", "2", "--device", "cpu", "model.width_multiplier=0.125",
       "model.fc6_channels=8", "model.num_classes=4", "model.input_size=(33, 33)",
       "eval.batch_size=2", "model.init_scheme=he", "eval.crf_iterations=1"]


@pytest.mark.parametrize("extra,crf", [((), False), (("--crf",), True),
                                       (("--crf", "eval.crf_impl=tpu"), True),
                                       (("eval.use_crf=true",), True)])
def test_eval_cli_runs_the_voc_protocol(capsys, tmp_path, extra, crf):
    """``eval`` without --fixed-size: per-class IoU lines and "mIoU = ..."
    with " (with CRF)" when --crf or eval.use_crf turns the CRF on."""
    from em_adapt_torch.__main__ import main

    flags = [a for a in extra if a.startswith("--")]
    overrides = [a for a in extra if not a.startswith("--")]
    assert main(["eval", *flags, *CLI, *overrides, f"checkpoint.save_dir={tmp_path}"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "warning: no checkpoint found; evaluating fresh init"
    assert len(out) == 1 + 4 + 1 and out[1].startswith("  IoU[background] = ")
    assert out[-1].startswith("mIoU = ") and out[-1].endswith(" (with CRF)") == crf
    assert 0.0 <= float(out[-1].split()[2]) <= 1.0


def test_train_runs_its_periodic_eval_by_the_voc_protocol(tmp_path, monkeypatch):
    """``train train.eval_protocol=voc``: the periodic eval goes through
    Evaluator.confusion_voc on the validation images."""
    import json

    from em_adapt_torch.__main__ import main

    calls = []
    real = Evaluator.confusion_voc

    def spy(self, dataset, **kw):
        calls.append(len(dataset))
        return real(self, dataset, **kw)

    monkeypatch.setattr(Evaluator, "confusion_voc", spy)
    log = tmp_path / "log.jsonl"
    assert main(["train", "--synthetic", "4", "--steps", "2", "--device", "cpu",
                 "--synthetic-val", "2", "--log-jsonl", str(log), "model.width_multiplier=0.125",
                 "model.fc6_channels=8", "model.input_size=(33, 33)", "train.batch_size=2",
                 "train.eval_every_steps=2", "train.eval_protocol=voc",
                 "train.calibrate_estep=false", "data.num_workers=1", "eval.batch_size=2",
                 f"checkpoint.save_dir={tmp_path}"]) == 0
    assert calls == [2]
    evals = [r for r in map(json.loads, log.read_text().splitlines()) if "val_metric" in r]
    assert len(evals) == 1 and 0.0 <= evals[0]["val_metric"] <= 1.0


def test_card_crf_in_chunks_equals_the_whole_batch(shared, monkeypatch):
    """``voc_post_device`` refines a bucket batch in chunks of images when
    their grids exceed ``CRF_GRID_BYTES``: a budget of one image's grid
    (chunks of 1) gives the labels of the whole batch at once, bit for bit
    (each image's grid cells are its own); the padding row is not refined."""
    jmodel, params = shared
    _, pc = _configs(crf_iterations=2, crf_impl="tpu", crf_bucket=(65, 65), crf_buckets=())
    ev = _port(pc, params)
    raws = [TinyVOC().load_raw(i)[0] for i in range(3)]
    logits = ev.logits(np.stack([preprocess_eval(r, None, input_size=(33, 33))[0]
                                 for r in raws] + [np.zeros((33, 33, 3), np.float32)]))
    whole = ev.voc_post_device(logits, raws, (65, 65))
    from em_adapt_torch.eval.crf_device import grid_cells

    from em_adapt_torch.eval import crf_device

    calls = []
    refine = crf_device.crf_refine

    def spy(probs, *a, **k):
        calls.append(probs.shape[0])
        return refine(probs, *a, **k)

    monkeypatch.setattr(crf_device, "crf_refine", spy)
    monkeypatch.setattr(ppredict, "CRF_GRID_BYTES", grid_cells(65, 65, pc.eval) * 5 * 4)
    chunked = ev.voc_post_device(logits, raws, (65, 65))
    assert calls == [1, 1, 1]
    assert chunked.shape == whole.shape == (4, 65, 65)
    np.testing.assert_array_equal(chunked, whole)
