"""PyTorch port: the accuracy-cost tool (``em_adapt_torch/tools/accuracy_cost.py``)
against the JAX package's (``tools/accuracy_cost.py``), on the CPU.

``_interval`` and the calibration batch against the JAX tool's; the
``f32``, ``int8`` and ``crf_host`` arms' mIoU against the JAX package's
``evaluate_voc`` on weights carried over by ``models/convert.py`` (four
``LearnableSyntheticVOC`` images of 33-65 pixels, a width-0.125 model);
the arms, streams, statistics and verdict of ``main`` against the JAX
tool's with the evaluators stubbed by one scoring on both sides; and the
JAX contracts (``tests/test_accuracy_cost.py``) over the committed
``ACCURACY_COST_TORCH.json`` and ``ACCURACY_COST_TORCH_PRIOR.json``,
measured on the card, with their thresholds."""

import json
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import em_adapt_tpu.config as jcfg  # noqa: E402
from em_adapt_torch import config as pcfg  # noqa: E402
from em_adapt_torch.models.deeplab import DeepLabLargeFOV  # noqa: E402
from em_adapt_torch.tools import accuracy_cost as ac  # noqa: E402
from em_adapt_torch.tools import crf_tuning as ct  # noqa: E402
from em_adapt_tpu.eval.predict import Evaluator as JaxEvaluator  # noqa: E402
from em_adapt_tpu.models import DeepLabLargeFOV as JaxDeepLab  # noqa: E402

from tools import accuracy_cost as jac  # noqa: E402

torch.set_num_threads(2)

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")

MODEL = dict(num_classes=4, input_size=(33, 33), fc6_channels=8, width_multiplier=0.125,
             init_scheme="he")


class FourImages:
    """Four ``LearnableSyntheticVOC`` "val" images of 33, 45, 57 and 65
    pixels a side (seed 777, the first measurement stream's)."""

    sizes = (33, 45, 57, 65)

    def __len__(self):
        return len(self.sizes)

    def load_raw(self, i):
        from em_adapt_torch.data.pipeline import LearnableSyntheticVOC

        return LearnableSyntheticVOC(n=i + 1, num_classes=4, seed=777, category="val",
                                     image_size=self.sizes[i]).load_raw(i)


@pytest.mark.parametrize("values", [[0.5], [0.01, -0.02], [0.0152, 0.0148, 0.021, 0.009, 0.013],
                                    [-0.003, 0.0, 0.001, -0.001, 0.002, 0.0, -0.004, 0.003, 0.0]])
def test_interval_matches_jax(values):
    assert ac._interval(values) == jac._interval(values)
    assert ac._T975 == jac._T975


@pytest.fixture(scope="module")
def shared():
    """A small model's weights in both packages and the calibration batch
    of the port's tool at 33x33 (the JAX tool's draw: 8 images of seed
    778 through the eval pipeline)."""
    from em_adapt_tpu.data.pipeline import LearnableSyntheticVOC as JaxLearnable
    from em_adapt_tpu.data.pipeline import batch_iterator as jax_batches

    jc = jcfg.ExperimentConfig(model=jcfg.ModelConfig(**MODEL),
                               data=jcfg.DataConfig(input_size=(33, 33), num_workers=2),
                               eval=jcfg.EvalConfig(crf_iterations=2))
    pc = pcfg.ExperimentConfig(model=pcfg.ModelConfig(**MODEL),
                               data=pcfg.DataConfig(input_size=(33, 33), num_workers=2),
                               eval=pcfg.EvalConfig(crf_iterations=2, crf_workers=2))
    jmodel = JaxDeepLab(jc.model)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.key(7)))
    calib = ac.calibration_batch(pc)
    want = next(iter(jax_batches(JaxLearnable(n=8, num_classes=4, seed=778, category="val",
                                              image_size=33),
                                 jc.data, batch_size=8, seed=0, epochs=1, train=False)))["image"]
    arms = ac.build_arms(pc, DeepLabLargeFOV(pc.model).load_params(params), calib)
    return dict(jc=jc, jmodel=jmodel, params=params, calib=calib, want_calib=want, arms=arms)


def test_calibration_batch_matches_jax(shared):
    assert shared["calib"].shape == (8, 33, 33, 3)
    np.testing.assert_array_equal(shared["calib"], shared["want_calib"])


def test_arms_are_the_jax_tools_in_order(shared):
    assert list(shared["arms"]) == ["f32", "int8", "crf_host", "crf_tpu"]
    tuned = ac.build_arms(pcfg.ExperimentConfig(model=pcfg.ModelConfig(**MODEL)),
                          DeepLabLargeFOV(pcfg.ModelConfig(**MODEL)), shared["calib"],
                          dict(crf_bi_sxy=16.0))
    assert list(tuned) == ["f32", "int8", "crf_host", "crf_tpu", "crf_tuned",
                           "int8_crf_tuned", "crf_tuned_tpu"]


@pytest.mark.parametrize("arm", ["f32", "int8", "crf_host"])
def test_arm_miou_matches_jax_evaluate_voc(shared, arm):
    """The arm's mIoU and per-class IoU equal the JAX tool's arm: f32 and
    int8 (``quantize_model`` on the calibration batch) without the CRF,
    and the host CRF (the lattice, 2 iterations)."""
    from em_adapt_tpu.eval.quantize import quantize_model

    jc, params = shared["jc"], jax.tree.map(jnp.asarray, shared["params"])
    model = shared["jmodel"]
    if arm == "int8":
        model, params = quantize_model(jc.model, params, [shared["want_calib"]])
    want, want_iou = JaxEvaluator(jc, model).evaluate_voc(params, FourImages(),
                                                          use_crf=arm == "crf_host")
    got, got_iou = shared["arms"][arm](FourImages())
    assert got == want
    np.testing.assert_array_equal(got_iou, want_iou)


def test_crf_tpu_arm_runs_the_device_crf(shared, monkeypatch):
    """``crf_tpu`` refines on the model's device (``crf_device.crf_refine``,
    here the CPU), and scores within 0.02 of the host arm (the JAX
    contract's per-stream bound) on these images."""
    from em_adapt_torch.eval import crf_device

    calls = []
    real = crf_device.crf_refine

    def spy(*a, **k):
        calls.append(a[0].device.type)
        return real(*a, **k)

    monkeypatch.setattr(crf_device, "crf_refine", spy)
    got, _ = shared["arms"]["crf_tpu"](FourImages())
    assert calls and set(calls) == {"cpu"}
    host, _ = shared["arms"]["crf_host"](FourImages())
    assert abs(got - host) <= 0.02


def _score(impl: str, eval_cfg, use_crf: bool, quantized: bool, seed: int) -> float:
    """One deterministic mIoU per (arm, stream) for both tools' stubs."""
    v = 0.33 + 0.004 * (seed % 11) + (-0.003 if quantized else 0.0)
    if use_crf:
        v += -0.01 if eval_cfg.crf_bi_sxy == 121.0 else 0.012
        v += 0.002 if impl == "tpu" else 0.0
    return v


class _JaxEv:
    def __init__(self, cfg, model):
        self.cfg, self.model = cfg, model

    def evaluate_voc(self, params, ds, use_crf):
        v = _score(self.cfg.eval.crf_impl, self.cfg.eval, use_crf, self.model == "Q", ds.seed)
        return v, np.full(4, v)


class _PortEv:
    def __init__(self, cfg, model):
        self.cfg, self.model = cfg, model

    def evaluate_voc(self, ds, use_crf):
        v = _score(self.cfg.eval.crf_impl, self.cfg.eval, use_crf, self.model == "Q", ds.seed)
        return v, np.full(4, v)


class _Trainer:
    def __init__(self, *a, **k):
        self.model = "M"
        self.params = "P"

    def init_state(self):
        return self

    def warm_start(self, state, *a, **k):
        return self


@pytest.mark.parametrize("streams", [1, 5])
def test_main_matches_jax_with_stubbed_evaluators(tmp_path, monkeypatch, streams):
    """Both tools' ``main`` with the evaluators replaced by one scoring of
    (arm, stream): the same arms per stream, deltas, interval statistics,
    first-stream arms and verdict, with the tuned arms from one tuning
    file."""
    import em_adapt_tpu.eval.predict as jpredict
    import em_adapt_tpu.eval.quantize as jquant
    import em_adapt_tpu.train as jtrain
    from em_adapt_torch.eval import predict as ppredict
    from em_adapt_torch.eval import quantize as pquant

    tuning = tmp_path / "tuning.json"
    tuning.write_text(json.dumps({"best_setting": {"crf_bi_sxy": 16.0, "crf_bi_srgb": 5.0}}))
    monkeypatch.setattr(jax.config, "update", lambda *a: None)
    monkeypatch.setattr(jtrain, "Trainer", _Trainer)
    monkeypatch.setattr(jpredict, "Evaluator", _JaxEv)
    monkeypatch.setattr(jquant, "quantize_model", lambda cfg, params, calib: ("Q", "QP"))
    jout = tmp_path / "jax.json"
    jrc = jac.main(["--checkpoint", "/x/ckpt:best", "--streams", str(streams), "--tuning",
                    str(tuning), "--out", str(jout)])

    monkeypatch.setattr(ac, "load_model", lambda *a: ("M", 7))
    monkeypatch.setattr(ac, "check_lattice", lambda device: None)
    monkeypatch.setattr(ppredict, "Evaluator", _PortEv)
    monkeypatch.setattr(pquant, "quantize_model", lambda cfg, model, calib: "Q")
    pout = tmp_path / "port.json"
    prc = ac.main(["--checkpoint", "/x/ckpt:best", "--streams", str(streams), "--tuning",
                   str(tuning), "--device", "cpu", "--out", str(pout)])
    assert prc == jrc
    want, got = json.loads(jout.read_text()), json.loads(pout.read_text())

    def strip(arms):
        return {k: {kk: vv for kk, vv in v.items() if kk != "elapsed_sec"}
                for k, v in arms.items()}

    assert strip(got["arms"]) == strip(want["arms"])
    for s, w in zip(got["per_stream"], want["per_stream"], strict=True):
        assert (s["seed"], s["deltas"]) == (w["seed"], w["deltas"])
        assert strip(s["arms"]) == strip(w["arms"])
    for k in ("deltas_vs_f32", "f32_miou_stats", "delta_stats", "pass", "seeds", "streams",
              "val_images", "input_size", "task"):
        assert got[k] == want[k], k
    assert set(want) - {"platform"} <= set(got)
    assert got["checkpoint"] == {"dir": "/x/ckpt", "tag": "best", "step": 7}
    assert got["card"] is None and got["platform"] == "cpu"
    assert list(got)[-1] == "pass"


def test_main_trains_the_prior_without_a_checkpoint(tmp_path, monkeypatch):
    """No ``--checkpoint``: the rehearsal prior (``run_rehearsal(steps=2500,
    seed=0, refine_steps=0)``) is trained into ``--workdir``/prior and
    its "best" is measured."""
    from em_adapt_torch.tools import convergence_rehearsal as cr

    seen = {}
    monkeypatch.setattr(cr, "run_rehearsal", lambda **kw: seen.update(kw))
    monkeypatch.setattr(ac, "load_model",
                        lambda cfg, d, tag, device: seen.update(ckpt=(d, tag)) or ("M", 1))
    monkeypatch.setattr(ac, "build_arms", lambda *a: {"stop": None})
    monkeypatch.setattr(ac, "calibration_batch", lambda cfg: None)
    monkeypatch.setattr(ac, "measure", lambda *a: (_ for _ in ()).throw(StopIteration("ok")))
    with pytest.raises(StopIteration):
        ac.main(["--device", "cpu", "--workdir", str(tmp_path), "--tuning", ""])
    prior = os.path.join(str(tmp_path), "prior")
    assert seen["ckpt"] == (prior, "best")
    assert (seen["steps"], seen["seed"], seen["refine_steps"], seen["save_dir"]) == (
        2500, 0, 0, prior)
    assert ct.PRIOR_STEPS == 2500


ARTIFACTS = ("ACCURACY_COST_TORCH.json", "ACCURACY_COST_TORCH_PRIOR.json")


@pytest.fixture(scope="module", params=ARTIFACTS)
def art(request):
    path = os.path.join(REPO, request.param)
    if not os.path.exists(path):
        pytest.skip(f"{request.param} not generated yet")
    with open(path) as f:
        return json.load(f)


def test_baseline_is_a_trained_model(art):
    assert art["card"]  # measured on the card, its name and power limit kept
    assert art["pass"] is True
    assert art["arms"]["f32"]["miou"] >= 0.30


def test_int8_accuracy_cost_is_bounded(art):
    assert art["deltas_vs_f32"]["int8"] >= -0.02


def test_crf_impls_agree_and_effect_is_recorded(art):
    for s in art["per_stream"]:
        assert abs(s["arms"]["crf_host"]["miou"] - s["arms"]["crf_tpu"]["miou"]) <= 0.02, s
    assert abs(art["delta_stats"]["crf_host"]["mean"]
               - art["delta_stats"]["crf_tpu"]["mean"]) <= 0.015
    assert "crf_host" in art["deltas_vs_f32"]
    assert "crf_tpu" in art["deltas_vs_f32"]


def test_tuned_crf_is_a_positive_control(art):
    tuned = art["delta_stats"]["crf_tuned"]
    assert tuned["mean"] > 0
    assert tuned["mean"] - tuned["ci95_half"] > 0
    for s in art["per_stream"]:
        assert s["deltas"]["crf_tuned"] > s["deltas"]["crf_host"], s


def test_deltas_carry_interval_stats(art):
    assert art["streams"] >= 5
    assert len(set(art["seeds"])) == art["streams"]
    for arm, stats in art["delta_stats"].items():
        values = [s["deltas"][arm] for s in art["per_stream"]]
        assert stats["values"] == values
        n = len(values)
        mean = sum(values) / n
        assert stats["mean"] == pytest.approx(mean, abs=2e-4)
        var = sum((v - mean) ** 2 for v in values) / (n - 1)
        assert stats["std"] == pytest.approx(math.sqrt(var), abs=2e-4)
        assert stats["ci95_half"] is not None and stats["ci95_half"] >= 0
    assert min(art["f32_miou_stats"]["values"]) >= 0.30
    int8 = art["delta_stats"]["int8"]
    assert int8["mean"] - int8["ci95_half"] >= -0.02


def test_composed_serving_stack_keeps_the_crf_lift(art):
    combo = art["delta_stats"]["int8_crf_tuned"]
    assert combo["mean"] > 0
    assert combo["mean"] - combo["ci95_half"] > 0
    for s in art["per_stream"]:
        assert abs(s["deltas"]["int8_crf_tuned"] - s["deltas"]["crf_tuned"]) <= 0.005, s


def test_device_crf_delivers_the_tuned_lift(art):
    dev = art["delta_stats"]["crf_tuned_tpu"]
    assert dev["mean"] > 0
    assert dev["mean"] - dev["ci95_half"] > 0
    for s in art["per_stream"]:
        assert abs(s["deltas"]["crf_tuned_tpu"] - s["deltas"]["crf_tuned"]) <= 0.02, s
