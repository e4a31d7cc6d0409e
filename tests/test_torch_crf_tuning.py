"""PyTorch port: the CRF tuning tool (``em_adapt_torch/tools/crf_tuning.py``)
against the JAX package's (``tools/crf_tuning.py``), on the CPU.

The cached probabilities and the mIoU of a setting against the JAX
tool's functions on weights carried over by ``models/convert.py`` (four
``LearnableSyntheticVOC`` images of 33-65 pixels, a width-0.125 model);
the cache against ``Evaluator.confusion_voc`` itself; the two stages'
grids, the selection and the artifact's keys against the JAX tool's
``main`` with the network and the CRF stubbed on both sides; and the JAX
contracts (``tests/test_crf_tuning.py``) over the committed
``CRF_TUNING_TORCH.json``, measured on the card, with their thresholds."""

import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import em_adapt_tpu.config as jcfg  # noqa: E402
from em_adapt_torch import config as pcfg  # noqa: E402
from em_adapt_torch.data.pipeline import LearnableSyntheticVOC  # noqa: E402
from em_adapt_torch.eval.predict import Evaluator  # noqa: E402
from em_adapt_torch.models.deeplab import DeepLabLargeFOV  # noqa: E402
from em_adapt_torch.tools import crf_tuning as ct  # noqa: E402
from em_adapt_tpu.eval.predict import Evaluator as JaxEvaluator  # noqa: E402
from em_adapt_tpu.models import DeepLabLargeFOV as JaxDeepLab  # noqa: E402

from tools import crf_tuning as jct  # noqa: E402

torch.set_num_threads(2)

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")

MODEL = dict(num_classes=4, input_size=(33, 33), fc6_channels=8, width_multiplier=0.125,
             init_scheme="he")
#: JAX's tuned setting (CRF_TUNING.json) at 2 iterations, to keep it short.
SETTING = dict(crf_bi_sxy=16.0, crf_bi_srgb=5.0, crf_bi_compat=10.0, crf_g_sxy=1.0,
               crf_g_compat=3.0, crf_iterations=2)


class FourImages:
    """Four ``LearnableSyntheticVOC`` "val" images of 33, 45, 57 and 65
    pixels a side (seed 555, the tune stream's)."""

    sizes = (33, 45, 57, 65)

    def __len__(self):
        return len(self.sizes)

    def load_raw(self, i):
        return LearnableSyntheticVOC(n=i + 1, num_classes=4, seed=555, category="val",
                                     image_size=self.sizes[i]).load_raw(i)


@pytest.fixture(scope="module")
def shared():
    jc = jcfg.ExperimentConfig(model=jcfg.ModelConfig(**MODEL))
    pc = pcfg.ExperimentConfig(model=pcfg.ModelConfig(**MODEL),
                               eval=pcfg.EvalConfig(crf_workers=2))
    jmodel = JaxDeepLab(jc.model)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.key(7)))
    jev = JaxEvaluator(jc, jmodel)
    ev = Evaluator(pc, DeepLabLargeFOV(pc.model).load_params(params))
    want = jct._collect_probs(jev, jax.tree.map(jnp.asarray, params), FourImages(), jc)
    got = ct._collect_probs(ev, FourImages(), pc)
    return dict(pc=pc, ev=ev, want=want, got=got)


def test_collect_probs_match_jax(shared):
    """The cached probabilities within 1e-5 of the JAX tool's, each at its
    image's own size, with the same RGB and labels."""
    want, got = shared["want"], shared["got"]
    assert len(got) == len(want) == 4
    for (p, rgb, label), (jp, jrgb, jlabel), s in zip(got, want, FourImages.sizes):
        assert p.shape == (s, s, 4) and p.dtype == np.float32
        np.testing.assert_allclose(p, jp, atol=1e-5, rtol=0)
        np.testing.assert_array_equal(rgb, jrgb)
        np.testing.assert_array_equal(label, jlabel)


@pytest.mark.parametrize("setting", [None, SETTING], ids=["no-crf", "tuned"])
def test_miou_for_setting_matches_jax(shared, setting):
    """The mIoU of no CRF and of the tuned setting (host CRF, the lattice)
    over each tool's own cache equals the JAX tool's, class by class."""
    miou, iou = ct._miou_for_setting(
        shared["got"], None if setting is None else pcfg.EvalConfig(**setting), 4, workers=2)
    jmiou, jiou = jct._miou_for_setting(
        shared["want"], None if setting is None else jcfg.EvalConfig(**setting), 4)
    assert miou == jmiou
    np.testing.assert_array_equal(np.array(iou), np.array(jiou))


@pytest.mark.parametrize("setting", [None, SETTING], ids=["no-crf", "tuned"])
def test_cache_is_the_voc_protocols_path(shared, setting):
    """Scoring the cache equals ``Evaluator.evaluate_voc`` on the same
    images, without the CRF and with the setting's host CRF: the tuned
    setting transfers to the protocol the other tools measure by."""
    pc = shared["pc"]
    ev = shared["ev"]
    if setting is not None:
        ev = Evaluator(pc.replace(eval=dataclasses.replace(pc.eval, **setting)), ev.model)
    want, _ = ev.evaluate_voc(FourImages(), use_crf=setting is not None)
    got, _ = ct._miou_for_setting(
        shared["got"], None if setting is None else ev.cfg.eval, 4, workers=2)
    assert got == want


def _fake_miou(cached, eval_cfg, num_classes, workers=1):
    """A deterministic score of a setting, equal for both packages' configs."""
    if eval_cfg is None:
        return 0.4, [0.4] * num_classes
    key = (eval_cfg.crf_bi_sxy * 7 + eval_cfg.crf_bi_srgb * 13 + eval_cfg.crf_bi_compat * 17
           + eval_cfg.crf_g_sxy * 19 + eval_cfg.crf_g_compat * 23 + eval_cfg.crf_iterations * 29)
    v = 0.3 + 0.001 * (int(key * 10) % 97)
    return v, [v] * num_classes


class _Stub:
    def __init__(self, *a, **k):
        self.model = None
        self.params = None

    def init_state(self):
        return self

    def warm_start(self, state, *a, **k):
        return self


def test_grids_selection_and_artifact_match_jax(tmp_path, monkeypatch):
    """Both tools' ``main`` with the network and the CRF stubbed by the
    same scoring: the same 64 settings in the same order (stage A's 54,
    the VOC point among them, then stage B's 8 + 2 around A's best), the
    same best, measurement and verdict, and the JAX artifact's keys."""
    import em_adapt_tpu.eval.predict as jpredict
    import em_adapt_tpu.train as jtrain

    monkeypatch.setattr(jax.config, "update", lambda *a: None)
    monkeypatch.setattr(jtrain, "Trainer", _Stub)
    monkeypatch.setattr(jpredict, "Evaluator", _Stub)
    monkeypatch.setattr(jct, "_collect_probs", lambda *a: [])
    monkeypatch.setattr(jct, "_miou_for_setting", _fake_miou)
    jout = tmp_path / "jax.json"
    assert jct.main(["--checkpoint", "/x/ckpt:best", "--out", str(jout)]) == 0

    monkeypatch.setattr(ct, "load_model", lambda *a: (None, 7))
    monkeypatch.setattr(ct, "check_lattice", lambda device: None)
    monkeypatch.setattr(ct, "_collect_probs", lambda *a: [])
    monkeypatch.setattr(ct, "_miou_for_setting", _fake_miou)
    monkeypatch.setattr("em_adapt_torch.eval.predict.Evaluator", _Stub)
    pout = tmp_path / "port.json"
    assert ct.main(["--checkpoint", "/x/ckpt:best", "--device", "cpu", "--out",
                    str(pout)]) == 0
    want, got = json.loads(jout.read_text()), json.loads(pout.read_text())
    assert len(got["sweep"]) == 64
    for k in ("sweep", "best_setting", "best_tune_miou", "measurement", "positive_control",
              "pass", "seeds", "tune_images", "val_images", "input_size", "task",
              "tune_baseline_miou", "tune_baseline_per_class_iou"):
        assert got[k] == want[k], k
    assert set(want) - {"platform"} <= set(got)
    assert got["checkpoint"] == {"dir": "/x/ckpt", "tag": "best", "step": 7}
    assert got["platform"] == "cpu" and got["card"] is None
    assert [dict(s) for s in ct.stage_a_settings()][:3] == [
        {k: v for k, v in r.items() if k.startswith("crf_")} for r in want["sweep"][:3]]


def test_parse_checkpoint_matches_jax_rule():
    for spec, want in (("/a/ckpt", ("/a/ckpt", "best")), ("/a/ckpt:norm", ("/a/ckpt", "norm")),
                       ("/a:b/ckpt", ("/a:b/ckpt", "best")), ("c:lr", ("c", "lr"))):
        assert ct.parse_checkpoint(spec) == want


ART = os.path.join(REPO, "CRF_TUNING_TORCH.json")


@pytest.fixture(scope="module")
def art():
    if not os.path.exists(ART):
        pytest.skip("CRF_TUNING_TORCH.json not generated yet")
    with open(ART) as f:
        return json.load(f)


def test_streams_are_disjoint_by_construction(art):
    seeds = art["seeds"]
    assert len({seeds["selection"], seeds["tune"], seeds["measurement"]}) == 3
    assert art["card"]  # measured on the card, its name and power limit kept


def test_sweep_searched_domain_scales(art):
    sweep = art["sweep"]
    assert len(sweep) >= 50
    sxys = {r["crf_bi_sxy"] for r in sweep if "crf_bi_sxy" in r}
    assert min(sxys) <= 8.0 and 121.0 in sxys
    best = max(sweep, key=lambda r: r["tune_miou"])
    assert best["tune_miou"] == art["best_tune_miou"]
    for k, v in art["best_setting"].items():
        assert best[k] == v


def test_measurement_arm_is_consistent(art):
    m = art["measurement"]
    assert m["delta_tuned"] == pytest.approx(m["crf_tuned_miou"] - m["f32_miou"], abs=2e-4)
    assert m["delta_voc"] == pytest.approx(m["crf_voc_miou"] - m["f32_miou"], abs=2e-4)
    assert art["positive_control"] == (m["crf_tuned_miou"] > m["f32_miou"])


def test_tuned_beats_voc_transfer_on_measurement(art):
    m = art["measurement"]
    assert m["delta_tuned"] >= m["delta_voc"] - 1e-9


def test_artifact_passed_its_own_contracts(art):
    assert art["pass"] is True
    assert art["tune_baseline_miou"] >= 0.30
