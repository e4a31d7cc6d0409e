"""PyTorch port: the EM learning check against the JAX package.

``LearnableSyntheticVOC`` and its batches bit for bit; the rehearsal
tool's ``_aggregate``, its four pass contracts on each side of every
threshold, and ``main``'s calls in every mode against
``tools/convergence_rehearsal.py``'s; one EM step at the rehearsal's
configuration against JAX's step; both arms end to end on the CPU at a
toy size; and the committed ``*_TORCH.json`` artifacts from the card,
checked as ``tests/test_convergence.py`` checks the JAX package's."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import em_adapt_tpu.config as jcfg  # noqa: E402
import em_adapt_tpu.data.pipeline as jpipe  # noqa: E402
from em_adapt_torch import config as pcfg  # noqa: E402
from em_adapt_torch.data import pipeline as ppipe  # noqa: E402
from em_adapt_torch.tools import convergence_rehearsal as cr  # noqa: E402
from tools import convergence_rehearsal as jcr  # noqa: E402

torch.set_num_threads(4)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _artifact(name):
    path = os.path.join(REPO, name)
    assert os.path.exists(path), f"run em_adapt_torch/tools/convergence_rehearsal.py on the card"
    with open(path) as f:
        return json.load(f)


# --- (a) the dataset ------------------------------------------------------


@pytest.mark.parametrize("strong_fraction", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("image_size", [33, 65, 129])
@pytest.mark.parametrize("category", ["train", "val"])
@pytest.mark.parametrize("num_classes", [2, 4, 7])
def test_learnable_dataset_is_the_jax_packages(num_classes, category, image_size,
                                               strong_fraction):
    kw = dict(n=9, num_classes=num_classes, seed=3, category=category, image_size=image_size,
              strong_fraction=strong_fraction)
    got, want = ppipe.LearnableSyntheticVOC(**kw), jpipe.LearnableSyntheticVOC(**kw)
    assert got.ids == want.ids and len(got) == len(want) == 9
    np.testing.assert_array_equal(got.is_strong, want.is_strong)
    assert got.is_strong.dtype == want.is_strong.dtype
    for i in (0, 1, 4, 8):
        (gi, gl), (wi, wl) = got.load_raw(i), want.load_raw(i)
        assert gi.dtype == wi.dtype == np.uint8 and gl.dtype == wl.dtype == np.uint8
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)
        assert set(np.unique(gl)) <= set(range(num_classes)) and gl.max() > 0


def test_learnable_dataset_refuses_class_counts_it_has_no_colors_for():
    for c in (1, 8):
        with pytest.raises(ValueError, match="num_classes"):
            ppipe.LearnableSyntheticVOC(num_classes=c)


# --- (b) its batches --------------------------------------------------------


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("random_scale", [False, True])
def test_learnable_batches_match_jax(train, random_scale):
    kw = dict(input_size=(65, 65), num_workers=2, random_scale=random_scale)
    pc, jc = pcfg.DataConfig(**kw), jcfg.DataConfig(**kw)
    ds = dict(n=24, num_classes=4, seed=1, image_size=65, strong_fraction=0.25)
    got = ppipe.batch_iterator(ppipe.LearnableSyntheticVOC(**ds), pc, batch_size=8, seed=5,
                               epochs=None if train else 1, train=train)
    want = jpipe.batch_iterator(jpipe.LearnableSyntheticVOC(**ds), jc, batch_size=8, seed=5,
                                epochs=None if train else 1, train=train)
    for _ in range(3):
        g, w = next(got), next(want)
        assert g.keys() == w.keys() == {"image", "label", "id", "is_strong"}
        assert g["id"] == w["id"]
        for k in ("image", "label", "is_strong"):
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])
    got.close()
    want.close()


# --- (c) aggregation and the contracts ---------------------------------------


def _run(seed, peak, final, fg, step=1000):
    return {"seed": seed, "peak_miou": peak, "peak_step": step, "peak_mean_fg_iou": fg,
            "final_miou": final, "task": "t", "miou_curve": [(0, 0.19), (step, peak)]}


def test_aggregate_is_the_jax_tools():
    runs = [_run(0, 0.31, 0.30, 0.2), _run(1, 0.25, 0.22, 0.1, 4500),
            _run(2, 0.19, 0.18, 0.0), _run(3, 0.33, 0.32, 0.3, 3000),
            _run(4, 0.33, 0.31, 0.25)]
    assert cr._aggregate(runs) == jcr._aggregate(runs)
    assert cr._aggregate(runs)["seed"] == 3  # the first of equal peaks, as max() keeps


def _weak(peak=0.30, fg=0.2, final=0.29, seed_peaks=(0.30, 0.25, 0.24, 0.23, 0.1)):
    return {"peak_miou": peak, "peak_mean_fg_iou": fg, "final_miou": final,
            "seeds": [{"peak_miou": p} for p in seed_peaks]}


@pytest.mark.parametrize("result,want", [
    (_weak(), True),
    (_weak(peak=0.26, final=0.25), True),
    (_weak(peak=0.2599, final=0.25), False),
    (_weak(fg=0.15), True),
    (_weak(fg=0.1499), False),
    (_weak(peak=0.26, final=0.24), True),
    (_weak(peak=0.26, final=0.2399), False),
    (_weak(peak=0.30, final=0.2701), True),
    (_weak(peak=0.30, final=0.2699), False),
    (_weak(seed_peaks=(0.30, 0.23, 0.23, 0.23, 0.0)), True),
    (_weak(seed_peaks=(0.30, 0.23, 0.23, 0.2299, 0.0)), False),
    (_weak(seed_peaks=(0.30, 0.25, 0.25)), True),
    (_weak(seed_peaks=(0.30, 0.25, 0.1)), False),
], ids=["typical", "peak=0.26", "peak<0.26", "fg=0.15", "fg<0.15", "final=0.24", "final<0.24",
        "drop<0.03", "drop>0.03", "4of5", "3of5", "3of3", "2of3"])
def test_weak_contract(result, want):
    """l.526-536: ceil(0.8 n) seeds must peak at >= 0.23 (3 of 3, 4 of 5)."""
    assert cr.weak_contract(result) is want


@pytest.mark.parametrize("peak,want", [(0.2399, True), (0.24, False), (0.19, True)])
def test_ablation_contract(peak, want):
    assert cr.ablation_contract({"peak_miou": peak}) is want


@pytest.mark.parametrize("cold,prior,want", [
    ((0.19, 0.18, 0.2399), 0.26, True),
    ((0.19, 0.24, 0.10), 0.32, False),
    ((0.19, 0.18, 0.10), 0.2599, False),
], ids=["pass", "a cold arm at 0.24", "prior below 0.26"])
def test_fixed_contract(cold, prior, want):
    assert cr.fixed_contract([{"peak_miou": p} for p in cold], prior) is want


@pytest.mark.parametrize("final,want", [(0.5, True), (0.4999, False), (0.66, True)])
def test_supervised_contract(final, want):
    assert cr.supervised_contract({"final_miou": final}) is want


# --- main's calls against the JAX tool's ---------------------------------------


def _fake_run(calls, device_kw):
    """A stand-in for run_rehearsal: records its arguments and returns a
    result made from them, so both tools' aggregation sees equal runs."""
    def run(**kw):
        kw.pop("log")
        if device_kw:
            assert kw.pop("device") == "cpu"
        if kw.get("save_dir"):
            kw["save_dir"] = "PRIOR"
        if kw.get("warm_start_dir") and kw["warm_start_dir"] != "GIVEN":
            kw["warm_start_dir"] = "PRIOR"
        if kw.get("estep_method") == "fixed":
            kw.setdefault("fixed_bias_units", "logit")  # run_rehearsal's default
        calls.append(kw)
        h = (len(calls) * 37 + kw["seed"] * 11) % 17
        peak = round(0.15 + h / 100, 4)
        method = kw.get("estep_method", "adaptive")
        return {"task": "t", "seed": kw["seed"], "steps": kw["steps"], "peak_miou": peak,
                "peak_step": 100 * h, "peak_mean_fg_iou": round(h / 80, 4),
                "final_miou": round(peak - 0.01, 4), "per_class_iou": [0.5, h / 20, 0.1, 0.0],
                "estep_method": method,
                "fixed_biases": ([kw["fixed_bg_bias"], kw["fixed_fg_bias"]]
                                 if method == "fixed" else None),
                "fixed_bias_units": (kw.get("fixed_bias_units", "logit")
                                     if method == "fixed" else None)}
    return run


@pytest.mark.parametrize("argv", [
    ["--mode", "weak"],
    ["--mode", "weak", "--steps", "300", "--seed", "2", "--seeds", "3", "--lr-drop-epoch", "4",
     "--dropout", "1.0", "--random-scale", "--refine-steps", "0", "--tag-warmup", "100",
     "--tag-warmup-pool-r", "1.0", "--tag-warmup-lr", "1e-4"],
    ["--mode", "ablation"],
    ["--mode", "ablation", "--steps", "100", "--seeds", "2", "--refine-steps", "20"],
    ["--mode", "fixed"],
    ["--mode", "fixed", "--steps", "50", "--seed", "1", "--prior-steps", "60",
     "--fixed-bg-bias", "2", "--fixed-fg-bias", "4"],
    ["--mode", "fixed", "--prior-dir", "GIVEN"],
    ["--mode", "strong"],
    ["--mode", "strong", "--steps", "40", "--seed", "3"],
], ids=["weak", "weak-flags", "ablation", "ablation-flags", "fixed", "fixed-flags",
        "fixed-prior-dir", "strong", "strong-flags"])
def test_main_makes_the_jax_tools_runs_and_artifact(argv, tmp_path, monkeypatch, capsys):
    """Every mode and flag: the same run_rehearsal calls in the same
    order, the same artifact from the same runs, and the same exit code."""
    if "GIVEN" in argv:
        given = tmp_path / "given"
        given.mkdir()
        (given / "best_metric.json").write_text(json.dumps({"metric": 0.30123, "step": 9}))
        argv = [str(given) if a == "GIVEN" else a for a in argv]
    calls, jcalls = [], []
    monkeypatch.setattr(cr, "run_rehearsal", _fake_run(calls, True))
    monkeypatch.setattr(jcr, "run_rehearsal", _fake_run(jcalls, False))

    def supervised(calls, device_kw):
        def run(**kw):
            if device_kw:
                assert kw.pop("device") == "cpu"
            calls.append(kw)
            return {"steps": kw["steps"], "seed": kw["seed"], "final_miou": 0.45 + kw["seed"] / 40,
                    "pass": 0.45 + kw["seed"] / 40 >= 0.5}
        return run

    monkeypatch.setattr(cr, "run_supervised_rehearsal", supervised(calls, True))
    monkeypatch.setattr(jcr, "run_supervised_rehearsal", supervised(jcalls, False))
    monkeypatch.setattr(jax.config, "update", lambda *a: None)  # no compilation cache dir
    rc = cr.main([*argv, "--device", "cpu", "--out", str(tmp_path / "port.json")])
    jrc = jcr.main([*argv, "--out", str(tmp_path / "jax.json")])
    for c in calls + jcalls:
        if c.get("warm_start_dir") == str(tmp_path / "given"):
            c["warm_start_dir"] = "GIVEN"
    assert calls == jcalls and rc == jrc
    port, ref = (json.loads((tmp_path / f"{n}.json").read_text()) for n in ("port", "jax"))
    assert port == ref
    capsys.readouterr()


def test_main_writes_the_ports_own_artifacts_by_default(tmp_path, monkeypatch):
    """The default outputs never name a JAX artifact; a temporary prior tree
    is removed when the fixed mode ends."""
    monkeypatch.chdir(tmp_path)
    made = []
    real_mkdtemp = cr.tempfile.mkdtemp

    def mkdtemp(**kw):
        made.append(real_mkdtemp(**kw))
        return made[-1]

    monkeypatch.setattr(cr.tempfile, "mkdtemp", mkdtemp)
    monkeypatch.setattr(cr, "run_rehearsal", _fake_run([], True))
    monkeypatch.setattr(cr, "run_supervised_rehearsal",
                        lambda **kw: {"final_miou": 0.6, "pass": True})
    for mode in ("weak", "ablation", "fixed", "strong"):
        cr.main(["--mode", mode, "--device", "cpu"])
    assert sorted(os.listdir(tmp_path)) == [
        "CONVERGENCE_TORCH.json", "CONVERGENCE_TORCH_ABLATION.json",
        "CONVERGENCE_TORCH_FIXED.json", "SUPERVISED_TORCH.json"]
    assert made and not any(os.path.exists(d) for d in made)


# --- (d) one EM step at the rehearsal's configuration -------------------------


def test_rehearsal_em_step_matches_jax():
    """Full-width VGG, fc6 64, 4 classes, He init, keep 0.5, batch 8 of the
    learnable task, accumulation 1, lr 1e-3, with the input cut to 33x33:
    JAX's dropout masks and class orders injected. The loss within rtol
    1e-5; every parameter's move within 1e-3 of JAX's move (relative to
    the largest), plus 64 f32 ulps of the leaf's scale."""
    from em_adapt_torch.models.convert import to_jax_params
    from em_adapt_torch.models.deeplab import DeepLabLargeFOV
    from em_adapt_torch.train.optim import AccumulatingSGD
    from em_adapt_torch.train.trainer import TrainState, train_step
    from em_adapt_tpu.models import DeepLabLargeFOV as JaxDeepLab
    from em_adapt_tpu.ops.estep import make_class_orders as jax_orders
    from em_adapt_tpu.train.optim import build_optimizer
    from em_adapt_tpu.train.state import TrainState as JaxState
    from em_adapt_tpu.train.trainer import _step_fn

    hw, fc6 = 33, 64

    def build(mod):
        return mod.ExperimentConfig(
            model=mod.ModelConfig(num_classes=4, input_size=(hw, hw), fc6_channels=fc6,
                                  dropout_keep_prob=0.5, init_scheme="he"),
            estep=mod.EStepConfig(num_iter=5, bg_p=0.4, fg_p=0.2),
            optim=mod.OptimConfig(base_lr=1e-3, accum_steps=1, lr_schedule=()),
            data=mod.DataConfig(input_size=(hw, hw), num_workers=2, random_scale=False),
            train=mod.TrainConfig(batch_size=8))

    jc, pc = build(jcfg), build(pcfg)
    ds = ppipe.LearnableSyntheticVOC(n=16, num_classes=4, seed=0, image_size=hw)
    it = ppipe.batch_iterator(ds, pc.data, batch_size=8, seed=0)
    batch = {k: v for k, v in next(it).items() if k in ("image", "label")}
    it.close()
    assert len(np.unique(batch["label"])) > 2  # tags beyond the background

    jmodel = JaxDeepLab(jc.model)
    params = jmodel.init(jax.random.key(0))
    np_params = jax.tree.map(np.asarray, params)
    tx, _ = build_optimizer(jc.optim, 1)
    jstate = JaxState.create(params, tx, jax.random.key(1))
    rng = jax.random.split(jax.random.fold_in(jstate.rng, jstate.step))[0]
    drop_rng, order_rng = jax.random.split(rng)
    h = -(-hw // 8)
    masks = tuple(torch.from_numpy(np.array(jax.random.bernoulli(k, 0.5, (8, h, h, fc6))))
                  .permute(0, 3, 1, 2) for k in jax.random.split(drop_rng, 2))
    orders = torch.from_numpy(np.array(jax_orders(order_rng, 5, 4)))
    jstate, jmetrics = jax.jit(_step_fn(jmodel, jc, tx))(jstate,
                                                          jax.tree.map(jnp.asarray, batch))

    model = DeepLabLargeFOV(pc.model).load_params(np_params)
    names, tparams = zip(*model.named_parameters())
    state = TrainState(model, AccumulatingSGD(tparams, pc.optim, names=names), torch.Generator())
    metrics = train_step(state, {k: torch.from_numpy(v) for k, v in batch.items()}, pc,
                         orders=orders, masks=masks)
    np.testing.assert_allclose(metrics["loss"].item(), float(jmetrics["loss"]), rtol=1e-5)
    assert metrics["updated"]
    new, new_j = to_jax_params(model), jax.tree.map(np.asarray, jstate.params)
    for name in np_params:
        for k in ("w", "b"):
            d_port = new[name][k] - np_params[name][k]
            d_jax = new_j[name][k] - np_params[name][k]
            tol = 64 * np.finfo(np.float32).eps * np.abs(np_params[name][k]).max()
            np.testing.assert_allclose(d_port, d_jax, rtol=1e-3,
                                       atol=tol + 1e-3 * np.abs(d_jax).max(),
                                       err_msg=f"{name}.{k}")


# --- (e) both arms end to end on the CPU ---------------------------------------


@pytest.fixture
def toy(monkeypatch):
    """The tool at a toy size, by monkeypatching what it builds: VGG at
    width 0.125 and fc6 8, 16 training and 8 val images."""
    real_model, real_ds = cr.ModelConfig, cr.LearnableSyntheticVOC
    monkeypatch.setattr(cr, "ModelConfig", lambda **kw: real_model(
        **{**kw, "width_multiplier": 0.125, "fc6_channels": 8}))
    monkeypatch.setattr(cr, "LearnableSyntheticVOC", lambda n, **kw: real_ds(
        n=min(n, 16 if kw.get("category", "train") == "train" else 8), **kw))


def test_supervised_arm_runs_on_the_cpu(toy):
    result = cr.run_supervised_rehearsal(steps=3, size=33, device="cpu", log=lambda m: None)
    with open(os.path.join(REPO, "SUPERVISED.json")) as f:
        ref = json.load(f)
    assert set(result) == set(ref) | {"card"}
    assert result["card"] is None and result["steps"] == 3
    assert result["pass"] == cr.supervised_contract(result)
    assert len(result["per_class_iou"]) == 4


def test_weak_arm_runs_on_the_cpu_with_refine(toy, monkeypatch):
    """20 phase-1 steps (an eval every step), a 4-step refine from "best"
    (an eval every step), the temporary trees removed at the end."""
    made = []
    real_mkdtemp = cr.tempfile.mkdtemp
    monkeypatch.setattr(cr.tempfile, "mkdtemp",
                        lambda **kw: made.append(real_mkdtemp(**kw)) or made[-1])
    lines = []
    r = cr.run_rehearsal(steps=20, size=33, seed=1, refine_steps=4, device="cpu",
                         log=lines.append)
    with open(os.path.join(REPO, "CONVERGENCE.json")) as f:
        ref = json.load(f)
    assert set(r) == (set(ref) - {"seeds", "pass"}) | {"card"}
    assert r["platform"] == "cpu" and r["card"] is None and r["aborted_by_watchdog"] is None
    steps = [s for s, _ in r["miou_curve"]]
    assert steps == list(range(21)) + [21, 22, 23, 24, 24]
    assert r["peak_miou"] == max(m for _, m in r["miou_curve"])
    assert r["final_miou"] == r["miou_curve"][-1][1]
    assert r["final_iou_source"] == "final_state" and len(r["per_class_iou"]) == 4
    assert any("phase 2 (refine): 4 steps" in m for m in lines)
    assert len(made) == 2 and not any(os.path.exists(d) for d in made)


def test_watchdog_abort_is_recorded_not_raised(toy, monkeypatch):
    """A frozen loss stops phase 1: the run is recorded as aborted, the last
    periodic eval is its final, "best" stands in for the per-class IoU and
    no refine runs."""
    from em_adapt_torch.train import trainer as tr

    class Quick(tr.LossWatchdog):
        def __init__(self):
            super().__init__(patience=1)

        def check(self, loss):
            return super().check(1.0)

    monkeypatch.setattr(tr, "LossWatchdog", Quick)
    r = cr.run_rehearsal(steps=20, size=33, refine_steps=4, estep_iters=0,
                         suppress_others=False, device="cpu", log=lambda m: None)
    assert "training unhealthy" in r["aborted_by_watchdog"]
    assert r["final_iou_source"] == "best_checkpoint (watchdog abort)"
    assert max(s for s, _ in r["miou_curve"]) <= 20
    assert r["final_miou"] == r["miou_curve"][-1][1]


# --- (f) the committed artifacts from the card --------------------------------


def test_committed_torch_rehearsal_artifact_passes():
    r = _artifact("CONVERGENCE_TORCH.json")
    assert r["pass"] is True and r["pass"] == cr.weak_contract(r)
    assert r["dropout_keep_prob"] == 0.5
    assert r["peak_miou"] >= 0.26
    assert r["peak_mean_fg_iou"] >= 0.15
    assert r["final_miou"] >= 0.24
    assert r["final_miou"] >= r["peak_miou"] - 0.03
    assert r["final_miou"] > r["init_miou"]
    assert len(r["seeds"]) >= 5 and [s["seed"] for s in r["seeds"]] == [0, 1, 2, 3, 4]
    assert r["steps"] >= 4000
    locked = [s for s in r["seeds"] if s["peak_miou"] >= 0.23]
    assert len(locked) >= -(-4 * len(r["seeds"]) // 5)
    assert r["platform"] == "cuda" and "H100" in r["card"]


def test_committed_torch_ablation_artifact_shows_bias_drives_lift():
    a, r = _artifact("CONVERGENCE_TORCH_ABLATION.json"), _artifact("CONVERGENCE_TORCH.json")
    assert a["pass"] is True and a["pass"] == cr.ablation_contract(a)
    assert a["estep_num_iter"] == 0 and a["suppress_others"] is False
    assert [s["seed"] for s in a["seeds"]] == [0, 1, 2, 3, 4]
    assert a["peak_miou"] < 0.24
    assert r["peak_miou"] - a["peak_miou"] >= 0.04
    assert a["platform"] == "cuda" and "H100" in a["card"]


def test_committed_torch_em_fixed_artifact_shows_adaptive_bias_is_load_bearing():
    x, r = _artifact("CONVERGENCE_TORCH_FIXED.json"), _artifact("CONVERGENCE_TORCH.json")
    assert x["pass"] is True
    assert x["pass"] == cr.fixed_contract(x["bias_sweep"], x["prior"]["peak_miou"])
    assert x["estep_method"] == "fixed"
    assert len(x["bias_sweep"]) >= 3
    assert all(arm["peak_miou"] < 0.24 for arm in x["bias_sweep"])
    assert r["peak_miou"] - max(arm["peak_miou"] for arm in x["bias_sweep"]) >= 0.04
    assert x["prior"]["peak_miou"] >= 0.26
    assert len(x["warm_start_sweep"]) >= 3
    assert isinstance(x["warm_start_retains"], bool)
    if x["warm_start_retains"]:
        assert x["warm_start_best_final"] >= 0.23
    else:
        assert all(a["final_miou"] < 0.24 for a in x["warm_start_sweep"])
        assert "erodes" in x["warm_start_verdict"]
    assert x["aborted_by_watchdog"] is None
    assert x["platform"] == "cuda" and "H100" in x["card"]


def test_committed_torch_supervised_artifact_passes():
    r = _artifact("SUPERVISED_TORCH.json")
    assert r["pass"] is True and r["pass"] == cr.supervised_contract(r)
    assert r["final_miou"] >= 0.5
    assert r["final_miou"] > r["init_miou"] + 0.2
    assert "H100" in r["card"]


def test_committed_torch_em_fixed_spread_probe():
    x = _artifact("CONVERGENCE_TORCH_FIXED.json")
    sweep = x["warm_spread_sweep"]
    assert len(sweep) >= 4
    assert all(a["fixed_bias_units"] == "spread" for a in sweep)
    assert any(a["fixed_biases"][0] == a["fixed_biases"][1] for a in sweep)
    best_final = max(a["final_miou"] for a in sweep)
    assert x["warm_spread_best_final"] == best_final
    assert x["warm_spread_retains"] == (best_final >= max(0.23, x["prior"]["peak_miou"] - 0.08))


@pytest.mark.parametrize("flag", [[], ["--deterministic"]])
def test_deterministic_flag_sets_cudnn_before_the_runs(flag, tmp_path, monkeypatch):
    """``--deterministic`` on the rehearsal tool and on the probe sets
    cuDNN's deterministic algorithms with autotuning off before any run
    builds a model; without it the flags stay as they were."""
    from em_adapt_torch.tools import rehearsal_probe as rp

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", True)
    seen = []

    def flags():
        seen.append((torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark))

    monkeypatch.setattr(cr, "run_supervised_rehearsal",
                        lambda **kw: flags() or {"pass": True})
    monkeypatch.setattr(rp, "probe_seed", lambda *a, **kw: flags() or {
        "seed": 1, "estep_impl": "auto", "miou_curve": [], "seconds": 0.0})
    assert cr.main(["--mode", "strong", "--device", "cpu", *flag,
                    "--out", str(tmp_path / "s.json")]) == 0
    assert rp.main(["--seeds", "1", "--device", "cpu", *flag,
                    "--out", str(tmp_path / "p.json")]) == 0
    want = (True, False) if flag else (False, True)
    assert seen == [want, want]
    assert json.loads((tmp_path / "p.json").read_text())["deterministic"] is bool(flag)
