"""PyTorch port: the schedule rehearsal (``em_adapt_torch/tools/schedule_rehearsal.py``).

The JAX package's contracts (``tests/test_schedule.py``), recomputed from
the streams of the port's committed artifacts
(``SCHEDULE_REHEARSAL_TORCH*.json``, measured on the card) with their
thresholds; the tool's protocol and command line against the JAX tool's
(``tools/schedule_rehearsal.py``); and the tool's protocol at a miniature
size on the CPU: three processes of ``python -m em_adapt_torch train``,
three LR drops, a SIGTERM between the first and second, ``--resume``."""

import json
import os

import pytest

torch = pytest.importorskip("torch")

from em_adapt_torch.tools import schedule_rehearsal as sr  # noqa: E402

REPO = os.path.join(os.path.dirname(__file__), "..")
ARTIFACTS = ("SCHEDULE_REHEARSAL_TORCH.json", "SCHEDULE_REHEARSAL_TORCH_PERF.json",
             "SCHEDULE_REHEARSAL_TORCH_WEAK.json")
STAGES = (1e-3, 1e-4, 1e-5, 1e-6)


@pytest.fixture(scope="module", params=ARTIFACTS)
def art(request):
    path = os.path.join(REPO, request.param)
    if not os.path.exists(path):
        pytest.skip(f"{request.param} not generated yet")
    with open(path) as f:
        return json.load(f)


def test_run_shape_is_the_reference_schedule(art):
    spe = art["steps_per_epoch"]
    assert art["total_steps"] == 40 * spe
    assert art["lr_drop_steps"] == [10 * spe, 20 * spe, 30 * spe]
    assert art["norm_every"] and art["eval_every"] and art["log_every"]
    assert art["card"]  # measured on the card, its name and power limit kept


def test_resume_is_bitexact(art):
    control = dict(art["loss_stream_control"])
    preempt = dict(art["loss_stream_preempt"])
    common = set(control) & set(preempt)
    assert len(common) >= 30
    post = [s for s in common if int(s) > art["resume_step"]]
    assert len(post) >= 15, "no post-resume overlap recorded"
    for s in common:
        assert control[s] == preempt[s], (s, control[s], preempt[s])
    assert art["loss_mismatches"] == []


def _expected_lr(step, drops):
    return STAGES[sum(step > s for s in drops)]


def test_lr_snapshots_and_schedule(art):
    checks = art["checks"]
    drops = art["lr_drop_steps"]
    assert checks["lr_snapshots_control"] == drops
    assert checks["lr_snapshots_preempt"] == drops
    for lineage in ("control", "preempt"):
        stream = art[f"lr_stream_{lineage}"]
        assert len(stream) >= 30, lineage
        seen_stages = set()
        for step, lr in stream:
            assert lr == _expected_lr(step, drops), (lineage, step, lr)
            seen_stages.add(lr)
        assert seen_stages == set(STAGES), (lineage, seen_stages)


def _first_argmax(curve):
    best_step, best = curve[0]
    for step, v in curve[1:]:
        if v > best:
            best_step, best = step, v
    return best_step, best


def test_best_race_matches_val_peak(art):
    for lineage in ("control", "preempt"):
        side = art["checks"][f"best_sidecar_{lineage}"]
        step, val = _first_argmax(art[f"val_curve_{lineage}"])
        assert side["step"] == step, (lineage, side, step)
        assert side["metric"] == val, (lineage, side, val)
    c, p = art["checks"]["best_sidecar_control"], art["checks"]["best_sidecar_preempt"]
    assert (c["step"], c["metric"]) == (p["step"], p["metric"])


def test_norm_retention_and_learning(art):
    norm = art["checks"]["norm_steps_control"]
    assert len(norm) <= 2 and norm[-1] == art["total_steps"]
    peak = art["checks"]["peak_miou"]
    final = art["checks"]["final_miou"]
    assert peak >= 0.30
    assert final >= peak - 0.06


def test_weak_warmstart_regime_is_pure_weak():
    path = os.path.join(REPO, "SCHEDULE_REHEARSAL_TORCH_WEAK.json")
    if not os.path.exists(path):
        pytest.skip("run python -m em_adapt_torch.tools.schedule_rehearsal "
                    "--regime weak-warmstart")
    with open(path) as f:
        art = json.load(f)
    assert art["regime"] == "weak-warmstart"
    assert art["warm_start"] is not None and art["warm_start"]["dir"]
    assert "PURE-weak" in art["task"]
    first_step, first_val = art["val_curve_control"][0]
    assert first_val >= 0.25, (first_step, first_val)


def test_protocol_and_command_are_the_jax_tools():
    """The default protocol is the JAX tool's constants, and each arm's
    command sets what the JAX tool's sets, but ``train.macro_steps`` (a
    lever of the TPU's dispatch that the port accepts and does not use);
    the LR schedule it spells out is the config's default."""
    pytest.importorskip("jax")
    from em_adapt_torch import config as pcfg
    from tools import schedule_rehearsal as jsr

    p = sr.PROTOCOL
    assert (p.steps_per_epoch, p.total_steps, p.lr_drop_steps, p.lr_stages) == (
        jsr.STEPS_PER_EPOCH, jsr.TOTAL_STEPS, jsr.LR_DROP_STEPS, jsr.LR_STAGES)
    assert (p.norm_every, p.log_every, p.eval_every, p.preempt_after_step) == (
        jsr.NORM_EVERY, jsr.LOG_EVERY, jsr.EVAL_EVERY, jsr.PREEMPT_AFTER_STEP)
    for step in range(0, p.total_steps + 1, 8):
        assert p.expected_lr(step) == jsr.expected_lr(step)
    for knobs, jknobs in (((), ()), (sr.PERF_KNOBS, jsr.TPU_PERF_KNOBS)):
        port = sr.train_cmd(p, "D", "J.jsonl", "--resume", knobs=knobs)
        jax_ = jsr._train_cmd("D", "J.jsonl", "--resume", knobs=jknobs)
        assert port[1:4] == ["-m", "em_adapt_torch", "train"]
        opts = [t for t in port[4:] if "=" not in t]
        assert "--deterministic" in opts
        assert [t for t in opts if t != "--deterministic"] == [t for t in jax_[4:]
                                                              if "=" not in t]
        kv = {t for t in port if "=" in t}
        jkv = {t for t in jax_ if "=" in t} - {"train.macro_steps=8", "train.rng_impl=rbg"}
        assert jkv <= kv, jkv - kv
        extra = kv - jkv
        assert extra == {"optim.base_lr=0.001",
                         "optim.lr_schedule=((10, 0.0001), (20, 1e-05), (30, 1e-06))"}
        cfg = pcfg.apply_overrides(pcfg.ExperimentConfig(), sorted(extra))
        assert cfg.optim == pcfg.OptimConfig()


MINI = sr.Protocol(
    images=8, val_images=2, batch_size=2, epochs=12, lr_drop_epochs=(3, 6, 9),
    norm_every=8, log_every=1, eval_every=6, preempt_after_step=14, poll_seconds=0.05,
    arm_timeout=300.0,
    task=("model.num_classes=4", "model.input_size=(33,33)", "model.fc6_channels=16",
          "model.init_scheme=he", "model.width_multiplier=0.125"),
)


def test_miniature_protocol_resumes_bit_exactly(tmp_path):
    """The protocol at width 0.125, 33x33, 48 steps with drops at 12, 24
    and 36, SIGTERM once step 14 is logged, then ``--resume``: the losses
    of control and preempt + resume bit-equal at every step, the "lr"
    snapshots at the drop steps in both lineages, the logged LR on the
    schedule, the same "best" in both, "norm" kept to 2 ending at 48."""
    lines = []
    result = sr.run(MINI, device="cpu", workdir=str(tmp_path), log=lines.append)
    checks = result["checks"]
    assert result["card"] is None and result["deterministic"] is True
    assert 14 <= result["resume_step"] < 48, result["resume_step"]
    assert any("SIGTERM at logged step" in ln for ln in lines)
    assert checks["losses_bitexact"], result["loss_mismatches"]
    assert len(result["loss_stream_control"]) == 48
    assert checks["post_resume_overlap_ok"]
    assert checks["lr_snapshots_control"] == checks["lr_snapshots_preempt"] == [12, 24, 36]
    assert checks["lr_schedule_ok"], checks["lr_schedule_errors"]
    assert {lr for _, lr in result["lr_stream_control"]} == set(STAGES)
    assert checks["best_race_ok"] and checks["best_lineages_identical"]
    assert checks["norm_retention_ok"], checks["norm_steps_control"]
    assert len(result["val_curve_control"]) == 8
