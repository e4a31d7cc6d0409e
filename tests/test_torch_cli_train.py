"""PyTorch port: the ``train`` command's new flags against the JAX
package's CLI. ``--warm-start DIR[:STEP]`` parsed as ``em_adapt_tpu``
parses it; exit 2 for ``--warm-start`` with ``--resume`` and for a
``--synthetic-val`` of 0 or less; ``--strong-fraction``, periodic eval with
``--synthetic-val`` (val_metric records in ``--log-jsonl``, "best",
``best_metric.json``) and a warm start from that "best"."""

import json

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from em_adapt_torch.train.trainer import Trainer  # noqa: E402

torch.set_num_threads(2)

CLI = ["--synthetic", "8", "--device", "cpu", "model.width_multiplier=0.125",
       "model.fc6_channels=8", "model.num_classes=4", "model.input_size=(33, 33)",
       "train.batch_size=2", "optim.accum_steps=2", "data.num_workers=1",
       "model.init_scheme=he", "eval.batch_size=2"]


def test_parse_warm_start_matches_jax():
    from em_adapt_torch.__main__ import parse_warm_start
    from em_adapt_tpu.cli import _parse_warm_start

    for spec in ("saver", "/a/b/saver:120", "saver:latest", "saver:12x", ":5", "a:b:7"):
        assert parse_warm_start(spec) == _parse_warm_start(spec)


@pytest.mark.parametrize("argv", [["--warm-start", "x", "--resume"], ["--synthetic-val", "0"],
                                  ["--synthetic-val", "-3"]], ids=["warm+resume", "val0", "val-3"])
def test_cli_rejects_bad_flag_combinations_with_exit_2(tmp_path, capsys, argv):
    from em_adapt_torch.__main__ import main

    assert main(["train", *argv, *CLI, f"checkpoint.save_dir={tmp_path}"]) == 2
    assert "error:" in capsys.readouterr().err
    assert not list(tmp_path.iterdir())  # failed before any work


def test_cli_semi_supervised_eval_best_and_warm_start(tmp_path, capsys, monkeypatch):
    """--strong-fraction turns semi-supervision on; train.eval_every_steps
    with --synthetic-val logs val_metric records (in --log-jsonl), saves
    "best" and writes best_metric.json; a second run warm-starts from that
    "best" (DIR:STEP, --warm-start-tag best) at step 0."""
    from em_adapt_torch import __main__ as cli

    made = []

    class Recorded(Trainer):
        def __init__(self, cfg, **kw):
            super().__init__(cfg, **kw)
            made.append(self)

    monkeypatch.setattr(cli, "Trainer", Recorded)
    first, log = tmp_path / "first", tmp_path / "first.jsonl"
    assert cli.main(["train", "--steps", "4", "--strong-fraction", "0.5", "--synthetic-val", "3",
                     "--log-jsonl", str(log), *CLI, f"checkpoint.save_dir={first}",
                     "train.eval_every_steps=2", "train.log_every_steps=1"]) == 0
    out = capsys.readouterr().out
    assert made[0].cfg.semi_supervised and "estep calibration:" in out
    records = [json.loads(line) for line in log.read_text().splitlines()]
    evals = [r for r in records if "val_metric" in r]
    assert [r["step"] for r in evals] == [2, 4] and all(0 <= r["val_metric"] <= 1 for r in evals)
    train = [r for r in records if "loss" in r]
    assert [r["step"] for r in train] == [1, 2, 3, 4]
    assert all(r["estep_us_per_image_calib"] > 0 for r in train)
    best = made[0].checkpointer.all_steps("best")
    side = json.loads((first / "best_metric.json").read_text())
    assert best and side["step"] == best[-1] and side["metric"] == max(
        r["val_metric"] for r in evals)

    assert cli.main(["train", "--steps", "1", "--warm-start", f"{first}:{best[-1]}",
                     "--warm-start-tag", "best", *CLI,
                     f"checkpoint.save_dir={tmp_path / 'second'}"]) == 0
    out = capsys.readouterr().out
    assert f"warm start: params from {first} (tag=best, step={best[-1]})" in out
    assert "done at step 1" in out and not made[1].cfg.semi_supervised


def test_config_accepts_the_ported_keys_and_names_item_7_for_the_voc_protocol():
    """The JAX package's TrainConfig keys load with its defaults; the TPU
    dispatch levers are accepted and not ported; optim.lr_multipliers no
    longer raises; train.eval_protocol="voc" raises and names Queue 1
    item 7, another value is refused."""
    import dataclasses

    from em_adapt_torch import config as pcfg
    from em_adapt_tpu import config as jcfg

    port, ref = pcfg.TrainConfig(), jcfg.TrainConfig()
    assert {f.name for f in dataclasses.fields(port)} <= {f.name for f in dataclasses.fields(ref)}
    assert pcfg.ExperimentConfig().semi_supervised is jcfg.ExperimentConfig().semi_supervised
    cfg = pcfg.apply_overrides(pcfg.ExperimentConfig(), [
        "train.macro_steps=10", "train.rng_impl=rbg", "train.donate_state=false",
        "optim.lr_multipliers=true", "train.tag_warmup_steps=5", "train.eval_every_steps=10"])
    pcfg.check_supported(cfg)
    voc = pcfg.apply_overrides(pcfg.ExperimentConfig(), ["train.eval_protocol=voc"])
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        pcfg.check_supported(voc)
    with pytest.raises(ValueError, match="eval_protocol"):
        pcfg.check_supported(pcfg.apply_overrides(pcfg.ExperimentConfig(),
                                                  ["train.eval_protocol=other"]))
