"""PyTorch port: full-state checkpoints and resume. A run stopped
mid-accumulation, saved, restored into a fresh Trainer and continued ends
bit for bit where the uninterrupted run ends; duplicate-step and async
writes; parameters-only loads; ``train --resume`` and ``eval`` on the
command line. (Writes that fail or are killed midway: test_torch_failure.py;
the steps ``fit`` saves at and its budget: test_torch_fit.py.)"""

import copy
import json
import os
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from em_adapt_torch import config as pcfg  # noqa: E402
from em_adapt_torch.data.pipeline import SyntheticVOC, batch_iterator  # noqa: E402
from em_adapt_torch.train.checkpoint import CheckpointManager  # noqa: E402
from em_adapt_torch.train.state import bitwise_diff  # noqa: E402
from em_adapt_torch.train.trainer import Trainer  # noqa: E402

torch.set_num_threads(2)

#: SyntheticVOC(8) at batch 2: four microbatch steps an epoch.
IMAGES, BATCH = 8, 2


def port_cfg(save_dir, *, accum=3, lr_schedule=((1, 1e-4),), save_every=0, snapshot=True,
             max_to_keep=2, async_save=False, bf16=False, epochs=2, keep=0.5, log_every=500):
    return pcfg.ExperimentConfig(
        model=pcfg.ModelConfig(num_classes=4, input_size=(33, 33), fc6_channels=8,
                               width_multiplier=0.125, init_scheme="he",
                               dropout_keep_prob=keep,
                               compute_dtype="bfloat16" if bf16 else "float32",
                               block1_impl="pallas" if bf16 else "auto"),
        data=pcfg.DataConfig(input_size=(33, 33), num_workers=1),
        estep=pcfg.EStepConfig(num_iter=2),
        optim=pcfg.OptimConfig(accum_steps=accum, base_lr=0.01, lr_schedule=lr_schedule),
        train=pcfg.TrainConfig(batch_size=BATCH, epochs=epochs, seed=0,
                               log_every_steps=log_every),
        checkpoint=pcfg.CheckpointConfig(save_dir=str(save_dir), save_every_steps=save_every,
                                         max_to_keep=max_to_keep,
                                         snapshot_on_lr_drop=snapshot, async_save=async_save),
    )


def batches(cfg, start_step=0):
    return batch_iterator(SyntheticVOC(IMAGES, 4), cfg.data, batch_size=BATCH, seed=0,
                          start_step=start_step)


def trainer_for(cfg, steps_per_epoch=IMAGES // BATCH):
    return Trainer(cfg, device="cpu", steps_per_epoch=steps_per_epoch)


@pytest.mark.parametrize("stop", [2, 4], ids=["before-first-update", "mid-window"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16-fused-block1"])
def test_resume_mid_accumulation_is_bit_exact(tmp_path, bf16, stop):
    """Stop at ``stop`` (accumulation 3: step 2 is before the first update,
    when SGD has no momentum buffer yet; step 4 is one microbatch into the
    second window), save, restore into a fresh Trainer and run on to step
    8: params, momentum buffers, accumulator, mini_step, step, generator
    state and every later loss equal the uninterrupted run's bit for bit.
    In bf16 the fused block 1's plain versions (K2's and K3's) run."""
    control_cfg = port_cfg(tmp_path / "control", bf16=bf16)
    control = trainer_for(control_cfg)
    state_a = control.init_state()
    records_a = control.fit(state_a, batches(control_cfg), num_steps=8)

    cfg = port_cfg(tmp_path / "run", bf16=bf16)
    first = trainer_for(cfg)
    state_b = first.init_state()
    first.fit(state_b, batches(cfg), num_steps=stop)
    first.checkpointer.save(state_b, "norm")
    first.checkpointer.close()

    trainer = trainer_for(cfg)
    restored = trainer.restore_state()
    assert restored.step == stop and restored.optimizer.mini_step == stop % 3
    momentum = restored.optimizer.state_dict()["momentum"]
    assert all(b is None for b in momentum) == (stop < 3)
    assert bitwise_diff(restored.state_dict(), snapshot(state_b)) == []
    records = trainer.fit(restored, batches(cfg, start_step=stop), num_steps=8)

    assert [r["step"] for r in records] == list(range(stop, 8))
    assert [r["loss"] for r in records] == [r["loss"] for r in records_a[stop:]]
    assert bitwise_diff(restored.state_dict(), state_a.state_dict()) == []
    assert any(r["updated"] for r in records) and restored.optimizer.mini_step == 8 % 3


def snapshot(state):
    """An independent copy of the state's tensors and values."""
    return copy.deepcopy(state.state_dict())


def _state(seed=0):
    cfg = port_cfg("unused", accum=2, snapshot=False)
    trainer = trainer_for(cfg)
    state = trainer.init_state(seed)
    trainer.fit(state, batches(cfg), num_steps=3)  # momentum made, acc mid-window
    return cfg, state


def test_duplicate_step_save_overwrites(tmp_path):
    """Newest write wins (em_adapt_tpu/train/checkpoint.py:50-64)."""
    _, state = _state()
    ckpt = CheckpointManager(pcfg.CheckpointConfig(save_dir=str(tmp_path), async_save=False))
    ckpt.save(state, "norm")
    with torch.no_grad():
        for p in state.model.parameters():
            p.add_(1.0)
    ckpt.save(state, "norm")
    assert ckpt.all_steps("norm") == [3]
    assert bitwise_diff(ckpt.load("norm"), snapshot(state)) == []
    assert os.listdir(ckpt.step_dir("norm", 3)) == ["state.pt"]


def test_async_save_copies_before_returning(tmp_path, monkeypatch):
    """save() returns once the state is on the host: the params, momentum,
    acc, step and generator updated in place right after it (while the
    write is still running) do not reach the file."""
    _, state = _state()
    want = snapshot(state)
    real_save = torch.save
    started = threading.Event()

    def slow_save(obj, f, *a, **kw):
        started.set()
        time.sleep(0.3)
        return real_save(obj, f, *a, **kw)

    monkeypatch.setattr(torch, "save", slow_save)
    ckpt = CheckpointManager(pcfg.CheckpointConfig(save_dir=str(tmp_path), async_save=True))
    ckpt.save(state, "norm")
    assert started.wait(5)
    with torch.no_grad():
        for p in state.model.parameters():
            p.mul_(-2.0)
        for buf in state.optimizer.state_dict()["momentum"]:
            buf.add_(1.0)
        for a in state.optimizer.acc:
            a.add_(1.0)
    state.optimizer.mini_step += 1
    state.step += 1
    torch.rand(4, generator=state.generator)
    assert bitwise_diff(state.state_dict(), want) != []
    ckpt.close()
    assert ckpt.all_steps("norm") == [3]
    assert bitwise_diff(ckpt.load("norm"), want) == []


def test_restore_params_loads_across_optimizer_configs(tmp_path):
    """restore_params loads only the parameters: a checkpoint written
    with accumulation 2 loads into a model for evaluation; the full
    restore into an accumulation-1 state raises."""
    cfg, state = _state()
    ckpt = CheckpointManager(pcfg.CheckpointConfig(save_dir=str(tmp_path), async_save=False))
    ckpt.save(state, "norm")
    other = trainer_for(port_cfg(tmp_path, accum=1)).init_state(seed=5)
    assert bitwise_diff(other.model.state_dict(), state.model.state_dict()) != []
    assert ckpt.restore_params(other.model, "norm") == 3
    assert bitwise_diff(other.model.state_dict(), state.model.state_dict()) == []
    with pytest.raises(ValueError, match="optimizer state does not match"):
        ckpt.restore(other, "norm")
    with pytest.raises(FileNotFoundError):
        ckpt.restore_params(other.model, "lr")


CLI_ARGS = ["--synthetic", "8", "--device", "cpu", "model.width_multiplier=0.125",
            "model.fc6_channels=8", "model.num_classes=4", "model.input_size=(33, 33)",
            "train.batch_size=2", "optim.accum_steps=2", "data.num_workers=1",
            "model.init_scheme=he", "optim.lr_schedule=((1, 0.0001),)",
            "checkpoint.save_every_steps=2"]


def test_cli_train_resume_continues_to_the_uninterrupted_params(tmp_path, capsys):
    """`train --steps 3`, then `train --resume --steps 6`, ends on the full
    state (params, momentum, acc, mini_step, step, generator) of one
    `train --steps 6` run, bit for bit, and logs the same records (one a
    step, through ``--log-jsonl``)."""
    from em_adapt_torch.__main__ import main

    def train(save_dir, log, *extra):
        assert main(["train", *extra, *CLI_ARGS, f"checkpoint.save_dir={save_dir}",
                     "train.log_every_steps=1", "--log-jsonl", str(tmp_path / log)]) == 0
        return capsys.readouterr().out.strip().splitlines()

    def losses(log):
        lines = (tmp_path / log).read_text().splitlines()
        return [(r["step"], r["loss"]) for r in map(json.loads, lines) if "loss" in r]

    train(tmp_path / "once", "once.jsonl", "--steps", "6")
    assert train(tmp_path / "twice", "first.jsonl", "--resume", "--steps", "3")[0] == (
        "--resume: no checkpoint found, starting fresh")
    resumed = train(tmp_path / "twice", "resumed.jsonl", "--resume", "--steps", "6")
    assert resumed.pop(0) == "resumed from step 3"
    assert losses("resumed.jsonl") == losses("once.jsonl")[3:]
    ckpt = [CheckpointManager(pcfg.CheckpointConfig(save_dir=str(tmp_path / d)))
            for d in ("once", "twice")]
    assert ckpt[0].all_steps("norm") == ckpt[1].all_steps("norm") == [4, 6]
    assert ckpt[0].all_steps("lr") == ckpt[1].all_steps("lr") == [4]
    assert bitwise_diff(ckpt[0].load("norm"), ckpt[1].load("norm")) == []


def test_cli_eval_loads_the_latest_checkpoint(tmp_path, capsys):
    """After training, `eval` prints "evaluating checkpoint step N" and the
    trained model's per-class IoU and mIoU, not a fresh init's."""
    from em_adapt_torch.__main__ import main
    from em_adapt_torch.eval.miou import VOC_CLASS_NAMES
    from em_adapt_torch.eval.predict import Evaluator

    cfg = pcfg.apply_overrides(pcfg.ExperimentConfig(),
                               CLI_ARGS[4:] + [f"checkpoint.save_dir={tmp_path}",
                                               "eval.batch_size=2"])
    trainer = trainer_for(cfg)
    state = trainer.init_state()
    trainer.fit(state, batches(cfg), num_steps=4)
    trainer.checkpointer.save(state, "norm")
    trainer.checkpointer.close()
    val = batch_iterator(SyntheticVOC(5, 4, seed=cfg.train.seed + 1), cfg.data, batch_size=2,
                         epochs=1, train=False)
    miou, iou = Evaluator(cfg, state.model).evaluate_fixed(val)
    want = [f"  IoU[{VOC_CLASS_NAMES[i]}] = {v:.4f}" for i, v in enumerate(iou)]
    want.append(f"mIoU = {miou:.4f}")

    assert main(["eval", "--synthetic", "5", "--fixed-size", "--device", "cpu",
                 *CLI_ARGS[4:], f"checkpoint.save_dir={tmp_path}", "eval.batch_size=2"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out == ["evaluating checkpoint step 4"] + want
    fresh = Evaluator(cfg, trainer_for(cfg).init_state().model).evaluate_fixed(
        batch_iterator(SyntheticVOC(5, 4, seed=1), cfg.data, batch_size=2, epochs=1,
                       train=False))
    assert not np.array_equal(fresh[1], iou)
