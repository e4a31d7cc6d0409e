"""PyTorch port: one EM training step against the JAX package's step on
shared weights, batch and class orders; the optimizer's accumulation,
momentum and LR drops; the data pipeline; the trainer loop and CLI."""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

import em_adapt_tpu.config as jcfg  # noqa: E402
from em_adapt_torch import config as pcfg  # noqa: E402
from em_adapt_torch.models.convert import to_jax_params  # noqa: E402
from em_adapt_torch.models.deeplab import DeepLabLargeFOV  # noqa: E402
from em_adapt_torch.train.optim import AccumulatingSGD, lr_at  # noqa: E402
from em_adapt_torch.train.trainer import Trainer, TrainState, loss_fn, train_step  # noqa: E402

torch.set_num_threads(2)


def both_cfgs(accum=1, base_lr=0.05, keep=1.0):
    kw = dict(
        model=dict(num_classes=4, input_size=(33, 33), fc6_channels=16,
                   width_multiplier=0.125, dropout_keep_prob=keep, init_scheme="he"),
        estep=dict(num_iter=2),
        optim=dict(accum_steps=accum, base_lr=base_lr, lr_schedule=((2, base_lr / 10),)),
        train=dict(batch_size=2, seed=0),
    )

    def build(mod):
        return mod.ExperimentConfig(
            model=mod.ModelConfig(**kw["model"]), estep=mod.EStepConfig(**kw["estep"]),
            optim=mod.OptimConfig(**kw["optim"]), train=mod.TrainConfig(**kw["train"]),
        )

    return build(jcfg), build(pcfg)


def tiny_batch(seed=0, b=2, hw=33, c=4):
    g = np.random.default_rng(seed)
    img = (g.normal(size=(b, hw, hw, 3)) * 40).astype(np.float32)
    label = np.zeros((b, hw, hw, 1), np.float32)
    label[:, hw // 3:, : hw // 2] = 1
    label[1, : hw // 3, hw // 2:] = 3
    label[:, :3] = 255.0
    return {"image": img, "label": label}


def test_one_step_matches_jax_step():
    """Shared weights, batch and orders (the JAX step's own order_rng,
    trainer.py:168/:189), keep-prob 1: the weak labels are identical, then
    loss, every gradient leaf and the updated params agree at f32 (the
    sums run in another order: rtol 1e-4, atol 1e-5 of each leaf's scale)."""
    from em_adapt_tpu.models import DeepLabLargeFOV as JaxDeepLab
    from em_adapt_tpu.ops.estep import estep_labels as jax_estep_labels
    from em_adapt_tpu.ops.estep import make_class_orders as jax_orders
    from em_adapt_tpu.ops.resize import resize_nearest_tf
    from em_adapt_tpu.train.optim import build_optimizer
    from em_adapt_tpu.train.state import TrainState as JaxState
    from em_adapt_tpu.train.trainer import _step_fn

    jc, pc = both_cfgs()
    jmodel = JaxDeepLab(jc.model)
    params = jmodel.init(jax.random.key(0))
    tx, _ = build_optimizer(jc.optim, 1)
    jstate = JaxState.create(params, tx, jax.random.key(1))
    batch = tiny_batch()
    jbatch = jax.tree.map(jnp.asarray, batch)

    rng = jax.random.split(jax.random.fold_in(jstate.rng, jstate.step))[0]
    drop_rng, order_rng = jax.random.split(rng)
    orders = np.array(jax_orders(order_rng, 2, 4))

    @jax.jit
    def weak_labels(p, b):
        logits = jmodel.apply(p, b["image"], train=True, rng=drop_rng)
        shrunk = resize_nearest_tf(b["label"], (5, 5))[..., 0]
        return jax_estep_labels(logits, shrunk, jnp.asarray(orders), jc.estep)

    weak_j = np.asarray(weak_labels(params, jbatch))
    new_jstate, jmetrics = jax.jit(_step_fn(jmodel, jc, tx))(jstate, jbatch)
    # The first momentum trace is the gradient itself (trace = g + 0.9 * 0).
    grads_j = optax.tree_utils.tree_get(new_jstate.opt_state, "trace")

    np_params = jax.tree.map(np.asarray, params)
    model = DeepLabLargeFOV(pc.model).load_params(np_params)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    total, metrics = loss_fn(model, tbatch, pc, generator=torch.Generator(),
                             orders=torch.from_numpy(orders))
    np.testing.assert_array_equal(metrics["weak"].numpy(), weak_j)
    np.testing.assert_allclose(total.item(), float(jmetrics["loss"]), rtol=1e-5)
    total.backward()
    grads = to_jax_params({k: p.grad for k, p in model.state_dict(keep_vars=True).items()})
    for name in np_params:
        for k in ("w", "b"):
            want = np.asarray(grads_j[name][k])
            np.testing.assert_allclose(grads[name][k], want, rtol=1e-4,
                                       atol=1e-5 * np.abs(want).max(), err_msg=f"{name}.{k}")

    model = DeepLabLargeFOV(pc.model).load_params(np_params)
    state = TrainState(model, AccumulatingSGD(model.parameters(), pc.optim), torch.Generator())
    out = train_step(state, tbatch, pc, orders=torch.from_numpy(orders))
    assert out["updated"] and state.step == 1
    new = to_jax_params(model)
    new_j = jax.tree.map(np.asarray, new_jstate.params)
    for name in np_params:
        for k in ("w", "b"):
            d_port = new[name][k] - np_params[name][k]
            d_jax = new_j[name][k] - np_params[name][k]
            assert np.abs(d_jax).max() > 0, f"{name}.{k} did not move"
            tol = 64 * np.finfo(np.float32).eps * np.abs(np_params[name][k]).max()
            np.testing.assert_allclose(d_port, d_jax, rtol=1e-3, atol=tol + 1e-4 * np.abs(d_jax).max(),
                                       err_msg=f"{name}.{k}")


def test_optimizer_matches_optax_over_accumulation_and_momentum():
    """Ten microsteps, accumulation 5, momentum 0.9, an LR drop between
    the two updates: params equal optax.MultiSteps(sgd) step for step."""
    from em_adapt_tpu.train.optim import build_optimizer

    cfg = dict(base_lr=0.1, momentum=0.9, accum_steps=5, lr_schedule=((1, 0.01),))
    tx, _ = build_optimizer(jcfg.OptimConfig(**cfg), 5)
    g = np.random.default_rng(0)
    p0 = g.normal(size=(3, 4)).astype(np.float32)
    jp, jst = {"w": jnp.asarray(p0)}, None
    jst = tx.init(jp)
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = AccumulatingSGD([p], pcfg.OptimConfig(**cfg), 5)
    for step in range(10):
        grad = g.normal(size=(3, 4)).astype(np.float32)
        u, jst = tx.update({"w": jnp.asarray(grad)}, jst, jp)
        jp = jax.tree.map(lambda a, b: a + b, jp, u)
        p.grad = torch.from_numpy(grad)
        moved = opt.step(step)
        assert moved == ((step + 1) % 5 == 0)
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp["w"]), rtol=1e-6, atol=1e-7)


def test_accumulation_matches_manual_mean():
    """Params move only every 5th microstep, by lr times the mean grad."""
    p = torch.nn.Parameter(torch.zeros(2))
    opt = AccumulatingSGD([p], pcfg.OptimConfig(base_lr=0.5, momentum=0.0, accum_steps=5,
                                                lr_schedule=()))
    grads = [torch.tensor([float(i), 2.0 * i]) for i in range(1, 6)]
    for i, g in enumerate(grads):
        p.grad = g.clone()
        opt.step(i)
        if i < 4:
            assert not p.detach().any()
    mean = torch.stack(grads).mean(0)
    torch.testing.assert_close(p.detach(), -0.5 * mean)


def test_sgd_momentum_matches_tf_semantics():
    """accum = m*accum + g; var -= lr*accum (tf.train.MomentumOptimizer)."""
    p = torch.nn.Parameter(torch.ones(3))
    opt = AccumulatingSGD([p], pcfg.OptimConfig(base_lr=0.1, momentum=0.9, accum_steps=1,
                                                lr_schedule=()))
    p.grad = torch.full((3,), 2.0)
    opt.step(0)
    torch.testing.assert_close(p.detach(), torch.full((3,), 1.0 - 0.2))
    p.grad = torch.full((3,), 2.0)
    opt.step(1)
    torch.testing.assert_close(p.detach(), torch.full((3,), 1.0 - 0.2 - 0.38))


def test_lr_drops_at_reference_boundaries():
    from em_adapt_tpu.train.optim import lr_at as jax_lr_at
    from em_adapt_tpu.train.optim import lr_schedule

    cfg, jc = pcfg.OptimConfig(), jcfg.OptimConfig()
    assert lr_at(cfg, 100, 999) == pytest.approx(1e-3)
    assert lr_at(cfg, 100, 1000) == pytest.approx(1e-4)
    assert lr_at(cfg, 100, 2000) == pytest.approx(1e-5)
    assert lr_at(cfg, 100, 3000) == pytest.approx(1e-6)
    sched = lr_schedule(jc, 7)
    for step in list(range(0, 250, 13)) + [69, 70, 71, 139, 140, 141, 210]:
        assert lr_at(cfg, 7, step) == jax_lr_at(jc, 7, step)
        assert lr_at(cfg, 7, step) == pytest.approx(float(sched(step)), rel=1e-6)
    with pytest.raises(ValueError, match="duplicate"):
        lr_at(pcfg.OptimConfig(lr_schedule=((10, 1e-4), (10, 1e-5))), 1, 0)
    # Through the optimizer: the reference recipe (accum 5) drops three times.
    p = torch.nn.Parameter(torch.zeros(1))
    opt = AccumulatingSGD([p], pcfg.OptimConfig(momentum=0.0), 10)
    emitted = []
    for step in range(400):
        p.grad = torch.ones(1)
        if opt.step(step):
            emitted.append(opt.sgd.param_groups[0]["lr"])
    assert len(emitted) == 80
    assert sorted(set(emitted), reverse=True) == [1e-3, 1e-4, 1e-5, 1e-6]
    assert emitted[19:21] == [1e-3, 1e-4]  # update 20 emits at microstep 99


def test_batches_bit_identical_to_jax_pipeline():
    from em_adapt_torch.data.pipeline import SyntheticVOC, batch_iterator
    from em_adapt_tpu.data.pipeline import SyntheticVOC as JaxSynth
    from em_adapt_tpu.data.pipeline import batch_iterator as jax_batches

    for kw in (dict(input_size=(65, 65)), dict(input_size=(33, 33), wire_dtype="uint8",
                                              train_label_size=(5, 5))):
        it = batch_iterator(SyntheticVOC(6, 21, seed=3), pcfg.DataConfig(**kw), batch_size=2,
                            seed=4, epochs=2, num_workers=2, start_step=1)
        jit = jax_batches(JaxSynth(6, 21, seed=3), jcfg.DataConfig(**kw), batch_size=2,
                          seed=4, epochs=2, num_workers=2, start_step=1)
        got, want = list(it), list(jit)
        assert len(got) == len(want) == 5
        for a, b in zip(got, want):
            assert a["id"] == b["id"]
            for k in ("image", "label"):
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])


def test_trainer_fit_on_cpu(tmp_path):
    _, pc = both_cfgs(accum=2, keep=0.5)
    pc = pc.replace(data=dataclasses.replace(pc.data, input_size=(33, 33), num_workers=2),
                    train=dataclasses.replace(pc.train, log_every_steps=1),
                    checkpoint=pcfg.CheckpointConfig(save_dir=str(tmp_path)))
    from em_adapt_torch.data.pipeline import SyntheticVOC, batch_iterator

    trainer = Trainer(pc, device="cpu", steps_per_epoch=1)
    state = trainer.init_state()
    logged = []
    records = trainer.fit(state, batch_iterator(SyntheticVOC(8, 4), pc.data, batch_size=2),
                          num_steps=4, log_fn=logged.append)
    # One log window a step; its record counts the steps done.
    assert [(r["step"] + 1, r["loss"], r["lr"]) for r in records] == [
        (w["step"], w["loss"], w["lr"]) for w in logged]
    assert len(records) == 4 and state.step == 4
    assert all(np.isfinite(r["loss"]) for r in records)
    assert [r["updated"] for r in records] == [False, True, False, True]
    assert [r["lr"] for r in records] == [0.05, 0.05, 0.005, 0.005]
    for key in ("estep_launches", "block1_fwd_launches", "block1_bwd_launches"):
        assert all(r[key] == 0 for r in records)  # CPU: the plain versions


def test_config_defaults_match_jax_and_unported_values_raise():
    for name in ("EStepConfig", "ModelConfig", "DataConfig", "OptimConfig", "TrainConfig",
                 "CheckpointConfig"):
        port = getattr(pcfg, name)()
        ref = getattr(jcfg, name)()
        for f in dataclasses.fields(port):
            assert getattr(port, f.name) == getattr(ref, f.name), f"{name}.{f.name}"
    cfg = pcfg.apply_overrides(pcfg.ExperimentConfig(), ["model.input_size=(65, 65)",
                                                         "estep.suppress_others=false"])
    assert cfg.data.input_size == (65, 65) and cfg.estep.suppress_others is False
    pcfg.check_supported(pcfg.ExperimentConfig())
    for override in ("estep.impl=native", "estep.method=fixed"):
        bad = pcfg.apply_overrides(pcfg.ExperimentConfig(), [override])
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            pcfg.check_supported(bad)
    # bf16, the fused block1 (K2 and K3) and remat run in training and evaluation.
    for override in ("model.compute_dtype=bfloat16", "model.block1_impl=pallas",
                     "model.remat=true"):
        cfg = pcfg.apply_overrides(pcfg.ExperimentConfig(), [override])
        pcfg.check_supported(cfg, "train")
        pcfg.check_supported(cfg, "eval")


def test_entry_points_need_a_device_choice(monkeypatch, capsys, tmp_path):
    """With no card and no device given, the entry points raise; with
    device='cpu' the CLI trains and logs one record per step (stdout and
    ``--log-jsonl``)."""
    from em_adapt_torch.__main__ import main
    from em_adapt_torch.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    args = ["train", "--synthetic", "4", "--steps", "2", "model.width_multiplier=0.125",
            "model.fc6_channels=8", "model.num_classes=4", "model.input_size=(33, 33)",
            "train.batch_size=2", "optim.accum_steps=2", "data.num_workers=1",
            "optim.lr_schedule=((1, 0.0001),)", f"checkpoint.save_dir={tmp_path}",
            "train.log_every_steps=1", "--log-jsonl", str(tmp_path / "log.jsonl")]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(args)
    assert main(args + ["--device", "cpu"]) == 0
    lines = [line for line in capsys.readouterr().out.strip().splitlines()
             if line.startswith("[train]")]
    records = [json.loads(line) for line in (tmp_path / "log.jsonl").read_text().splitlines()]
    assert len(lines) == len(records) == 2 and " loss=" in lines[0] and "loss" in records[0]
    # An epoch is 4 images / batch 2 = 2 steps: the LR drops only at step 2.
    assert [r["lr"] for r in records] == [1e-3, 1e-3]
