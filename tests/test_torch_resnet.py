"""PyTorch port: DeepLab-v2 ResNet-101 (``models/resnet.py``) against the
plain float32 reference ``tests/torch_reference/deeplab_v2_resnet.py`` at
full depth [3, 4, 23, 3] and width 1/32, with seeded N(0, 0.01) weights
and calibrated frozen BN statistics: the forward, one EM step through
``train_step`` with the Caffe LR groups, the score map at 321 and 513
(on the meta device), the published parameter count from the specs, the
registry's dispatch, the optimizer's head groups, ``weight_l2``,
per-bottleneck remat, the stage spans, the checkpoint round trip of the
frozen statistics, ``train`` and ``eval`` through the CLI, and the clear
errors of the VGG-only paths."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from em_adapt_torch.config import ExperimentConfig, ModelConfig, OptimConfig  # noqa: E402
from em_adapt_torch.models import resnet  # noqa: E402
from em_adapt_torch.models.deeplab import DeepLabLargeFOV, build_model, init_params  # noqa: E402
from em_adapt_torch.models.registry import get_model  # noqa: E402
from em_adapt_torch.train.optim import AccumulatingSGD, lr_group  # noqa: E402
from em_adapt_torch.train.state import TrainState  # noqa: E402
from em_adapt_torch.train.trainer import train_step  # noqa: E402
from tests.torch_reference import deeplab_v2_resnet as ref  # noqa: E402

NAME = "deeplab_v2_resnet101"
WIDTH = 1 / 32
SMALL = ModelConfig(name=NAME, width_multiplier=WIDTH, input_size=(41, 41))


def _to_hwio(params: dict, stats: dict) -> dict:
    return {n: {"w": p["w"].permute(2, 3, 1, 0), **{k: v for k, v in p.items() if k != "w"},
                **stats.get(n, {})} for n, p in params.items()}


def _images(seed: int, size: int, n: int = 2) -> torch.Tensor:
    return torch.randint(0, 256, (n, size, size, 3), generator=torch.Generator().manual_seed(seed),
                         dtype=torch.uint8)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: oneDNN's threads cost more than they save on
    these 8-channel convolutions (10 ms a forward on one thread)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def net():
    """Seeded weights at full depth and width 1/32, the frozen statistics
    calibrated on a batch, the reference's trees and the port's model."""
    torch.manual_seed(0)
    params, stats = ref.init(torch.Generator().manual_seed(11), width=WIDTH)
    ref.calibrate(params, stats, _images(1, 41))
    model = get_model(NAME)(SMALL).load_params(_to_hwio(params, stats))
    return params, stats, model


@pytest.mark.parametrize("size", [33, 41])
def test_forward_matches_the_reference(net, size):
    params, stats, model = net
    image = _images(size, size)
    with torch.no_grad():
        want = ref.forward(params, stats, image)
        got = model(image)
    side = -(-size // 8)
    assert got.shape == want.shape == (2, side, side, 21) and got.dtype == torch.float32
    assert float((got - want).norm() / want.norm()) < 1e-5
    assert float(want.std()) > 0.1  # calibrated: the logits are not flat


def test_em_step_matches_the_reference(net):
    """One step through ``train_step``: the port's E-step (K1's plain
    version), the loss with weight decay, and SGD with the LR groups
    (ASPP weights x10, biases x20) against the reference's loss, each
    leaf's gradient and the updated weights."""
    params, stats, _ = net
    cfg = ExperimentConfig(model=SMALL, optim=OptimConfig(accum_steps=1, lr_multipliers=True,
                                                          base_lr=1e-3, weight_decay=1e-5))
    model = get_model(NAME)(SMALL).load_params(_to_hwio(params, stats)).train()
    names, leaves = zip(*model.named_parameters())
    opt = AccumulatingSGD(leaves, cfg.optim, names=names, head=model.HEAD)
    state = TrainState(model, opt, torch.Generator())
    batch = {"image": _images(7, 41), "label": torch.zeros(2, 41, 41, 1, dtype=torch.uint8)}
    batch["label"][0, 5:30, 8:35] = 3
    batch["label"][1, 10:41, 0:20] = 15
    batch["label"][:, :3] = 255
    orders = torch.stack([torch.randperm(20, generator=torch.Generator().manual_seed(r)) + 1
                          for r in range(5)]).to(torch.int32)
    metrics = train_step(state, batch, cfg, orders=orders)

    with torch.no_grad():
        logits = ref.forward(params, stats, batch["image"])
    rows = [0, 6, 13, 20, 27, 34]  # TF1 nearest 41 -> 6: floor(i * 41/6)
    shrunk = batch["label"][:, rows][:, :, rows, 0]
    weak = ref.estep(logits, shrunk, orders)
    assert float((metrics["weak"] == weak).float().mean()) >= 0.95
    loss, grads, new = ref.train_step(params, stats, batch, metrics["weak"], lr=1e-3,
                                      weight_decay=1e-5)
    assert float(metrics["loss"]) == pytest.approx(float(loss), rel=1e-5)
    for (layer, key), g in grads.items():
        leaf = f"layers.{layer}.{'weight' if key == 'w' else 'bias'}"
        p = dict(model.named_parameters())[leaf]
        torch.testing.assert_close(p.grad, g, rtol=1e-4, atol=1e-4 * float(g.abs().max()),
                                   msg=leaf)
        torch.testing.assert_close(p.detach(), new[(layer, key)], rtol=1e-5, atol=1e-8, msg=leaf)


@pytest.mark.parametrize("size,side", [(321, 41), (513, 65)])
def test_score_map_at_published_widths(size, side):
    """The logits' grid on the meta device (shapes only, nothing
    computed): ceil(H/8), what the trainer's label shrink asks the model
    for (``output_stride``)."""
    with torch.device("meta"):
        model = get_model(NAME)(ModelConfig(name=NAME, compute_dtype="bfloat16"))
        out = model(torch.empty(1, size, size, 3, dtype=torch.uint8))
    assert tuple(out.shape) == (1, side, side, 21) and out.dtype == torch.float32
    assert -(-size // model.output_stride) == side == -(-size // DeepLabLargeFOV.output_stride)


def test_parameter_count_from_the_specs():
    cfg = ModelConfig(name=NAME)
    specs = resnet.conv_specs(cfg)
    trunk = sum(s.k * s.k * s.cin * s.cout for s in specs if not s.bias)
    aspp = sum(s.k * s.k * s.cin * s.cout + s.cout for s in specs if s.bias)
    assert (resnet.num_params(cfg), trunk, aspp) == (43_943_188, 42_394_816, 1_548_372)
    assert len(specs) == 108 and sum(not s.bias for s in specs) == 104
    assert [(s.name, s.k, s.cin, s.cout, s.stride, s.rate, s.bias) for s in specs] == ref.convs()


def test_registry_dispatches_init_and_build():
    assert get_model("deeplab_largefov") is DeepLabLargeFOV
    params = init_params(torch.Generator().manual_seed(0), SMALL)
    assert set(params["conv1"]) == {"w", "gamma", "beta", "mean", "var"}
    assert set(params["fc1_voc12_c3"]) == {"w", "b"}
    assert float(params["conv1"]["w"].std()) == pytest.approx(0.01, rel=0.1)
    model = build_model(SMALL, 0, torch.device("cpu"))
    assert isinstance(model, resnet.DeepLabV2ResNet101)
    assert torch.equal(model.layers["conv1"].weight, params["conv1"]["w"].permute(3, 2, 0, 1))
    assert set(init_params(torch.Generator(), ModelConfig())) >= {"conv1_1", "fc8"}
    with pytest.raises(KeyError, match="deeplab_v2_resnet101"):
        get_model("resnet")


def test_lr_groups_follow_the_models_head():
    model = get_model(NAME)(SMALL)
    names = [n for n, _ in model.named_parameters()]
    leaves = [torch.nn.Parameter(torch.zeros(1)) for _ in names]
    opt = AccumulatingSGD(leaves, OptimConfig(lr_multipliers=True), names=names, head=model.HEAD)
    mult = dict(zip(names, opt.multipliers))
    assert {mult[f"layers.fc1_voc12_c{i}.{k}"] for i in range(4) for k in ("weight",)} == {10.0}
    assert {mult[f"layers.fc1_voc12_c{i}.bias"] for i in range(4)} == {20.0}
    assert {m for n, m in mult.items() if "fc1_voc12" not in n} == {1.0}  # no trunk bias
    assert lr_group("layers.fc8.bias", DeepLabLargeFOV.HEAD) == "head_b"
    assert lr_group("layers.fc1_voc12_c0.weight", ("fc8",)) == "weight"
    vgg = [n for n, _ in DeepLabLargeFOV(ModelConfig(width_multiplier=0.125,
                                                     fc6_channels=8)).named_parameters()]
    with pytest.raises(ValueError, match="head"):
        AccumulatingSGD([torch.nn.Parameter(torch.zeros(1)) for _ in vgg],
                        OptimConfig(lr_multipliers=True), names=vgg)


def test_weight_l2_is_over_conv_weights_only(net):
    _, _, model = net
    want = sum(0.5 * float(layer.weight.detach().double().square().sum())
               for layer in model.layers.values())
    assert float(model.weight_l2()) == pytest.approx(want, rel=1e-5)
    trial = get_model(NAME)(SMALL).load_params(
        {n: {k: (v + 3.0 if k in ("b", "mean", "gamma") else v) for k, v in p.items()}
         for n, p in _to_hwio(*net[:2]).items()})
    assert float(trial.weight_l2()) == float(model.weight_l2())


def test_remat_checkpoints_each_bottleneck_and_keeps_the_gradients(net, monkeypatch):
    params, stats, _ = net
    calls = []
    real = resnet.checkpoint

    def counted(fn, *args, **kw):
        calls.append(args[1].name)
        return real(fn, *args, **kw)

    monkeypatch.setattr(resnet, "checkpoint", counted)
    image = _images(3, 33)
    grads = []
    for remat in (False, True):
        cfg = dataclasses.replace(SMALL, remat=remat)
        model = get_model(NAME)(cfg).load_params(_to_hwio(params, stats))
        model(image, train=True, generator=torch.Generator()).square().sum().backward()
        grads.append([p.grad for p in model.parameters()])
    assert len(calls) == 33 and calls[0] == "res2a" and calls[-1] == "res5c"
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


def test_forward_draws_nothing_and_opens_the_stage_spans(net):
    from em_adapt_torch.utils import tracing

    _, _, model = net
    image = _images(4, 33)
    gen = torch.Generator().manual_seed(5)
    before = gen.get_state()
    tracing.clear()
    with torch.no_grad(), tracing.root("fit.step", "train", 0):
        trained = model(image, train=True, generator=gen)
    assert torch.equal(gen.get_state(), before)
    with torch.no_grad():
        assert torch.equal(trained, model(image))
    spans = tracing.entries()[-1]["calls"]
    assert {f"resnet.{s}" for s in ("stem", "res2", "res3", "res4", "res5", "aspp")} <= set(spans)
    tracing.clear()


def test_checkpoint_round_trip_carries_the_frozen_statistics(net, tmp_path):
    from em_adapt_torch.train.trainer import Trainer

    cfg = ExperimentConfig(model=SMALL).replace(
        checkpoint=dataclasses.replace(ExperimentConfig().checkpoint, save_dir=str(tmp_path),
                                       async_save=False))
    trainer = Trainer(cfg, device="cpu")
    state = trainer.init_state(seed=3)
    state.model.load_params(_to_hwio(*net[:2]))
    trainer.checkpointer.save(state, "norm")
    fresh = trainer.restore_state("norm")
    saved = trainer.checkpointer.load("norm")["params"]
    assert {"layers.res4b22_branch2c.gamma", "layers.conv1.var"} <= set(saved)
    for key, value in state.model.state_dict().items():
        assert torch.equal(fresh.model.state_dict()[key], value), key
    assert float(fresh.model.layers["res4b22_branch2c"].gamma[0]) == pytest.approx(
        ref.RESIDUAL_GAMMA)


def test_train_and_eval_through_the_cli(tmp_path, capsys):
    """``train --preset gpu-perf-fold model.name=deeplab_v2_resnet101
    model.block1_impl=xla`` through ``Trainer.fit`` (the E-step, a
    checkpoint), then ``eval`` of that checkpoint; small sizes on the
    CPU."""
    from em_adapt_torch.__main__ import main

    small = ["--device", "cpu", f"model.width_multiplier={WIDTH}", "model.input_size=(33,33)",
             f"model.name={NAME}", "model.block1_impl=xla", f"checkpoint.save_dir={tmp_path}",
             "eval.batch_size=2", "data.num_workers=1"]
    assert main(["train", "--synthetic", "4", "--steps", "2", "--preset", "gpu-perf-fold", *small,
                 "train.batch_size=2", "data.train_label_size=(5,5)",
                 "train.calibrate_estep=false", "checkpoint.save_every_steps=2"]) == 0
    assert "done at step 2" in capsys.readouterr().out
    assert main(["eval", "--synthetic", "2", "--fixed-size", *small]) == 0
    out = capsys.readouterr().out
    assert "evaluating checkpoint step 2" in out and "mIoU = " in out


def _mesh(model_shards: int = 1, space_shards: int = 1):
    from em_adapt_torch.parallel.mesh import MeshPlan

    plan = MeshPlan()
    plan.sizes.update(model=model_shards, space=space_shards)
    return plan


@pytest.mark.parametrize("path,match", [
    ("block1_pallas", "block1_impl='pallas'"),
    ("model_axis", "'model' axis"),
    ("space_axis", "'space' axis"),
    ("int8", "int8 PTQ"),
    ("tf_import", "TF1 checkpoint import"),
    ("npy_export", "npy interchange"),
])
def test_vgg_only_paths_refuse_the_resnet_by_name(path, match):
    model = get_model(NAME)(SMALL)
    with pytest.raises(ValueError, match=match) as err:
        if path == "block1_pallas":
            get_model(NAME)(dataclasses.replace(SMALL, block1_impl="pallas"))
        elif path == "model_axis":
            get_model(NAME)(SMALL, plan=_mesh(model_shards=2))
        elif path == "space_axis":
            get_model(NAME)(SMALL, plan=_mesh(space_shards=3))
        elif path == "int8":
            from em_adapt_torch.eval.quantize import quantize_model

            quantize_model(SMALL, model, [_images(0, 33).numpy()])
        elif path == "tf_import":
            from em_adapt_torch.models.tf_import import load_tf_checkpoint_params

            load_tf_checkpoint_params("missing/prefix", SMALL)
        else:
            from em_adapt_torch.eval.export import export_params_npy

            export_params_npy(model, "unused.npy")
    assert NAME in str(err.value)
