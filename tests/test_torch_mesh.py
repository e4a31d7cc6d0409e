"""PyTorch port: training, evaluation and checkpoints on the mesh's space
and model axes (``em_adapt_torch/parallel/``, ``train/trainer.py``,
``train/checkpoint.py``, ``__main__.py``) in worlds of gloo processes on
the CPU (``tests/torch_world.py``), against the port's one process and the
JAX package's meshes on its 8 CPU devices: the counterparts of
``tests/test_parallel.py``. Each world runs every check of its layout.

* (data 2, space 2): one step at keep 1 with JAX's class orders against
  JAX's dp x sp and dp steps (``test_parallel.py:61-87``); the
  semi-supervised loss with uneven valid counts; a tag warm-up step; two
  steps with dropout masks drawn from the seed.
* (data 1, space 2, model 2): one step against JAX's (data 2, space 2,
  model 2) (``:89-117``); checkpoints across layouts (``:119-145``).
* (data 2, model 2): block 1's fused path and K1's plain versions against
  the conv path and the sort E-step (``:147-177``); the periodic eval's
  confusion against one process's (``:305-336``).
* (data 1, space 3) at 33²: with and without remat against one process
  (``:338-376``); ``block1_impl='pallas'`` raises there.
"""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from em_adapt_torch import config as pcfg  # noqa: E402
from em_adapt_torch.parallel.spatial import row_split  # noqa: E402
from tests.torch_world import run_world  # noqa: E402

MODULE = "tests.test_torch_mesh"
MODEL = dict(num_classes=4, fc6_channels=16, width_multiplier=0.125, init_scheme="he")


def _cfg(hw: int, *, keep: float = 1.0, accum: int = 1, semi: bool = False, axes=None,
         **model) -> pcfg.ExperimentConfig:
    mesh = pcfg.MeshConfig() if axes is None else pcfg.MeshConfig(axes=axes)
    return pcfg.ExperimentConfig(
        model=pcfg.ModelConfig(**{**MODEL, "input_size": (hw, hw), **model},
                               dropout_keep_prob=keep),
        data=pcfg.DataConfig(input_size=(hw, hw), num_workers=2, prefetch=0),
        estep=pcfg.EStepConfig(num_iter=2),
        optim=pcfg.OptimConfig(accum_steps=accum, base_lr=0.05),
        train=pcfg.TrainConfig(batch_size=8, seed=0), semi_supervised=semi, mesh=mesh)


def _batch(seed: int, hw: int, semi: bool = False, b: int = 8) -> dict:
    """A global batch whose labels hold 1-2 foreground classes and a void
    band; with ``semi`` rows 0, 1 and 4 are strong, and rows 0-1 (data
    index 0's) are mostly void, so the valid counts are uneven."""
    g = np.random.default_rng(seed)
    img = (g.normal(size=(b, hw, hw, 3)) * 40).astype(np.float32)
    label = np.zeros((b, hw, hw, 1), np.float32)
    for i in range(b):
        label[i, g.integers(0, hw // 2):, : g.integers(hw // 3, hw)] = 1 + i % 3
        label[i, : g.integers(0, hw // 3)] = 2 if i % 2 else 3
    label[:, :3] = 255.0
    out = {"image": img, "label": label}
    if semi:
        out["is_strong"] = np.isin(np.arange(b), [0, 1, b // 2])
        label[:2, :, : hw - 5] = 255.0
    return out


def _params(seed: int, model_cfg) -> dict:
    from em_adapt_torch.models.deeplab import init_params

    return {k: {n: t.numpy() for n, t in v.items()}
            for k, v in init_params(torch.Generator().manual_seed(seed), model_cfg).items()}


def _case(cfg, params, batches, orders=None, masks=None) -> dict:
    return dict(cfg=cfg, params=params, batches=batches, orders=orders, masks=masks)


# --- the rank's part of a global batch -----------------------------------


def _local(case: dict, s: int, plan) -> dict:
    """Step ``s``'s batch and kwargs of ``case`` as this rank holds them:
    its data index's images, its rows of each image (the label whole),
    and its slices of injected masks."""
    from em_adapt_torch.parallel.spatial import my_rows

    def data_rows(x):
        n = x.shape[0] // plan.num_data_shards
        return x[plan.data_index * n:(plan.data_index + 1) * n]

    batch = {k: data_rows(v) for k, v in case["batches"][s].items()}
    batch["image"] = my_rows(torch.from_numpy(batch["image"]), plan, 1).numpy()
    kw = {}
    if case["orders"] is not None:
        kw["orders"] = torch.from_numpy(case["orders"][s])
    if case["masks"] is not None:
        m6, m7 = (torch.from_numpy(data_rows(m)) for m in case["masks"][s])
        c = m6.shape[1] // plan.num_model_shards
        m6 = m6[:, plan.model_index * c:(plan.model_index + 1) * c]
        kw["masks"] = (my_rows(m6, plan, 2), my_rows(m7, plan, 2))
    return batch, kw


def _run(trainer, state, case: dict, local=None) -> list[float]:
    from em_adapt_torch.train.trainer import to_device, train_step

    losses = []
    for s in range(len(case["batches"])):
        if local is None:
            batch = case["batches"][s]
            kw = {k: torch.from_numpy(case[k][s]) if k == "orders" else
                  tuple(torch.from_numpy(m) for m in case[k][s])
                  for k in ("orders", "masks") if case[k] is not None}
        else:
            batch, kw = local(case, s, trainer.plan)
        losses.append(float(train_step(state, to_device(batch, trainer.device), case["cfg"],
                                       **kw)["loss"]))
    return losses


def _whole_params(state) -> dict:
    from em_adapt_torch.models.convert import to_jax_params
    from em_adapt_torch.parallel.tensor import gather_params

    return to_jax_params(gather_params(state.model.state_dict(), state.model.plan))


def _train_world(world, cases):
    """Each case's steps in a fresh Trainer on this rank's part:
    [(losses, whole params gathered over the model axis), ...]."""
    from em_adapt_torch.train.trainer import Trainer

    out = []
    for case in cases:
        trainer = Trainer(case["cfg"], world=world, steps_per_epoch=100)
        state = trainer.init_state()
        state.model.load_params(case["params"])
        losses = _run(trainer, state, case, _local)
        out.append((losses, _whole_params(state)))
    return out


def _train_alone(case: dict):
    from em_adapt_torch.train.trainer import Trainer

    cfg = dataclasses.replace(case["cfg"], mesh=pcfg.MeshConfig())
    trainer = Trainer(cfg, device="cpu", steps_per_epoch=100)
    state = trainer.init_state()
    state.model.load_params(case["params"])
    return _run(trainer, state, case), _whole_params(state)


def _assert_params_close(got, want, rtol=1e-5):
    for name in want:
        for k in ("w", "b"):
            scale = np.abs(want[name][k]).max()
            np.testing.assert_allclose(got[name][k], want[name][k], rtol=rtol,
                                       atol=1e-6 * scale, err_msg=f"{name}.{k}")


def _jax_step(axes, batch: dict, hw: int):
    """(params, class orders, loss) of one step of the JAX package's
    Trainer on the mesh ``axes`` (its init and its own orders, keep 1)."""
    import jax

    import em_adapt_tpu.config as jcfg
    from em_adapt_tpu.ops.estep import make_class_orders as jax_orders
    from em_adapt_tpu.train import Trainer as JaxTrainer

    jc = jcfg.ExperimentConfig(
        model=jcfg.ModelConfig(**MODEL, input_size=(hw, hw), dropout_keep_prob=1.0),
        estep=jcfg.EStepConfig(num_iter=2), optim=jcfg.OptimConfig(accum_steps=1, base_lr=0.05),
        train=jcfg.TrainConfig(batch_size=8, seed=0), mesh=jcfg.MeshConfig(axes=axes))
    trainer = JaxTrainer(jc, steps_per_epoch=100)
    state = trainer.init_state()
    params = jax.tree.map(np.asarray, jax.device_get(state.params))
    rng = jax.random.split(jax.random.fold_in(state.rng, state.step))[0]
    orders = np.array(jax_orders(jax.random.split(rng)[1], 2, 4))
    _, m = trainer.train_step(state, trainer.plan.shard_batch(dict(batch)))
    return params, orders, float(jax.device_get(m["loss"]))


def _world_cases(names_cases: dict, axes, n: int, tmp) -> dict:
    """{name: (case, alone (losses, params), rank results)} of ``names_cases``
    run once alone and once in one world of ``n`` laid out by ``axes``."""
    names = list(names_cases)
    cases = [dict(c, cfg=dataclasses.replace(c["cfg"], mesh=pcfg.MeshConfig(axes=axes)))
             for c in names_cases.values()]
    ranks = run_world(MODULE, "_train_world", n, cases, tmp, timeout=180)
    return {name: (names_cases[name], _train_alone(names_cases[name]), [r[i] for r in ranks])
            for i, name in enumerate(names)}


# --- (data 2, space 2) ---------------------------------------------------

DP_SP = (("data", 2), ("space", 2))


@pytest.fixture(scope="module")
def dp_sp(tmp_path_factory):
    batch = _batch(3, 32)
    params, orders, jax_dpsp = _jax_step((("data", 4), ("space", 2)), batch, 32)
    _, _, jax_dp = _jax_step((("data", 8), ("space", 1)), batch, 32)
    g = np.random.default_rng(5)
    cases = {
        "weak": _case(_cfg(32), params, [batch], [orders]),
        "semi_uneven": _case(_cfg(32, semi=True), params, [_batch(4, 32, semi=True)],
                             [orders]),
        "tag_warmup": _case(dataclasses.replace(_cfg(32), train=pcfg.TrainConfig(
            batch_size=8, seed=0, tag_warmup_steps=1)), params, [_batch(5, 32)], [orders]),
        "drawn": _case(_cfg(32, keep=0.5, accum=2), _params(6, _cfg(32).model),
                       [_batch(6, 32), _batch(7, 32)]),
        "injected": _case(_cfg(32, keep=0.5), params, [_batch(8, 32)], [orders],
                          [tuple(g.uniform(size=(8, 16, 4, 4)) < 0.5 for _ in range(2))]),
    }
    out = _world_cases(cases, DP_SP, 4, tmp_path_factory.mktemp("dpsp"))
    return out, (jax_dpsp, jax_dp)


def test_dp_sp_step_matches_jax_dp_sp_and_dp(dp_sp):
    """(data 2, space 2) at 32², keep 1, JAX's orders: the world's loss is
    JAX's dp x sp loss and its dp loss (rel 1e-5), and the port's one
    process's; the parameters after the step are one process's; every
    rank logs the one loss."""
    out, (jax_dpsp, jax_dp) = dp_sp
    _, (alone, alone_params), ranks = out["weak"]
    assert len({tuple(r[0]) for r in ranks}) == 1
    loss = ranks[0][0][0]
    assert loss == pytest.approx(jax_dpsp, rel=1e-5)
    assert loss == pytest.approx(jax_dp, rel=1e-5)
    assert loss == pytest.approx(alone[0], rel=1e-5)
    _assert_params_close(ranks[0][1], alone_params)


@pytest.mark.parametrize("name", ["semi_uneven", "tag_warmup", "drawn", "injected"])
def test_dp_sp_variants_match_one_process(dp_sp, name):
    """(data 2, space 2) against one process on the same global batches
    (losses rel 1e-5 at every step, parameters after): the semi-supervised
    CE divided by the global valid count when data index 0's strong images
    are mostly void; a tag warm-up step, whose LSE pool takes the whole
    score map gathered with its gradient; keep 0.5 with the masks drawn
    from the seed (each rank its images and rows of the world's masks) over
    two accumulated steps; keep 0.5 with injected masks."""
    out, _ = dp_sp
    case, (alone, alone_params), ranks = out[name]
    for r in ranks:
        np.testing.assert_allclose(r[0], alone, rtol=1e-5)
    _assert_params_close(ranks[0][1], alone_params)
    if name == "semi_uneven":
        b = case["batches"][0]
        lab, strong = b["label"][..., 0], b["is_strong"]
        valid = [(lab[:4][strong[:4]] < 4).sum(), (lab[4:][strong[4:]] < 4).sum()]
        assert valid[0] < valid[1] / 2
    if name == "drawn":
        params = case["params"]
        assert min(np.abs(alone_params[n]["w"] - params[n]["w"]).max() for n in params) > 0


# --- (data 1, space 2, model 2): JAX's tp step; checkpoints across layouts

TP = (("data", 1), ("space", 2), ("model", 2))


def _tp_world(world, p):
    """One step against JAX's; then a checkpoint of one process restored
    into the world, one more step, and the world's checkpoint."""
    from em_adapt_torch.train.checkpoint import CheckpointManager
    from em_adapt_torch.train.trainer import Trainer

    (losses, params), = _train_world(world, [p["case"]])
    cfg = p["case"]["cfg"]
    trainer = Trainer(cfg, world=world, steps_per_epoch=100)
    state = trainer.init_state()
    CheckpointManager(dataclasses.replace(cfg.checkpoint, save_dir=p["one"])).restore(state)
    restored = {k: v.clone() for k, v in state.state_dict()["params"].items()}
    momentum = [None if t is None else t.clone()
                for t in state.optimizer.state_dict()["momentum"]]
    step = _run(trainer, state, dict(p["case"], batches=[p["next"]], orders=[p["orders"]]),
                _local)
    mgr = CheckpointManager(dataclasses.replace(cfg.checkpoint, save_dir=p["world"]), world=world)
    mgr.save(state, "norm")
    shards = {k: v.clone() for k, v in state.state_dict()["params"].items()}
    return dict(losses=losses, params=params, restored=restored, momentum=momentum, step=step,
                shards=shards, plan=(state.model.plan.model_index, state.model.plan.space_index))


@pytest.fixture(scope="module")
def tp_world(tmp_path_factory):
    from em_adapt_torch.train.checkpoint import CheckpointManager
    from em_adapt_torch.train.trainer import Trainer, to_device, train_step

    tmp = tmp_path_factory.mktemp("tp")
    batch = _batch(9, 32)
    params, orders, jax_loss = _jax_step((("data", 2), ("space", 2), ("model", 2)), batch, 32)
    case = _case(_cfg(32), params, [batch], [orders])
    cfg = case["cfg"]
    trainer = Trainer(cfg, device="cpu", steps_per_epoch=100)
    state = trainer.init_state()
    state.model.load_params(params)
    train_step(state, to_device(_batch(10, 32), "cpu"), cfg, orders=torch.from_numpy(orders))
    CheckpointManager(dataclasses.replace(cfg.checkpoint, save_dir=str(tmp / "one"))).save(state)
    one = {"params": {k: v.clone() for k, v in state.state_dict()["params"].items()},
           "optimizer": {"momentum": [t.clone() for t in
                                      state.optimizer.state_dict()["momentum"]]}}
    nxt = _batch(11, 32)
    one_step = float(train_step(state, to_device(nxt, "cpu"), cfg,
                                orders=torch.from_numpy(orders))["loss"])
    payload = dict(case=dict(case, cfg=dataclasses.replace(cfg, mesh=pcfg.MeshConfig(axes=TP))),
                   one=str(tmp / "one"), world=str(tmp / "world"), next=nxt, orders=orders)
    ranks = run_world(MODULE, "_tp_world", 4, payload, tmp, timeout=180)
    return dict(jax=jax_loss, alone=_train_alone(case), ranks=ranks, one=one,
                one_step=one_step, one_state=state, dir=tmp)


def test_dp_sp_tp_step_matches_jax(tp_world):
    """(data 1, space 2, model 2), 4 processes: the loss of one step is
    JAX's (data 2, space 2, model 2) loss within abs 2e-5 and one
    process's within rel 1e-5; the whole parameters after it, gathered
    over the model axis, are one process's."""
    ranks = tp_world["ranks"]
    alone, alone_params = tp_world["alone"]
    for r in ranks:
        assert r["losses"][0] == pytest.approx(tp_world["jax"], abs=2e-5)
        assert r["losses"][0] == pytest.approx(alone[0], rel=1e-5)
    _assert_params_close(ranks[0]["params"], alone_params)


def test_checkpoints_restore_across_layouts_bit_for_bit(tp_world):
    """One process's checkpoint restores into the model = 2 world as each
    model rank's slices of it, bit for bit (parameters and momentum); the
    world's next step is one process's next step (rel 1e-5); the world's
    checkpoint holds the whole model, its fc6/fc7 leaves the ranks' shards
    put together bit for bit, and restores into one process bit for bit."""
    from em_adapt_torch.parallel.mesh import MeshPlan
    from em_adapt_torch.parallel.tensor import shard_dims
    from em_adapt_torch.train.checkpoint import CheckpointManager
    from em_adapt_torch.train.state import bitwise_diff
    from em_adapt_torch.train.trainer import Trainer

    one, ranks = tp_world["one"], tp_world["ranks"]
    dims = shard_dims(one["params"])
    for r in ranks:
        m = r["plan"][0]
        for k, t in one["params"].items():
            want = t if k not in dims else t.chunk(2, dims[k])[m]
            assert not bitwise_diff(r["restored"][k], want.contiguous()), k
        for i, (k, t) in enumerate(one["params"].items()):
            want = one["optimizer"]["momentum"][i]
            want = want if k not in dims else want.chunk(2, dims[k])[m]
            assert not bitwise_diff(r["momentum"][i], want.contiguous()), k
        assert r["step"][0] == pytest.approx(tp_world["one_step"], rel=1e-5)
    cfg = _cfg(32)
    mgr = CheckpointManager(dataclasses.replace(cfg.checkpoint,
                                                save_dir=str(tp_world["dir"] / "world")))
    saved = mgr.load("norm")
    for k, dim in dims.items():
        parts = [r["shards"][k] for r in ranks if r["plan"][1] == 0]
        assert not bitwise_diff(saved["params"][k], torch.cat(parts, dim)), k
    state = Trainer(cfg, device="cpu", steps_per_epoch=100).init_state()
    assert state.model.plan.num_model_shards == 1 and isinstance(state.model.plan, MeshPlan)
    mgr.restore(state)
    assert not bitwise_diff(state.state_dict()["params"], saved["params"])
    assert not bitwise_diff(state.optimizer.state_dict()["momentum"],
                            saved["optimizer"]["momentum"])
    assert saved["params"]["layers.fc6.weight"].shape[0] == 16


# --- (data 2, model 2): the kernels' plain paths; eval -------------------

DP_TP = (("data", 2), ("space", 1), ("model", 2))


def _dp_tp_world(world, p):
    """The step with block 1 fused and K1 against the conv path and the
    sort E-step; then the periodic eval's confusion."""
    from em_adapt_torch import __main__ as cli
    from em_adapt_torch.train.trainer import Trainer

    out = {"steps": _train_world(world, p["cases"])}
    cfg = p["cases"][0]["cfg"]
    trainer = Trainer(cfg, world=world, steps_per_epoch=100)
    state = trainer.init_state()
    state.model.load_params(p["cases"][0]["params"])
    seen = []
    real = cli.miou_from_confusion
    cli.miou_from_confusion = lambda c: (seen.append(c), real(c))[1]
    try:
        out["miou"] = cli.make_eval_fn(cfg, p["args"], trainer.device, world, trainer.plan)(state)
    finally:
        cli.miou_from_confusion = real
    out["confusion"] = seen[0]
    return out


@pytest.fixture(scope="module")
def dp_tp(tmp_path_factory):
    batch = _batch(12, 33)
    params = _params(13, _cfg(33).model)
    orders = [np.stack([np.random.default_rng(14).permutation(3) + 1 for _ in range(2)])
              .astype(np.int32)]
    fused = _cfg(33, block1_impl="pallas")
    fused = dataclasses.replace(fused, estep=pcfg.EStepConfig(num_iter=2, impl="pallas"))
    conv = _cfg(33, block1_impl="xla")
    conv = dataclasses.replace(conv, estep=pcfg.EStepConfig(num_iter=2, impl="jax"))
    cases = [_case(dataclasses.replace(c, mesh=pcfg.MeshConfig(axes=DP_TP)), params, [batch],
                   orders) for c in (fused, conv)]
    args = types.SimpleNamespace(synthetic=8, synthetic_val=5, synthetic_learnable=True)
    ranks = run_world(MODULE, "_dp_tp_world", 4, dict(cases=cases, args=args),
                      tmp_path_factory.mktemp("dptp"), timeout=180)
    return cases, args, ranks


def test_dp_tp_fused_block1_and_k1_match_conv_path(dp_tp):
    """(data 2, model 2) at 33²: block 1 fused (K2/K3's plain versions
    here) with K1's plain version gives the conv path's and the sort
    E-step's loss within abs 2e-5 (``test_parallel.py:147-177``), and the
    conv path gives one process's within rel 1e-5."""
    cases, _, ranks = dp_tp
    (fused, _), (conv, conv_params) = ranks[0]["steps"]
    assert fused[0] == pytest.approx(conv[0], abs=2e-5)
    alone, alone_params = _train_alone(dict(cases[1], cfg=dataclasses.replace(
        cases[1]["cfg"], mesh=pcfg.MeshConfig())))
    assert conv[0] == pytest.approx(alone[0], rel=1e-5)
    _assert_params_close(conv_params, alone_params)


def test_dp_tp_eval_confusion_equals_one_process(dp_tp):
    """The periodic eval under (data 2, model 2) on 5 images (3 and 2 a data
    index, each model rank pair evaluating together): every rank's summed
    confusion is one process's bit for bit, each image counted once, and
    so is the mIoU."""
    from em_adapt_torch import __main__ as cli
    from em_adapt_torch.train.trainer import Trainer

    cases, args, ranks = dp_tp
    cfg = dataclasses.replace(cases[0]["cfg"], mesh=pcfg.MeshConfig())
    state = Trainer(cfg, device="cpu", steps_per_epoch=100).init_state()
    state.model.load_params(cases[0]["params"])
    seen = []
    real = cli.miou_from_confusion
    cli.miou_from_confusion = lambda c: (seen.append(c), real(c))[1]
    try:
        miou = cli.make_eval_fn(cfg, args, torch.device("cpu"))(state)
    finally:
        cli.miou_from_confusion = real
    assert seen[0].sum() > 0
    for r in ranks:
        np.testing.assert_array_equal(r["confusion"], seen[0])
        assert r["miou"] == miou


# --- (data 1, space 3) at 33²: remat -------------------------------------

SP3 = (("data", 1), ("space", 3))


def _sp3_world(world, p):
    """The remat and plain steps; then block1_impl='pallas', which raises."""
    from em_adapt_torch.train.trainer import Trainer, to_device, train_step

    out = {"steps": _train_world(world, p["cases"])}
    case = p["cases"][0]
    cfg = dataclasses.replace(case["cfg"], model=dataclasses.replace(case["cfg"].model,
                                                                     block1_impl="pallas"))
    trainer = Trainer(cfg, world=world, steps_per_epoch=100)
    state = trainer.init_state()
    batch, kw = _local(case, 0, trainer.plan)
    try:
        train_step(state, to_device(batch, trainer.device), cfg, **kw)
    except ValueError as e:
        out["pallas"] = str(e)
    return out


@pytest.fixture(scope="module")
def sp3(tmp_path_factory):
    batch = _batch(15, 33)
    params = _params(16, _cfg(33).model)
    orders = [np.stack([np.random.default_rng(17).permutation(3) + 1 for _ in range(2)])
              .astype(np.int32)]
    cases = [_case(dataclasses.replace(_cfg(33, remat=remat), mesh=pcfg.MeshConfig(axes=SP3)),
                   params, [batch], orders) for remat in (True, False)]
    ranks = run_world(MODULE, "_sp3_world", 3, dict(cases=cases), tmp_path_factory.mktemp("sp3"),
                      timeout=180)
    return cases, ranks


def test_sp3_remat_matches_no_remat_and_one_process(sp3):
    """(data 1, space 3) at 33² (11 image rows a rank; the score map's 5
    rows as 2, 2 and 1): the step with remat, which repeats each block's
    halo exchanges in the backward, equals the step without and one
    process's (rel 1e-5), and so do the parameters after it."""
    cases, ranks = sp3
    (remat, remat_params), (plain, plain_params) = ranks[0]["steps"]
    alone, alone_params = _train_alone(dict(cases[0], cfg=dataclasses.replace(
        cases[0]["cfg"], mesh=pcfg.MeshConfig())))
    assert remat[0] == pytest.approx(plain[0], rel=1e-5)
    assert remat[0] == pytest.approx(alone[0], rel=1e-5)
    _assert_params_close(remat_params, alone_params)
    _assert_params_close(plain_params, alone_params)
    assert row_split(5, 3) == [(0, 2), (2, 4), (4, 5)]


def test_sp3_fused_block1_raises(sp3):
    """``model.block1_impl='pallas'`` on a space axis above 1 raises, naming
    the missing halo exchange ("auto" takes the conv path there)."""
    _, ranks = sp3
    for r in ranks:
        assert "no halo exchange" in r["pallas"]


# --- checks without a world ----------------------------------------------


def test_indivisible_image_raises_jax_error_and_41_row_label_is_kept_whole():
    """An image whose height does not divide over the space axis raises the
    JAX package's error in the Trainer and in the input pipeline
    (``test_parallel.py:47-59``); under space 3 a 33-row image splits into
    11-row strips that stack to the one-process image, while the
    host-shrunk 41-row label stays whole on every space rank."""
    from em_adapt_torch.data.pipeline import SyntheticVOC, batch_iterator
    from em_adapt_torch.parallel.mesh import World
    from em_adapt_torch.train.trainer import Trainer

    world = World(rank=0, size=3, local_rank=0, device=torch.device("cpu"))
    cfg = _cfg(32, axes=(("data", 1), ("space", 3)))
    with pytest.raises(ValueError, match="image height 32 is not divisible by the space axis"):
        Trainer(cfg, world=world)
    with pytest.raises(ValueError, match="not divisible by the data axis"):
        Trainer(_cfg(33, axes=(("data", 3), ("space", 1))), world=world)
    data = pcfg.DataConfig(input_size=(33, 33), num_workers=2, train_label_size=(41, 41))
    ds = SyntheticVOC(8, 4, seed=1)
    whole = next(batch_iterator(ds, data, batch_size=2))
    parts = [next(batch_iterator(ds, data, batch_size=2, row_shard=(s, 3))) for s in range(3)]
    np.testing.assert_array_equal(np.concatenate([p["image"] for p in parts], 1), whole["image"])
    for p in parts:
        assert p["image"].shape[1] == 11 and p["image"].flags.c_contiguous
        np.testing.assert_array_equal(p["label"], whole["label"])
        assert p["label"].shape[1] == 41
    with pytest.raises(ValueError, match="image height 32 is not divisible"):
        next(batch_iterator(ds, dataclasses.replace(data, input_size=(32, 32)), batch_size=2,
                            row_shard=(0, 3)))


def test_native_estep_raise_keys_on_data_times_space_and_spatial_hint():
    """``estep.impl='native'`` raises where the batch is split over data x
    space, not on a model axis alone; the spatial-mesh hint names an input
    of 513² on several processes with space 1, as JAX's does."""
    from em_adapt_torch.ops.estep import estep_labels
    from em_adapt_torch.parallel.mesh import MeshPlan
    from em_adapt_torch.train.trainer import config_hints

    def plan(d, s, m):
        return MeshPlan(sizes={"data": d, "space": s, "model": m})

    scores, label = torch.zeros(1, 5, 5, 4), torch.zeros(1, 5, 5)
    orders = torch.tensor([[1, 2, 3], [3, 2, 1]], dtype=torch.int32)
    for p in (plan(2, 1, 1), plan(1, 2, 1), plan(1, 3, 2)):
        with pytest.raises(ValueError, match="native"):
            estep_labels(scores, label, orders, pcfg.EStepConfig(num_iter=2, impl="native"), p)
    hi = _cfg(513)
    assert "space=1 on a 4-process mesh" in config_hints(hi, plan(2, 1, 2))[0]
    assert config_hints(hi, plan(1, 3, 1)) == []
    assert config_hints(hi) == [] and config_hints(_cfg(321), plan(4, 1, 1)) == []
