"""PyTorch port: data-parallel training over processes
(``em_adapt_torch/parallel/mesh.py``): the mesh's axis sizes, a world of
gloo processes on the CPU against the port's one-process step and the JAX
package's 8-device data-parallel step, the E-step's world batch max, the
uniform preemption stop and the process-sharded confusion matrices.

Each world is ``n`` fresh processes (``tests/torch_world.py::run_world``)
that join a gloo group through a FileStore under the test's ``tmp_path``
and run one of this module's workers on a pickled payload; the parent
kills them after a timeout of their own, so a hung rendezvous fails one
test."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from em_adapt_torch import config as pcfg  # noqa: E402
from em_adapt_torch.config import MeshConfig  # noqa: E402
from em_adapt_torch.parallel.mesh import resolve_axis_sizes  # noqa: E402
from tests.torch_world import run_world as _run_world  # noqa: E402


# --- worlds of processes -------------------------------------------------


def run_world(worker: str, n: int, payload, tmp_path, timeout: float = 120.0) -> list:
    """``tests/torch_world.py::run_world`` of a worker of this module."""
    return _run_world("tests.test_torch_parallel", worker, n, payload, tmp_path, timeout)


def rows(x, rank: int, n: int):
    """Rank ``rank``'s rows of a global batch."""
    b = x.shape[0] // n
    return x[rank * b:(rank + 1) * b]


# --- mesh axes -----------------------------------------------------------


def test_resolve_axis_sizes_auto_size_and_errors_match_jax():
    """-1 takes the devices left (the JAX function's answers on the same
    configs); an indivisible split and two -1 axes raise."""
    from em_adapt_tpu.config import MeshConfig as JaxMesh
    from em_adapt_tpu.parallel.mesh import resolve_axis_sizes as jax_resolve

    for axes, n in (((("data", -1), ("space", 1)), 8), ((("data", -1), ("space", 1)), 1),
                    ((("data", 4), ("space", 1)), 4), ((("data", 2), ("space", -1)), 8)):
        assert resolve_axis_sizes(MeshConfig(axes=axes), n) == jax_resolve(JaxMesh(axes=axes), n)
    with pytest.raises(ValueError, match="not divisible"):
        resolve_axis_sizes(MeshConfig(axes=(("data", 3), ("space", -1))), 8)
    with pytest.raises(ValueError, match="at most one"):
        resolve_axis_sizes(MeshConfig(axes=(("data", -1), ("space", -1))), 8)


def test_mesh_config_defaults_match_jax_and_unported_axes_raise():
    """MeshConfig's defaults are the JAX package's; space and model axes
    above 1 are accepted in training and in eval (both are ported: the
    name is kept from when they raised); an unknown axis and a size of 0
    or below -1 raise; the axes must use exactly the world; the layout is
    row-major in the order of the axes, the model axis innermost, as JAX's
    ``make_mesh`` reshapes the devices."""
    import dataclasses

    from em_adapt_torch.parallel.mesh import data_axis_size, mesh_layout
    from em_adapt_tpu.config import MeshConfig as JaxMesh
    from em_adapt_tpu.parallel.mesh import make_mesh

    for f in dataclasses.fields(MeshConfig):
        assert getattr(MeshConfig(), f.name) == getattr(JaxMesh(), f.name)
    base = pcfg.ExperimentConfig()
    for axes in ('(("data",4),("space",1))', '(("data",-1),("space",3))',
                 '(("data",-1),("space",1),("model",2))', '(("data",1),("space",2),("model",2))'):
        cfg = pcfg.apply_overrides(base, [f"mesh.axes={axes}"])
        for mode in ("train", "eval"):
            pcfg.check_supported(cfg, mode)
    with pytest.raises(ValueError, match="unknown axis"):
        pcfg.check_mesh(MeshConfig(axes=(("batch", -1),)))
    for size in (0, -2):
        with pytest.raises(ValueError, match="expected -1 or >= 1"):
            pcfg.check_mesh(MeshConfig(axes=(("data", -1), ("model", size))))
    assert data_axis_size(MeshConfig(), 4) == 4
    with pytest.raises(ValueError, match="use 2 devices, have 4"):
        data_axis_size(MeshConfig(axes=(("data", 2), ("space", 1))), 4)
    axes = (("data", 2), ("space", 2), ("model", 2))
    jax_mesh = make_mesh(JaxMesh(axes=axes)).mesh
    import jax

    ids = np.vectorize(lambda d: d.id)(jax_mesh.devices)
    for rank in range(8):
        sizes, coords = mesh_layout(MeshConfig(axes=axes), 8, rank)
        assert sizes == {"data": 2, "space": 2, "model": 2}
        where = np.argwhere(ids == jax.devices()[rank].id)[0]
        assert (coords["data"], coords["space"], coords["model"]) == tuple(where)
    assert mesh_layout(MeshConfig(axes=(("model", 2), ("data", 2))), 4, 1)[1] == {
        "data": 1, "space": 0, "model": 0}


# --- the training step ---------------------------------------------------

MODEL = dict(num_classes=4, input_size=(33, 33), fc6_channels=16, width_multiplier=0.125,
             init_scheme="he")


def _configs(keep: float, accum: int, semi: bool, batch: int = 8):
    import em_adapt_tpu.config as jcfg

    def build(mod, **extra):
        return mod.ExperimentConfig(
            model=mod.ModelConfig(**MODEL, dropout_keep_prob=keep),
            estep=mod.EStepConfig(num_iter=2),
            optim=mod.OptimConfig(accum_steps=accum, base_lr=0.05),
            train=mod.TrainConfig(batch_size=batch, seed=0), semi_supervised=semi, **extra)

    return (build(jcfg, mesh=jcfg.MeshConfig(axes=(("data", 8), ("space", 1)))), build(pcfg))


def _batch(seed: int, semi: bool, b: int = 8, hw: int = 33) -> dict:
    """A global batch of ``b`` rows whose labels hold 1-2 foreground classes
    and a void band; with ``semi`` the first rows of each half are strong,
    and the first half's strong images carry far more void pixels than the
    second half's (uneven valid counts across two ranks)."""
    g = np.random.default_rng(seed)
    img = (g.normal(size=(b, hw, hw, 3)) * 40).astype(np.float32)
    label = np.zeros((b, hw, hw, 1), np.float32)
    for i in range(b):
        label[i, g.integers(0, hw // 2):, : g.integers(hw // 3, hw)] = 1 + i % 3
        label[i, : g.integers(0, hw // 3)] = 2 if i % 2 else 3
    label[:, :3] = 255.0
    out = {"image": img, "label": label}
    if semi:
        strong = np.zeros(b, bool)
        strong[[0, 1, b // 2]] = True
        label[:2, :, : hw - 5] = 255.0  # rank 0's strong images: mostly void
        out["is_strong"] = strong
    return out


def _train_world(world, payloads):
    """For each payload, ``p["steps"]`` train steps of a fresh port Trainer
    in the world on this rank's rows: [(losses, final params), ...]."""
    from em_adapt_torch.models.convert import to_jax_params
    from em_adapt_torch.train.trainer import Trainer, to_device, train_step

    out = []
    for p in payloads:
        trainer = Trainer(p["cfg"], world=world, steps_per_epoch=100)
        state = trainer.init_state()
        state.model.load_params(p["params"])
        losses = []
        for s in range(p["steps"]):
            batch = {k: rows(v, world.rank, world.size) for k, v in p["batches"][s].items()}
            kw = {}
            if p["orders"] is not None:
                kw["orders"] = torch.from_numpy(p["orders"][s])
            if p["masks"] is not None:
                kw["masks"] = tuple(torch.from_numpy(rows(m, world.rank, world.size))
                                    for m in p["masks"][s])
            losses.append(float(train_step(state, to_device(batch, trainer.device), p["cfg"],
                                           **kw)["loss"]))
        out.append((losses, to_jax_params(state.model)))
    return out


def _train_alone(p):
    """The same steps in this process on the whole batch: (losses, params)."""
    from em_adapt_torch.models.convert import to_jax_params
    from em_adapt_torch.train.trainer import Trainer, to_device, train_step

    trainer = Trainer(p["cfg"], device="cpu", steps_per_epoch=100)
    state = trainer.init_state()
    state.model.load_params(p["params"])
    losses = []
    for s in range(p["steps"]):
        kw = {}
        if p["orders"] is not None:
            kw["orders"] = torch.from_numpy(p["orders"][s])
        if p["masks"] is not None:
            kw["masks"] = tuple(torch.from_numpy(m) for m in p["masks"][s])
        losses.append(float(train_step(state, to_device(p["batches"][s], "cpu"), p["cfg"],
                                       **kw)["loss"]))
    return losses, to_jax_params(state.model)


def _assert_params_close(got, want, rtol=1e-5):
    for name in want:
        for k in ("w", "b"):
            scale = np.abs(want[name][k]).max()
            np.testing.assert_allclose(got[name][k], want[name][k], rtol=rtol,
                                       atol=1e-6 * scale, err_msg=f"{name}.{k}")


def _port_params(seed: int, model_cfg) -> dict:
    from em_adapt_torch.models.deeplab import init_params

    return {k: {n: t.numpy() for n, t in v.items()}
            for k, v in init_params(torch.Generator().manual_seed(seed), model_cfg, None).items()}


def _jax_case(semi: bool) -> tuple[dict, float]:
    """(the port's payload, the JAX loss) of one step at keep 1 from the
    JAX package's 8-device data-parallel Trainer: its init, its own class
    orders (trainer.py:168, :189, :238), one global batch of 8."""
    import jax

    from em_adapt_tpu.ops.estep import make_class_orders as jax_orders
    from em_adapt_tpu.train import Trainer as JaxTrainer

    jc, pc = _configs(keep=1.0, accum=1, semi=semi)
    jtrainer = JaxTrainer(jc, steps_per_epoch=100)
    jstate = jtrainer.init_state()
    params = jax.tree.map(np.asarray, jax.device_get(jstate.params))
    rng = jax.random.split(jax.random.fold_in(jstate.rng, jstate.step))[0]
    orders = np.array(jax_orders(jax.random.split(rng)[1], 2, 4))
    batch = _batch(3, semi)
    _, jmetrics = jtrainer.train_step(jstate, jtrainer.plan.shard_batch(dict(batch)))
    payload = dict(cfg=pc, params=params, batches=[batch], orders=[orders], masks=None, steps=1)
    return payload, float(jax.device_get(jmetrics["loss"]))


@pytest.fixture(scope="module")
def train_cases(tmp_path_factory):
    """Every training case, run once alone and once in one world of 2:
    {name: (payload, JAX loss or None, (losses, params) alone,
    [(losses, params) of rank 0, of rank 1])}."""
    cases = {name: _jax_case(semi) for name, semi in (("weak", False), ("semi_uneven", True))}
    _, pc = _configs(keep=0.5, accum=2, semi=False)
    cases["drawn"] = (dict(cfg=pc, params=_port_params(5, pc.model),
                           batches=[_batch(4, False), _batch(5, False)], orders=None,
                           masks=None, steps=2), None)
    _, pc = _configs(keep=0.5, accum=1, semi=False)
    g = np.random.default_rng(9)
    masks = [tuple(g.uniform(size=(8, 16, 5, 5)) < 0.5 for _ in range(2))]
    orders = [np.stack([g.permutation(3) + 1 for _ in range(2)]).astype(np.int32)]
    cases["injected"] = (dict(cfg=pc, params=_port_params(6, pc.model),
                              batches=[_batch(6, False)], orders=orders, masks=masks,
                              steps=1), None)
    names = list(cases)
    ranks = run_world("_train_world", 2, [cases[n][0] for n in names],
                      tmp_path_factory.mktemp("train"))
    return {n: (cases[n][0], cases[n][1], _train_alone(cases[n][0]), [r[i] for r in ranks])
            for i, n in enumerate(names)}


@pytest.mark.parametrize("name", ["weak", "semi_uneven"])
def test_world2_step_matches_one_process_and_jax_data_parallel_step(train_cases, name):
    """f32, keep 1, JAX's own class orders: one step of a world of 2 gloo
    processes (4 rows each) equals the port's one-process step on the 8
    rows (loss rel 1e-5, every updated parameter) and the JAX package's
    step on an 8-device data mesh (loss rel 1e-5). Under semi-supervision
    rank 0's strong images are mostly void: the loss is normalized by the
    world's valid-pixel count, as JAX's by the global batch's."""
    payload, jax_loss, (alone_losses, alone_params), [(l0, p0), (l1, p1)] = train_cases[name]
    assert l0 == l1  # the logged loss is the world's mean, the same on both ranks
    assert l0[0] == pytest.approx(alone_losses[0], rel=1e-5)
    assert l0[0] == pytest.approx(jax_loss, rel=1e-5)
    _assert_params_close(p0, alone_params)
    for layer in p0:  # the ranks hold one model
        for k in ("w", "b"):
            np.testing.assert_array_equal(p0[layer][k], p1[layer][k])
    if name == "semi_uneven":  # the local count would weigh rank 0's few valid pixels up
        batch = payload["batches"][0]
        lab, strong = batch["label"][..., 0], batch["is_strong"]
        valid = [(lab[:4][strong[:4]] < 4).sum(), (lab[4:][strong[4:]] < 4).sum()]
        assert valid[0] < valid[1] / 2


def test_world2_draws_the_one_process_masks_and_orders(train_cases):
    """keep 0.5, accumulation 2, nothing injected: two steps of a world of
    2 draw from their one seed the masks and orders that one process draws
    for the whole batch (each rank keeps its rows of the world batch's
    masks), so losses and the updated parameters agree with the
    one-process run's."""
    payload, _, (alone_losses, alone_params), [(l0, p0), _] = train_cases["drawn"]
    np.testing.assert_allclose(l0, alone_losses, rtol=1e-5)
    _assert_params_close(p0, alone_params)
    params = payload["params"]
    assert min(np.abs(alone_params[n]["w"] - params[n]["w"]).max() for n in params) > 0


def test_world2_injected_masks_are_the_one_process_rows(train_cases):
    """keep 0.5 with the global batch's masks injected (each rank its
    rows) and the orders injected: the world of 2 equals one process."""
    _, _, (alone_losses, alone_params), [(l0, p0), _] = train_cases["injected"]
    assert l0[0] == pytest.approx(alone_losses[0], rel=1e-5)
    _assert_params_close(p0, alone_params)


# --- the E-step's batch max; the uniform stop ----------------------------

ESTEP_CASES = {
    "k1": dict(),
    "sort": dict(impl="jax"),
    "fixed": dict(method="fixed"),
}


def _gmax_batch():
    """Scores [4,7,7,5] and labels: rank 0's rows are all negative, and its
    first image is all void (no tag), whose labels then hang on the batch
    max alone; rank 1's second image holds the batch's largest score."""
    g = np.random.default_rng(11)
    scores = g.normal(size=(4, 7, 7, 5)).astype(np.float32)
    scores[:2] = -np.abs(scores[:2]) - 1.0
    scores[3, 2, 3, 1] = 40.0
    label = g.integers(0, 5, size=(4, 7, 7)).astype(np.float32)
    label[0] = 255.0
    orders = np.stack([g.permutation(4) + 1 for _ in range(2)]).astype(np.int32)
    return scores, label, orders


def _estep_world(world, p):
    """Each rank's weak labels of its rows for every case; then the stop
    agreement: rank 1 alone is signalled and proposes the later step."""
    from em_adapt_torch.ops.estep import estep_labels
    from em_adapt_torch.parallel.mesh import make_plan
    from em_adapt_torch.utils.failure import GracefulShutdown

    scores, label, orders = p["inputs"]
    out = {}
    for name, kw in ESTEP_CASES.items():
        cfg = pcfg.EStepConfig(num_iter=2, **kw)
        out[name] = estep_labels(torch.from_numpy(rows(scores, world.rank, world.size)),
                                 torch.from_numpy(rows(label, world.rank, world.size)),
                                 torch.from_numpy(orders), cfg).numpy()
    with pytest.raises(ValueError, match="native"):
        estep_labels(torch.from_numpy(scores), torch.from_numpy(label), torch.from_numpy(orders),
                     pcfg.EStepConfig(num_iter=2, impl="native"), make_plan(MeshConfig(), world))
    shutdown = GracefulShutdown()
    before = shutdown.requested_uniform()
    if world.rank == 1:
        shutdown._flag.set()
    after = shutdown.requested_uniform()
    out["stop"] = (before, after, shutdown.requested,
                   shutdown.agreed_stop_step(3 if world.rank == 0 else 5))
    return out


def test_world_batch_max_and_uniform_stop(tmp_path):
    """Each rank's weak labels equal its rows of the one-process labels
    pixel for pixel (the K1 path, the sort reference, EM-Fixed), because
    the batch max is the world's; the local max gives other labels on
    rank 0's void image, so the all-reduce is what this holds. The native
    E-step raises in the world. A SIGTERM flag on rank 1 alone is seen by
    both ranks at the same poll, and the stop step is the later proposal."""
    from em_adapt_torch.ops.estep import estep_labels

    scores, label, orders = _gmax_batch()
    r0, r1 = run_world("_estep_world", 2, {"inputs": (scores, label, orders)}, tmp_path)
    for name, kw in ESTEP_CASES.items():
        cfg = pcfg.EStepConfig(num_iter=2, **kw)
        whole = estep_labels(torch.from_numpy(scores), torch.from_numpy(label),
                             torch.from_numpy(orders), cfg).numpy()
        np.testing.assert_array_equal(r0[name], whole[:2], err_msg=name)
        np.testing.assert_array_equal(r1[name], whole[2:], err_msg=name)
        local = estep_labels(torch.from_numpy(scores[:2]), torch.from_numpy(label[:2]),
                             torch.from_numpy(orders), cfg).numpy()
        assert (local[0] != whole[0]).mean() > 0.5, name
    assert r0["stop"] == (False, True, False, 5)
    assert r1["stop"] == (False, True, True, 5)


def test_requested_uniform_single_process_matches_local_flag():
    """One process: requested_uniform is the local flag, agreed_stop_step
    the proposal (``tests/test_failure.py:237``)."""
    from em_adapt_torch.utils.failure import GracefulShutdown

    s = GracefulShutdown()
    assert s.requested_uniform() is False
    s._flag.set()
    assert s.requested_uniform() is True
    assert s.agreed_stop_step(7) == 7


# --- process-sharded evaluation ------------------------------------------


def _int8_world(world, p):
    """The int8 model (pickled whole) on this rank's rows of a batch: its
    fixed-protocol confusion matrix summed over the world, and its
    predictions."""
    from em_adapt_torch.eval.predict import Evaluator
    from em_adapt_torch.parallel.mesh import make_plan

    ev = Evaluator(p["cfg"], p["qmodel"])
    image, label = (rows(p[k], world.rank, world.size) for k in ("image", "label"))
    batches = [{"image": image[i:i + 2], "label": label[i:i + 2]}
               for i in range(0, len(image), 2)]
    return (world.sum_host(ev.confusion_fixed(batches), make_plan(MeshConfig(), world)),
            ev.predict_batch(image).numpy())


def test_sharded_confusion_sums_to_full_and_jax(tmp_path):
    """``DatasetShard`` over 3 uneven shards of 7 images (3, 2, 2): the
    partial confusion matrices sum bit for bit to the whole set's in both
    protocols, and the whole set's equals the JAX Evaluator's on shared
    weights (``tests/test_multihost.py:89-137``)."""
    import jax
    import jax.numpy as jnp

    import em_adapt_tpu.config as jcfg
    from em_adapt_torch.data.pipeline import DatasetShard, LearnableSyntheticVOC, batch_iterator
    from em_adapt_torch.eval.predict import Evaluator
    from em_adapt_torch.models.deeplab import DeepLabLargeFOV
    from em_adapt_tpu.data.pipeline import DatasetShard as JaxShard
    from em_adapt_tpu.eval.predict import Evaluator as JaxEvaluator
    from em_adapt_tpu.models import DeepLabLargeFOV as JaxDeepLab

    model_kw = dict(num_classes=4, input_size=(33, 33), fc6_channels=8, width_multiplier=0.125)
    jc = jcfg.ExperimentConfig(model=jcfg.ModelConfig(**model_kw),
                               data=jcfg.DataConfig(input_size=(33, 33), num_workers=2))
    pc = pcfg.ExperimentConfig(model=pcfg.ModelConfig(**model_kw),
                               data=pcfg.DataConfig(input_size=(33, 33), num_workers=2))
    jmodel = JaxDeepLab(jc.model)
    params = jmodel.init(jax.random.key(0))
    ev = Evaluator(pc, DeepLabLargeFOV(pc.model).load_params(jax.tree.map(np.asarray, params)))
    ds = LearnableSyntheticVOC(n=7, num_classes=4, seed=3, category="val", image_size=33)
    shards = [DatasetShard(ds, s, 3) for s in range(3)]
    assert [len(s) for s in shards] == [3, 2, 2]
    for s in range(3):
        assert shards[s].ids == JaxShard(ds, s, 3).ids

    full_voc = ev.confusion_voc(ds, use_crf=False, batch_size=2)
    np.testing.assert_array_equal(sum(ev.confusion_voc(s, use_crf=False, batch_size=2)
                                      for s in shards), full_voc)
    want = JaxEvaluator(jc, jmodel).confusion_voc(jax.tree.map(jnp.asarray, params), ds,
                                                  use_crf=False, batch_size=2)
    np.testing.assert_array_equal(full_voc, want)

    def batches(d):
        return batch_iterator(d, pc.data, batch_size=2, seed=0, epochs=1, train=False)

    full_fixed = ev.confusion_fixed(batches(ds))
    np.testing.assert_array_equal(sum(ev.confusion_fixed(batches(s)) for s in shards),
                                  full_fixed)
    assert full_fixed.sum() > 0


def test_process_shard_batches_are_the_global_batch_rows():
    """``batch_iterator(process_shard=(pid, n))``: the n processes' train
    batches stacked are the one-process batches, bit for bit, resumed
    mid-stream too; eval pads the tail as the JAX package does (a block
    of pad rows only included); an indivisible global batch raises."""
    from em_adapt_torch.data.pipeline import SyntheticVOC, batch_iterator
    from em_adapt_tpu.config import DataConfig as JaxData
    from em_adapt_tpu.data.pipeline import batch_iterator as jax_batches

    cfg = pcfg.DataConfig(input_size=(33, 33), num_workers=2)
    ds = SyntheticVOC(13, 4, seed=2, strong_fraction=0.5)
    whole = batch_iterator(ds, cfg, batch_size=4, start_step=1)
    parts = [batch_iterator(ds, cfg, batch_size=4, start_step=1, process_shard=(r, 2))
             for r in range(2)]
    for _ in range(4):  # across an epoch boundary (3 batches an epoch)
        w, a, b = next(whole), next(parts[0]), next(parts[1])
        for k in ("image", "label", "is_strong"):
            np.testing.assert_array_equal(np.concatenate([a[k], b[k]]), w[k])
        assert a["id"] + b["id"] == w["id"]
    jcfg = JaxData(input_size=(33, 33), num_workers=2)
    for pid in range(3):
        got = list(batch_iterator(ds, cfg, batch_size=6, epochs=1, train=False,
                                  process_shard=(pid, 3)))
        want = list(jax_batches(ds, jcfg, batch_size=6, epochs=1, train=False,
                                drop_remainder=False, pad_remainder=True,
                                process_shard=(pid, 3)))
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert g["id"] == w["id"]
            for k in ("image", "label", "is_strong"):
                np.testing.assert_array_equal(g[k], w[k])
    assert list(batch_iterator(ds, cfg, batch_size=6, epochs=1, train=False,
                               process_shard=(2, 3)))[-1]["id"] == ["__pad__"] * 2
    with pytest.raises(ValueError, match="not divisible"):
        next(batch_iterator(ds, cfg, batch_size=5, process_shard=(0, 2)))
