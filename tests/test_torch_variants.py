"""PyTorch port: the training variants against the JAX package's.
Semi-supervision and the tag warm-up loss (values and gradients), the
Caffe LR groups, the params-only warm start, the batches' "is_strong"
flags, and a resume inside and across the tag warm-up, bit for bit. (The
``train`` command's new flags: test_torch_cli_train.py.)"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import em_adapt_tpu.config as jcfg  # noqa: E402
from em_adapt_torch import config as pcfg  # noqa: E402
from em_adapt_torch.data.pipeline import SyntheticVOC, batch_iterator  # noqa: E402
from em_adapt_torch.models.convert import to_jax_params  # noqa: E402
from em_adapt_torch.models.deeplab import DeepLabLargeFOV  # noqa: E402
from em_adapt_torch.train import trainer as trainer_mod  # noqa: E402
from em_adapt_torch.train.optim import AccumulatingSGD  # noqa: E402
from em_adapt_torch.train.state import bitwise_diff  # noqa: E402
from em_adapt_torch.train.trainer import Trainer, loss_fn, tag_classification_loss  # noqa: E402
from tests.test_torch_checkpoint import batches, port_cfg, trainer_for  # noqa: E402
from tests.test_torch_train import both_cfgs  # noqa: E402

torch.set_num_threads(2)


def mixed_batch(seed=0, b=4, hw=33, c=4):
    """Random labels of ``c`` classes with a void band, half the rows strong."""
    g = np.random.default_rng(seed)
    img = (g.normal(size=(b, hw, hw, 3)) * 40).astype(np.float32)
    label = g.integers(0, c, size=(b, hw, hw, 1)).astype(np.float32)
    label[:, :4] = 255.0
    return {"image": img, "label": label, "is_strong": np.arange(b) < b // 2}


def _jax_loss_and_grads(jc, params, batch, step=None):
    """The JAX package's loss_fn (its own dropout and order keys from
    key(1); keep-prob 1), its aux and gradients, and the class orders it
    drew."""
    from em_adapt_tpu.models import DeepLabLargeFOV as JaxDeepLab
    from em_adapt_tpu.ops.estep import make_class_orders
    from em_adapt_tpu.train.trainer import loss_fn as jax_loss_fn

    jmodel = JaxDeepLab(jc.model)
    key = jax.random.key(1)
    jbatch = jax.tree.map(jnp.asarray, batch)
    step = None if step is None else jnp.asarray(step)
    grad_fn = jax.jit(jax.value_and_grad(jax_loss_fn, has_aux=True), static_argnums=(3, 4, 5))
    (total, aux), grads = grad_fn(params, jbatch, key, jmodel, jc, None, step)
    orders = np.array(make_class_orders(jax.random.split(key)[1], jc.estep.num_iter,
                                        jc.model.num_classes))
    return float(total), jax.tree.map(np.asarray, aux), jax.tree.map(np.asarray, grads), orders


def _port_loss_and_grads(pc, np_params, batch, orders, step=None):
    model = DeepLabLargeFOV(pc.model).load_params(np_params)
    tbatch = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    total, aux = loss_fn(model, tbatch, pc, generator=torch.Generator(),
                         orders=torch.from_numpy(orders), step=step)
    total.backward()
    grads = to_jax_params({k: p.grad for k, p in model.state_dict(keep_vars=True).items()})
    return total.item(), aux, grads


def _assert_grads_close(grads, want_grads):
    for name in want_grads:
        for k in ("w", "b"):
            want = want_grads[name][k]
            np.testing.assert_allclose(grads[name][k], want, rtol=1e-4,
                                       atol=1e-5 * np.abs(want).max() + 1e-12,
                                       err_msg=f"{name}.{k}")


@pytest.mark.parametrize("strong", ["half", "all-void-strong"])
def test_semi_supervised_loss_and_gradient_match_jax(strong):
    """tests/test_trainer.py::test_semi_supervised_masks_void: strong rows
    train on their true masks with void masked out, weak rows on the
    E-step's labels; loss and every gradient leaf agree with JAX's at f32
    (rtol 1e-5 on the loss; 1e-4, atol 1e-5 of each leaf's scale). An
    all-void batch of strong images (no valid pixel) gives a finite loss."""
    jc, pc = both_cfgs()
    jc, pc = jc.replace(semi_supervised=True), pc.replace(semi_supervised=True)
    from em_adapt_tpu.models import DeepLabLargeFOV as JaxDeepLab

    params = JaxDeepLab(jc.model).init(jax.random.key(0))
    np_params = jax.tree.map(np.asarray, params)
    batch = mixed_batch()
    if strong == "all-void-strong":
        batch["label"][:] = 255.0
        batch["is_strong"][:] = True
    total_j, aux_j, grads_j, orders = _jax_loss_and_grads(jc, params, batch)
    total, aux, grads = _port_loss_and_grads(pc, np_params, batch, orders)
    assert np.isfinite(total)
    np.testing.assert_allclose(total, total_j, rtol=1e-5)
    np.testing.assert_allclose(aux["loss_norm"].item(), float(aux_j["loss_norm"]), rtol=1e-5)
    _assert_grads_close(grads, grads_j)
    if strong == "half":  # not the pure-weak loss: the strong rows count
        _, weak_aux, _ = _port_loss_and_grads(pc.replace(semi_supervised=False), np_params,
                                              batch, orders)
        assert weak_aux["loss_norm"].item() != aux["loss_norm"].item()


@pytest.mark.parametrize("smoothing,pool_r", [(0.05, 4.0), (0.0, 1.0), (0.1, 16.0)])
def test_tag_classification_loss_matches_jax(smoothing, pool_r):
    """Value and gradient against em_adapt_tpu's on random logits and
    masks with a void band and a class id out of range."""
    from em_adapt_tpu.train.trainer import tag_classification_loss as jax_tag_loss

    g = np.random.default_rng(1)
    logits = (g.normal(size=(3, 6, 7, 5)) * 3).astype(np.float32)
    lab = g.integers(0, 5, size=(3, 6, 7)).astype(np.float32)
    lab[:, 0] = 255.0
    lab[2, 1] = 7.0
    want, want_grad = jax.value_and_grad(jax_tag_loss)(
        jnp.asarray(logits), jnp.asarray(lab), 5, smoothing, pool_r)
    x = torch.from_numpy(logits).requires_grad_()
    got = tag_classification_loss(x, torch.from_numpy(lab), 5, smoothing, pool_r)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad), rtol=1e-5, atol=1e-9)


def test_tag_warmup_smoothing_bounds_the_objective():
    """tests/test_trainer.py::test_tag_warmup_smoothing_bounds_the_objective
    on the port's loss: hard targets fall forever as the logits grow,
    smoothed ones turn back up."""
    g = np.random.default_rng(0)
    base = torch.from_numpy(g.normal(size=(2, 4, 4, 3)).astype(np.float32))
    lab = torch.from_numpy(g.integers(0, 3, size=(2, 4, 4)).astype(np.int32))
    hard = [tag_classification_loss(base * s, lab, 3, 0.0).item() for s in (1.0, 10.0, 100.0)]
    smooth = [tag_classification_loss(base * s, lab, 3, 0.05).item() for s in (1.0, 10.0, 100.0)]
    assert hard[2] < hard[1] < hard[0]
    assert smooth[2] > smooth[1] and smooth[2] > smooth[0]


def test_tag_warmup_pool_r_rejects_constant_maps():
    """tests/test_trainer.py::test_tag_warmup_pool_r_rejects_constant_maps:
    a constant map pools to its value at every r; sharp pooling sees a
    single peak that mean-like pooling washes out."""
    lab = torch.zeros(1, 8, 8, dtype=torch.int32)
    const = torch.tensor([3.0, -3.0]).expand(1, 8, 8, 2).contiguous()
    peak = torch.full((1, 8, 8, 2), -3.0)
    peak[0, 4, 4, 0] = 3.0
    l_const = [tag_classification_loss(const, lab, 2, 0.05, r).item() for r in (1.0, 4.0, 16.0)]
    np.testing.assert_allclose(l_const, l_const[0], rtol=1e-5)
    l_peak_1 = tag_classification_loss(peak, lab, 2, 0.05, 1.0).item()
    l_peak_16 = tag_classification_loss(peak, lab, 2, 0.05, 16.0).item()
    assert l_peak_16 < l_peak_1 and l_peak_16 < l_const[0] + 0.5


def test_tag_warmup_selects_the_classification_loss_as_jax_does():
    """tests/test_trainer.py::test_tag_warmup_selects_classification_loss:
    below tag_warmup_steps the loss and its gradient are JAX's tag loss;
    from the threshold on, the EM loss of a warm-up-off config, bit for bit."""
    jc, pc = both_cfgs()
    jc = jc.replace(train=dataclasses.replace(jc.train, tag_warmup_steps=3))
    warm = pc.replace(train=dataclasses.replace(pc.train, tag_warmup_steps=3))
    from em_adapt_tpu.models import DeepLabLargeFOV as JaxDeepLab

    params = JaxDeepLab(jc.model).init(jax.random.key(0))
    np_params = jax.tree.map(np.asarray, params)
    batch = {k: v for k, v in mixed_batch().items() if k != "is_strong"}
    total_j, aux_j, grads_j, orders = _jax_loss_and_grads(jc, params, batch, step=0)
    total, aux, grads = _port_loss_and_grads(warm, np_params, batch, orders, step=0)
    assert aux["weak"] is None
    np.testing.assert_allclose(total, total_j, rtol=1e-5)
    np.testing.assert_allclose(aux["loss_norm"].item(), float(aux_j["loss_norm"]), rtol=1e-5)
    _assert_grads_close(grads, grads_j)
    em, em_aux, _ = _port_loss_and_grads(warm, np_params, batch, orders, step=3)
    off, _, _ = _port_loss_and_grads(pc, np_params, batch, orders, step=3)
    assert em == off and em_aux["weak"] is not None and em != total


@pytest.mark.parametrize("accum", [1, 2])
def test_lr_group_update_matches_jax_optax_chain(accum):
    """tests/test_trainer.py::test_lr_multipliers_groups on a model's own
    parameters: with optim.lr_multipliers the accumulated gradient is
    scaled by its group (bias x2, fc8 weight x10, fc8 bias x20) before
    SGD with momentum; two updates (so momentum carries) equal
    build_optimizer's chain."""
    from em_adapt_tpu.train.optim import build_optimizer

    ocfg = dict(base_lr=0.1, momentum=0.9, accum_steps=accum, lr_schedule=(),
                lr_multipliers=True)
    _, pc = both_cfgs()
    names = [n for n, _ in DeepLabLargeFOV(pc.model).named_parameters()]
    g = np.random.default_rng(0)
    params = [torch.nn.Parameter(torch.from_numpy(g.normal(size=(2, 3)).astype(np.float32)))
              for _ in names]
    opt = AccumulatingSGD(params, pcfg.OptimConfig(**ocfg), names=names)
    tx, _ = build_optimizer(jcfg.OptimConfig(**ocfg), 1)

    def tree(tensors):  # the JAX package's {layer: {"w", "b"}} over the same leaves
        out = {}
        for n, t in zip(names, tensors):
            _, layer, kind = n.split(".")
            out.setdefault(layer, {})["w" if kind == "weight" else "b"] = jnp.array(
                t.detach().numpy(), copy=True)  # not a view of the live parameter
        return out

    jparams = tree(params)
    jstate = tx.init(jparams)
    update = jax.jit(tx.update)
    for step in range(2 * accum):
        grads = [g.normal(size=(2, 3)).astype(np.float32) for _ in names]
        for p, gr in zip(params, grads):
            p.grad = torch.from_numpy(gr.copy())
        opt.step(step)
        updates, jstate = update(tree(map(torch.from_numpy, grads)), jstate, jparams)
        jparams = jax.tree.map(lambda a, u: a + u, jparams, updates)
    got = tree(params)
    for layer in jparams:
        for k in ("w", "b"):
            np.testing.assert_allclose(np.asarray(got[layer][k]), np.asarray(jparams[layer][k]),
                                       rtol=1e-6, atol=1e-6, err_msg=f"{layer}.{k}")
    assert sorted(set(opt.multipliers)) == [1.0, 2.0, 10.0, 20.0]
    with pytest.raises(ValueError, match="one name per parameter"):
        AccumulatingSGD(params, pcfg.OptimConfig(**ocfg))


def _trained(tmp_path, accum):
    cfg = port_cfg(tmp_path, accum=accum, lr_schedule=((1, 1e-4),))
    trainer = trainer_for(cfg)
    state = trainer.init_state()
    trainer.fit(state, batches(cfg), num_steps=3)
    trainer.checkpointer.save(state, "norm")
    trainer.checkpointer.close()
    return state


@pytest.mark.parametrize("accum", [(1, 1), (1, 2)], ids=["same-optimizer", "accum-1-to-2"])
def test_warm_start_takes_params_only(tmp_path, accum):
    """tests/test_trainer.py::test_warm_start_params_only and
    ::test_warm_start_across_optimizer_change: the params are the
    checkpoint's; optimizer, step, generator and LR position are a fresh
    state's, also when the new run accumulates over another window; the
    first step then trains."""
    saved = _trained(tmp_path / "first", accum[0])
    cfg = port_cfg(tmp_path / "second", accum=accum[1], lr_schedule=((1, 1e-4),))
    trainer = trainer_for(cfg)
    fresh = trainer.init_state()
    fresh_opt = trainer.init_state().state_dict()
    warm = trainer.warm_start(fresh, str(tmp_path / "first"))
    assert warm is fresh and warm.step == 0
    assert bitwise_diff(warm.state_dict()["params"], saved.state_dict()["params"]) == []
    sd = warm.state_dict()
    for key in ("optimizer", "step", "generator"):
        assert bitwise_diff(sd[key], fresh_opt[key]) == [], key
    records = trainer.fit(warm, batches(cfg), num_steps=1)
    assert np.isfinite(records[0]["loss"]) and records[0]["lr"] == 0.01
    with pytest.raises(FileNotFoundError):
        trainer.warm_start(trainer.init_state(), str(tmp_path / "nothing"))


def test_synthetic_strong_flags_and_batches_match_jax():
    """tests/test_data.py::test_semi_supervised_flags_in_batches, bit for
    bit: SyntheticVOC's flags, and train and padded eval batches with
    "is_strong" (pad rows False), equal the JAX package's; an all-weak
    dataset's batches have no "is_strong"."""
    from em_adapt_tpu.data import pipeline as jp

    jdata = jcfg.DataConfig(input_size=(33, 33), num_workers=2)
    pdata = pcfg.DataConfig(input_size=(33, 33), num_workers=2)
    for frac in (0.5, 0.0):
        ours = SyntheticVOC(n=11, seed=3, strong_fraction=frac)
        ref = jp.SyntheticVOC(n=11, seed=3, strong_fraction=frac)
        np.testing.assert_array_equal(ours.is_strong, ref.is_strong)
        for train in (True, False):
            got = list(batch_iterator(ours, pdata, batch_size=4, seed=5, epochs=1, train=train))
            want = list(jp.batch_iterator(ref, jdata, batch_size=4, seed=5, epochs=1,
                                          train=train, pad_remainder=not train))
            assert len(got) == len(want) == (2 if train else 3)
            for a, b in zip(got, want):
                assert a.keys() == b.keys() and ("is_strong" in a) == (frac > 0)
                for k in a:
                    if k == "id":
                        assert a[k] == b[k]
                    else:
                        assert a[k].dtype == b[k].dtype
                        np.testing.assert_array_equal(a[k], b[k])
    assert 0 < ours.is_strong.sum() < 11 or frac == 0.0
    tail = list(batch_iterator(SyntheticVOC(n=11, seed=3, strong_fraction=1.0), pdata,
                               batch_size=4, seed=5, epochs=1, train=False))[-1]
    assert tail["is_strong"].tolist() == [True, True, True, False]


@pytest.mark.parametrize("stop", [2, 3, 5], ids=["inside-warmup", "at-boundary", "after"])
def test_resume_across_the_tag_warmup_is_bit_exact(tmp_path, monkeypatch, stop):
    """tag_warmup_steps=3, accumulation 2: a run stopped at ``stop``, saved
    and continued in a fresh Trainer ends on the uninterrupted run's
    state and losses bit for bit. The E-step runs only on EM steps."""
    calls = []
    estep = trainer_mod.estep_labels
    monkeypatch.setattr(trainer_mod, "estep_labels",
                        lambda *a, **kw: calls.append(1) or estep(*a, **kw))

    def cfg_in(d):
        cfg = port_cfg(tmp_path / d, accum=2)
        return cfg.replace(train=dataclasses.replace(cfg.train, tag_warmup_steps=3))

    control = trainer_for(cfg_in("a"))
    want = control.init_state()
    want_records = control.fit(want, batches(cfg_in("a")), num_steps=7)
    assert len(calls) == 4  # steps 3..6
    first = trainer_for(cfg_in("b"))
    state = first.init_state()
    first.fit(state, batches(cfg_in("b")), num_steps=stop)
    first.checkpointer.save(state, "norm")
    first.checkpointer.close()
    second = trainer_for(cfg_in("b"))
    resumed = second.restore_state()
    records = second.fit(resumed, batches(cfg_in("b"), stop), num_steps=7)
    assert [r["loss"] for r in records] == [r["loss"] for r in want_records[stop:]]
    assert bitwise_diff(resumed.state_dict(), want.state_dict()) == []
    assert want_records[2]["loss"] != want_records[3]["loss"]
