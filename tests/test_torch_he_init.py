"""PyTorch port: one accumulation window from He init at full width
against the JAX package's, to separate a fault of the port from a
property of the recipe.

DeepLab-LargeFOV at its published widths (65,140,565 parameters, fc6
4096, 21 classes) from the JAX package's He-init parameters, f32, the
reference LR 1e-3, momentum 0.9, accumulation 5, keep-prob 0.5: five
microbatch steps with the JAX step's own dropout masks and class orders
injected into the port. The input is cut to 33x33 and the batch to 2 so
that both packages run on a CPU; the widths, and so He init's scale and
the update, are the full model's."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import em_adapt_tpu.config as jcfg  # noqa: E402
from em_adapt_torch import config as pcfg  # noqa: E402
from em_adapt_torch.models.convert import to_jax_params  # noqa: E402
from em_adapt_torch.models.deeplab import DeepLabLargeFOV  # noqa: E402
from em_adapt_torch.train.optim import AccumulatingSGD  # noqa: E402
from em_adapt_torch.train.trainer import TrainState, train_step  # noqa: E402

torch.set_num_threads(4)

STEPS, BATCH, HW, KEEP = 5, 2, 33, 0.5


def _cfgs():
    kw = dict(model=dict(init_scheme="he", input_size=(HW, HW), dropout_keep_prob=KEEP),
              optim=dict(lr_schedule=()), train=dict(batch_size=BATCH))

    def build(mod):
        return mod.ExperimentConfig(model=mod.ModelConfig(**kw["model"]),
                                    optim=mod.OptimConfig(**kw["optim"]),
                                    train=mod.TrainConfig(**kw["train"]))

    return build(jcfg), build(pcfg)


def _batch(seed):
    g = np.random.default_rng(seed)
    img = (g.normal(size=(BATCH, HW, HW, 3)) * 40).astype(np.float32)
    label = np.zeros((BATCH, HW, HW, 1), np.float32)
    label[:, HW // 3:, : HW // 2] = 1 + seed % 5
    label[1, : HW // 3, HW // 2:] = 7 + seed
    label[:, :3] = 255.0
    return {"image": img, "label": label}


def test_he_init_window_matches_jax_at_full_width():
    """Each step's loss (rtol 1e-5) and weak labels (equal), and the params
    after the window's one update (within 1e-3 of each leaf's move, as in
    test_torch_train.py::test_one_step_matches_jax_step), equal JAX's."""
    from em_adapt_tpu.models import DeepLabLargeFOV as JaxDeepLab
    from em_adapt_tpu.ops.estep import make_class_orders as jax_orders
    from em_adapt_tpu.train.optim import build_optimizer
    from em_adapt_tpu.train.state import TrainState as JaxState
    from em_adapt_tpu.train.trainer import _step_fn

    jc, pc = _cfgs()
    jmodel = JaxDeepLab(jc.model)
    params = jmodel.init(jax.random.key(0))
    np_params = jax.tree.map(np.asarray, params)
    tx, _ = build_optimizer(jc.optim, 1)
    jstate = JaxState.create(params, tx, jax.random.key(1))
    step_fn = jax.jit(_step_fn(jmodel, jc, tx))

    model = DeepLabLargeFOV(pc.model).load_params(np_params)
    assert sum(p.numel() for p in model.parameters()) == 65_140_565
    names, tparams = zip(*model.named_parameters())
    state = TrainState(model, AccumulatingSGD(tparams, pc.optim, names=names), torch.Generator())
    h = -(-HW // 8)
    for step in range(STEPS):
        rng = jax.random.split(jax.random.fold_in(jstate.rng, jstate.step))[0]
        drop_rng, order_rng = jax.random.split(rng)
        masks = tuple(
            torch.from_numpy(np.array(jax.random.bernoulli(k, KEEP, (BATCH, h, h, 4096))))
            .permute(0, 3, 1, 2) for k in jax.random.split(drop_rng, 2))
        orders = torch.from_numpy(np.array(jax_orders(order_rng, 5, 21)))
        batch = _batch(step)
        jstate, jmetrics = step_fn(jstate, jax.tree.map(jnp.asarray, batch))
        metrics = train_step(state, {k: torch.from_numpy(v) for k, v in batch.items()}, pc,
                             orders=orders, masks=masks)
        np.testing.assert_allclose(metrics["loss"].item(), float(jmetrics["loss"]), rtol=1e-5,
                                   err_msg=f"step {step}")
        assert metrics["updated"] == (step == STEPS - 1)
    new, new_j = to_jax_params(model), jax.tree.map(np.asarray, jstate.params)
    for name in np_params:
        for k in ("w", "b"):
            d_port = new[name][k] - np_params[name][k]
            d_jax = new_j[name][k] - np_params[name][k]
            assert np.abs(d_jax).max() > 0, f"{name}.{k} did not move"
            tol = 64 * np.finfo(np.float32).eps * np.abs(np_params[name][k]).max()
            np.testing.assert_allclose(d_port, d_jax, rtol=1e-3,
                                       atol=tol + 1e-3 * np.abs(d_jax).max(),
                                       err_msg=f"{name}.{k}")
