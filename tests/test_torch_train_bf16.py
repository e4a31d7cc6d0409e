"""PyTorch port: bf16 training with the fused block 1 (K2 forward, K3
backward; their plain versions on the CPU) against the JAX package's
``block1_impl="pallas"`` model and ``_step_fn`` on shared weights, batch
and class orders, and ``model.remat``."""

import warnings

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
from em_adapt_torch.ops import block1 as k23  # noqa: E402
from em_adapt_torch.train.trainer import loss_fn  # noqa: E402
from em_adapt_tpu.models import DeepLabLargeFOV as JaxDeepLab  # noqa: E402

torch.set_num_threads(2)

# The shapes of tests/test_block1_pallas.py::test_model_train_grads_match_xla_impl.
MODEL = dict(width_multiplier=0.125, fc6_channels=64, num_classes=5, input_size=(41, 41),
             init_scheme="he")
BLOCK1 = ("conv1_1", "conv1_2")


def _grads(model_or_state):
    return to_jax_params({k: p.grad for k, p in model_or_state.state_dict(keep_vars=True).items()})


def _rel_l2(a, b):
    return np.linalg.norm((a - b).astype(np.float64)) / np.linalg.norm(b.astype(np.float64))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pallas_model_grads_match_jax_pallas(dtype):
    """Every gradient leaf of mean(logits^2), the port's fused block 1
    against JAX's (interpret mode), shared He-init weights. f32: 2e-4 of
    each leaf's scale (the bound of test_model_train_grads_match_xla_impl).
    bf16: block 1's leaves within 1e-5 of their scale (at 41x41 JAX runs
    one strip, so the two round at the same points; first measured 5e-7);
    the other leaves, from the conv path's bf16 backward where XLA and
    PyTorch round at other points, within a relative L2 of 0.05 (first
    measured at most 0.031, conv2_1's bias)."""
    kw = dict(MODEL, block1_impl="pallas", compute_dtype=dtype)
    jmodel = JaxDeepLab(jcfg.ModelConfig(**kw))
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.key(0)))
    x = (np.random.default_rng(7).normal(size=(2, 41, 41, 3)) * 20).astype(np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # JAX's unsharded-kernel warning
        want = jax.grad(lambda p: jnp.mean(jmodel.apply(p, jnp.asarray(x)) ** 2))(
            jax.tree.map(jnp.asarray, params))
    model = DeepLabLargeFOV(pcfg.ModelConfig(**kw)).load_params(params)
    before = (k23.launches, k23.bwd_launches)
    (model(torch.from_numpy(x)) ** 2).mean().backward()
    assert (k23.launches, k23.bwd_launches) == before
    got = _grads(model)
    for name in params:
        for k in ("w", "b"):
            a, b = got[name][k], np.asarray(want[name][k])
            scale = np.abs(b).max()
            if dtype == "float32" or name in BLOCK1:
                tol = 2e-4 if dtype == "float32" else 1e-5
                np.testing.assert_allclose(a / scale, b / scale, rtol=tol, atol=tol,
                                           err_msg=f"{name}.{k}")
            else:
                assert _rel_l2(a, b) <= 0.05, f"{name}.{k}"


def _cfgs(keep=1.0):
    kw = dict(
        model=dict(num_classes=4, input_size=(33, 33), fc6_channels=16, width_multiplier=0.125,
                   dropout_keep_prob=keep, init_scheme="he", compute_dtype="bfloat16",
                   block1_impl="pallas"),
        estep=dict(num_iter=2),
        optim=dict(accum_steps=1, base_lr=0.05, lr_schedule=((2, 0.005),)),
        train=dict(batch_size=2, seed=0),
    )

    def build(mod):
        return mod.ExperimentConfig(
            model=mod.ModelConfig(**kw["model"]), estep=mod.EStepConfig(**kw["estep"]),
            optim=mod.OptimConfig(**kw["optim"]), train=mod.TrainConfig(**kw["train"]),
        )

    return build(jcfg), build(pcfg)


def _batch(seed=0, b=2, hw=33):
    g = np.random.default_rng(seed)
    img = (g.normal(size=(b, hw, hw, 3)) * 40).astype(np.float32)
    label = np.zeros((b, hw, hw, 1), np.float32)
    label[:, hw // 3:, : hw // 2] = 1
    label[1, : hw // 3, hw // 2:] = 3
    label[:, :3] = 255.0
    return {"image": img, "label": label}


def test_bf16_train_step_matches_jax_step():
    """One bf16 microstep with the fused block 1, shared weights, batch
    and orders (the JAX step's own order_rng), keep-prob 1: the weak labels
    are identical (bf16 rounding could flip a pixel whose two best classes
    tie; none does here), the loss agrees to 1e-3 relative, and every
    gradient leaf to a relative L2 of 0.15. That bound is the bf16 trunk's:
    XLA and PyTorch round its backward at other points, and a ReLU or a
    pool window near a tie then decides the other way, so the gap grows
    from fc8 (0.3%) down to the first convolutions (first measured at most
    9.6%, conv3_2's bias; the same, leaf for leaf, with block1_impl="xla"
    on both sides, and 1e-6 at f32). Block 1's own arithmetic is held
    tighter by test_pallas_model_grads_match_jax_pallas and
    tests/test_torch_block1_bwd.py."""
    from em_adapt_tpu.ops.estep import estep_labels as jax_estep_labels
    from em_adapt_tpu.ops.estep import make_class_orders as jax_orders
    from em_adapt_tpu.ops.resize import resize_nearest_tf
    from em_adapt_tpu.train.optim import build_optimizer
    from em_adapt_tpu.train.state import TrainState as JaxState
    from em_adapt_tpu.train.trainer import _step_fn

    jc, pc = _cfgs()
    jmodel = JaxDeepLab(jc.model)
    params = jmodel.init(jax.random.key(0))
    tx, _ = build_optimizer(jc.optim, 1)
    jstate = JaxState.create(params, tx, jax.random.key(1))
    batch = _batch()
    jbatch = jax.tree.map(jnp.asarray, batch)
    rng = jax.random.split(jax.random.fold_in(jstate.rng, jstate.step))[0]
    drop_rng, order_rng = jax.random.split(rng)
    orders = np.array(jax_orders(order_rng, 2, 4))

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # JAX's unsharded-kernel warning

        @jax.jit
        def weak_labels(p, b):
            logits = jmodel.apply(p, b["image"], train=True, rng=drop_rng)
            shrunk = resize_nearest_tf(b["label"], (5, 5))[..., 0]
            return jax_estep_labels(logits, shrunk, jnp.asarray(orders), jc.estep)

        weak_j = np.asarray(weak_labels(params, jbatch))
        new_jstate, jmetrics = jax.jit(_step_fn(jmodel, jc, tx))(jstate, jbatch)
    grads_j = optax.tree_utils.tree_get(new_jstate.opt_state, "trace")

    np_params = jax.tree.map(np.asarray, params)
    model = DeepLabLargeFOV(pc.model).load_params(np_params)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    total, metrics = loss_fn(model, tbatch, pc, generator=torch.Generator(),
                             orders=torch.from_numpy(orders))
    np.testing.assert_array_equal(metrics["weak"].numpy(), weak_j)
    np.testing.assert_allclose(total.item(), float(jmetrics["loss"]), rtol=1e-3)
    total.backward()
    grads = _grads(model)
    for name in np_params:
        for k in ("w", "b"):
            a, b = grads[name][k], np.asarray(grads_j[name][k])
            assert _rel_l2(a, b) <= 0.15, f"{name}.{k}"


@pytest.mark.parametrize("dtype,block1_impl", [("float32", "xla"), ("bfloat16", "pallas")])
def test_remat_is_bit_identical(dtype, block1_impl):
    """model.remat recomputes each VGG block in the backward (as
    jax.checkpoint, tests/test_model.py:203): logits and every gradient
    leaf equal those without it, bit for bit, on the CPU; dropout lies
    outside the blocks, so the same generator gives the same masks."""
    kw = dict(MODEL, compute_dtype=dtype, block1_impl=block1_impl, dropout_keep_prob=0.5)
    params = jax.tree.map(np.asarray, JaxDeepLab(jcfg.ModelConfig(**kw)).init(jax.random.key(2)))
    x = torch.from_numpy((np.random.default_rng(2).normal(size=(2, 41, 41, 3)) * 20)
                         .astype(np.float32))
    out = {}
    for remat in (False, True):
        model = DeepLabLargeFOV(pcfg.ModelConfig(**kw, remat=remat)).load_params(params)
        logits = model(x, train=True, generator=torch.Generator().manual_seed(3))
        (logits ** 2).mean().backward()
        out[remat] = (logits.detach(), _grads(model))
    assert torch.equal(out[False][0], out[True][0])
    for name, leaves in out[False][1].items():
        for k, v in leaves.items():
            np.testing.assert_array_equal(out[True][1][name][k], v, err_msg=f"{name}.{k}")
