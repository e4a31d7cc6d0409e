"""PyTorch port at the 513x513 input, whose score map is 65x65: K1's
plain version there against the JAX package's sort reference, the numpy
oracle and np.partition (on ``realistic_batch`` and on the edge cases
that ``chip_smoke.py`` runs through the cluster K1 on the card), and one
513² training step at narrow widths against the JAX step on shared
parameters, dropout masks and class orders."""

import importlib.util
import os

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
from em_adapt_torch.ops import estep_kernel as k1  # noqa: E402
from em_adapt_torch.ops.estep import estep_bisect  # noqa: E402
from em_adapt_torch.train.trainer import loss_fn  # noqa: E402
from em_adapt_tpu.ops.estep import estep as jax_estep  # noqa: E402
from em_adapt_tpu.ops.estep_oracle import estep_oracle  # noqa: E402

torch.set_num_threads(4)


def _load_chip_smoke():
    path = os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


SMOKE = _load_chip_smoke()


@pytest.mark.parametrize("b", [1, 6])
def test_plain_k1_at_65_matches_sort_reference_and_oracle(b):
    """``realistic_batch`` at 65x65 (``chip_smoke.py``'s K1 case there):
    labels identical to JAX's sort reference and to the oracle,
    thresholds bit-equal to np.partition, scores within 2e-5 of the
    oracle (means summed in another order)."""
    scores, label, orders = SMOKE.realistic_batch(np.random.default_rng(65 + b), b, hw=65)
    got, th = estep_bisect(torch.from_numpy(scores), torch.from_numpy(label),
                           torch.from_numpy(orders), **SMOKE.K1_RECIPE)
    got = got.numpy()
    want_th = SMOKE.partition_thresholds(scores, label, orders, **SMOKE.K1_RECIPE)
    np.testing.assert_array_equal(th.numpy().view(np.int32), want_th.view(np.int32))
    sort = np.asarray(jax_estep(jnp.asarray(scores), jnp.asarray(label), jnp.asarray(orders),
                                **SMOKE.K1_RECIPE))
    oracle = estep_oracle(scores, label, orders=orders, **SMOKE.K1_RECIPE)
    np.testing.assert_array_equal(got.argmax(3), sort.argmax(3))
    np.testing.assert_array_equal(got.argmax(3), oracle.argmax(3))
    np.testing.assert_allclose(got, oracle, atol=2e-5, rtol=0)


@pytest.mark.parametrize("h,w", [(3, 683), (64, 64), (65, 65)], ids=["hw2049", "hw4096",
                                                                      "hw4225"])
@pytest.mark.parametrize("case", SMOKE.K1_EDGE_CASES)
def test_plain_k1_cluster_edge_cases(case, h, w):
    """K1's edge cases at the sizes the card runs over a cluster of CTAs
    (``chip_smoke.K1_CLUSTER_SIZES``: 2049 pixels, two CTAs with a ragged
    second; 4096, two full CTAs; 4225, three): the plain version's
    thresholds bit-equal to np.partition and its labels the oracle's."""
    assert (h, w) in SMOKE.K1_CLUSTER_SIZES
    scores, label, orders, kw = SMOKE.k1_edge_case(case, h, w)
    args, kkw = SMOKE.k1_inputs(scores, label, orders, torch.device("cpu"), **kw)
    out, th = k1.estep_plain(*args, **kkw)
    want = SMOKE.partition_thresholds(scores, label, orders, **kw)
    np.testing.assert_array_equal(th.numpy().view(np.int32), want.view(np.int32))
    oracle = estep_oracle(scores, label, orders=orders, **kw)
    b, c = scores.shape[0], scores.shape[3]
    labels = out.reshape(b, c, h, w).argmax(1).numpy()
    np.testing.assert_array_equal(labels, oracle.argmax(3))


def _cfgs(keep):
    kw = dict(
        model=dict(num_classes=21, input_size=(513, 513), fc6_channels=16,
                   width_multiplier=0.125, dropout_keep_prob=keep, init_scheme="he"),
        optim=dict(accum_steps=1, base_lr=0.01, lr_schedule=()),
        train=dict(batch_size=1, seed=0),
    )

    def build(mod):
        return mod.ExperimentConfig(
            model=mod.ModelConfig(**kw["model"]), optim=mod.OptimConfig(**kw["optim"]),
            train=mod.TrainConfig(**kw["train"]))

    return build(jcfg), build(pcfg)


def test_train_step_at_513_matches_jax():
    """One EM step at a 513x513 input (65x65 score map), widths x0.125,
    fc6 16, batch 1, keep-prob 0.5 with the JAX step's own dropout masks
    and class orders: weak labels identical to those of JAX's forward,
    loss within rtol 1e-5 (as ``test_torch_train.py::
    test_one_step_matches_jax_step``).

    Gradients: at 513² a weight gradient sums 263,169 positions a term
    (242 times the 1,089 of that test's 33²), and PyTorch's CPU
    convolutions accumulate them in f32 with an error that grows with the
    count: the port's f32 gradients lie up to 7.8e-4 of a leaf's scale
    from its own f64 gradients (first measured), so the 33² bound (rtol
    1e-4, atol 1e-5 of the scale) cannot hold for them. The port's
    arithmetic is held instead in f64: JAX's f32 gradients within rtol
    1e-4 and 5e-4 of each leaf's scale of the port's f64 ones (JAX's own
    f32 error: up to 1.7e-4, first measured); and its f32 gradients
    within rtol 1e-4 and 2e-3 of the scale of JAX's, relative L2 1e-3."""
    from em_adapt_tpu.models import DeepLabLargeFOV as JaxDeepLab
    from em_adapt_tpu.ops.estep import estep_labels as jax_estep_labels
    from em_adapt_tpu.ops.estep import make_class_orders as jax_orders
    from em_adapt_tpu.ops.resize import resize_nearest_tf
    from em_adapt_tpu.train.optim import build_optimizer
    from em_adapt_tpu.train.state import TrainState as JaxState
    from em_adapt_tpu.train.trainer import _step_fn

    keep, hw = 0.5, 65
    jc, pc = _cfgs(keep)
    jmodel = JaxDeepLab(jc.model)
    params = jmodel.init(jax.random.key(0))
    tx, _ = build_optimizer(jc.optim, 1)
    jstate = JaxState.create(params, tx, jax.random.key(1))
    g = np.random.default_rng(513)
    batch = {"image": (g.normal(size=(1, 513, 513, 3)) * 40).astype(np.float32),
             "label": np.zeros((1, 513, 513, 1), np.float32)}
    batch["label"][:, 100:400, 50:300] = 15
    batch["label"][:, 300:, 250:] = 7
    batch["label"][:, :20] = 255.0
    jbatch = jax.tree.map(jnp.asarray, batch)

    rng = jax.random.split(jax.random.fold_in(jstate.rng, jstate.step))[0]
    drop_rng, order_rng = jax.random.split(rng)
    masks = tuple(
        torch.from_numpy(np.array(jax.random.bernoulli(k, keep, (1, hw, hw, 16))))
        .permute(0, 3, 1, 2) for k in jax.random.split(drop_rng, 2))
    orders = np.array(jax_orders(order_rng, 5, 21))

    @jax.jit
    def weak_labels(p, b):
        logits = jmodel.apply(p, b["image"], train=True, rng=drop_rng)
        shrunk = resize_nearest_tf(b["label"], (hw, hw))[..., 0]
        return jax_estep_labels(logits, shrunk, jnp.asarray(orders), jc.estep)

    weak_j = np.asarray(weak_labels(params, jbatch))
    new_jstate, jmetrics = jax.jit(_step_fn(jmodel, jc, tx))(jstate, jbatch)
    grads_j = optax.tree_utils.tree_get(new_jstate.opt_state, "trace")

    np_params = jax.tree.map(np.asarray, params)
    grads = {}
    for dtype in (torch.float32, torch.float64):
        model = DeepLabLargeFOV(pc.model).load_params(np_params).to(dtype)
        tbatch = {"image": torch.from_numpy(batch["image"]).to(dtype),
                  "label": torch.from_numpy(batch["label"])}
        total, metrics = loss_fn(model, tbatch, pc, generator=torch.Generator(),
                                 orders=torch.from_numpy(orders), masks=masks)
        np.testing.assert_array_equal(metrics["weak"].numpy(), weak_j, err_msg=str(dtype))
        if dtype == torch.float32:
            assert set(np.unique(weak_j)) <= {0, 7, 15} and len(set(np.unique(weak_j))) > 1
            np.testing.assert_allclose(total.item(), float(jmetrics["loss"]), rtol=1e-5)
        total.backward()
        grads[dtype] = to_jax_params(
            {k: p.grad.float() for k, p in model.state_dict(keep_vars=True).items()})
    for name in np_params:
        for k in ("w", "b"):
            want = np.asarray(grads_j[name][k])
            scale = np.abs(want).max()
            np.testing.assert_allclose(want, grads[torch.float64][name][k], rtol=1e-4,
                                       atol=5e-4 * scale, err_msg=f"JAX vs f64 {name}.{k}")
            got = grads[torch.float32][name][k]
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-3 * scale,
                                       err_msg=f"{name}.{k}")
            assert np.linalg.norm(got - want) <= 1e-3 * np.linalg.norm(want), f"{name}.{k}"
