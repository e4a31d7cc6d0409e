"""PyTorch port: EM-Fixed (``estep.method="fixed"``) against the JAX
package: ``estep_fixed`` in both bias units, with and without the
suppression, the weak labels of every ``impl``, one training step on
shared weights, batch and orders, and the config hints that the Trainer
emits."""

import types

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
from em_adapt_torch.ops import estep as estep_ops  # noqa: E402
from em_adapt_torch.ops.estep import estep_fixed, estep_labels  # noqa: E402
from em_adapt_torch.train.trainer import Trainer, config_hints, loss_fn  # noqa: E402
from em_adapt_tpu.ops.estep import estep_fixed as jax_estep_fixed  # noqa: E402
from em_adapt_tpu.ops.estep import estep_labels as jax_estep_labels  # noqa: E402

torch.set_num_threads(2)

UNITS = ["logit", "spread"]


def _case(seed, b=3, h=9, w=7, c=6):
    """Scores with a logit spread of a trained model, labels with two or
    three classes an image (one image without background), void rows."""
    g = np.random.default_rng(seed)
    scores = (g.normal(size=(b, h, w, c)) * 4).astype(np.float32)
    label = g.integers(0, 3, size=(b, h, w)).astype(np.float32)
    label[1] = np.where(label[1] == 0, c - 1, label[1])
    label[:, 0] = 255.0
    return scores, label


@pytest.mark.parametrize("suppress", [True, False], ids=["suppress", "no_suppress"])
@pytest.mark.parametrize("units", UNITS)
def test_estep_fixed_matches_jax(units, suppress):
    """Biased scores within 1e-6 (the spread's moments sum in another
    order), asymmetric biases, every image's own tags."""
    scores, label = _case(1)
    kw = dict(bg_bias=2.5, fg_bias=4.0, suppress_others=suppress, margin_others=1e-5,
              bias_units=units)
    got = estep_fixed(torch.from_numpy(scores), torch.from_numpy(label), **kw).numpy()
    want = np.asarray(jax_estep_fixed(jnp.asarray(scores), jnp.asarray(label), **kw))
    assert got.dtype == np.float32 and got.shape == scores.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("suppress", [False, True], ids=["no_suppress", "suppress"])
def test_estep_fixed_matches_hand_computation(suppress):
    """The port's ``estep_fixed`` against the direct numpy computation of
    ``tests/test_estep.py::test_estep_fixed_matches_hand_computation`` and
    ``::test_estep_fixed_spread_units_hand_computation``."""
    g = np.random.default_rng(11)
    b, h, w, c = 2, 6, 5, 4
    scores = (g.normal(size=(b, h, w, c)) * 3).astype(np.float32)
    label = np.zeros((b, h, w), np.float32)
    label[0, 2:, :] = 2.0
    label[1] = 1.0
    label[1, :, 3:] = 3.0
    tags = np.zeros((b, c), np.float32)
    tags[0, [0, 2]] = 1.0
    tags[1, [1, 3]] = 1.0
    f = scores.copy()
    if suppress:
        lifted = f + np.where(tags[:, None, None, :] > 0, 0.0, f.max())
        pmin = lifted.min(axis=3, keepdims=True)
        f = np.where((tags[:, None, None, :] == 0) & (f > pmin), pmin - np.float32(1e-5), f)
    per_class = np.where(np.arange(c) == 0, 3.25, 7.5).astype(np.float32)
    s, lab = torch.from_numpy(scores), torch.from_numpy(label)
    got = estep_fixed(s, lab, bg_bias=3.25, fg_bias=7.5, suppress_others=suppress).numpy()
    np.testing.assert_allclose(got, f + (tags * per_class)[:, None, None, :], atol=1e-6)
    mask = tags[:, None, None, :]
    n = tags.sum(1) * (h * w)
    mean = (f * mask).sum(axis=(1, 2, 3)) / n
    std = np.sqrt((mask * (f - mean[:, None, None, None]) ** 2).sum(axis=(1, 2, 3)) / n)
    got = estep_fixed(s, lab, bg_bias=3.25, fg_bias=7.5, suppress_others=suppress,
                      bias_units="spread").numpy()
    want = f + (tags * per_class)[:, None, None, :] * std[:, None, None, None]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_estep_fixed_spread_units_scale_equivariant():
    """Spread units: a global rescale of the scores rescales the output
    (suppression off), as ``tests/test_estep.py::
    test_estep_fixed_spread_units_scale_equivariant`` holds JAX's."""
    g = np.random.default_rng(31)
    scores = torch.from_numpy(g.normal(size=(2, 8, 8, 4)).astype(np.float32))
    label = torch.from_numpy(g.integers(0, 4, size=(2, 8, 8)).astype(np.float32))
    kw = dict(bg_bias=3.0, fg_bias=5.0, bias_units="spread", suppress_others=False)
    base = estep_fixed(scores, label, **kw).numpy()
    for alpha in (0.25, 16.0):
        scaled = estep_fixed(scores * alpha, label, **kw).numpy()
        np.testing.assert_allclose(scaled, base * alpha, rtol=3e-5, atol=1e-4 * alpha)
    with pytest.raises(ValueError, match="bias_units"):
        estep_fixed(scores, label, bias_units="std")


@pytest.mark.parametrize("units", UNITS)
def test_estep_labels_fixed_every_impl_matches_jax(units, monkeypatch):
    """``estep_labels`` with method "fixed" gives JAX's label map pixel for
    pixel for every impl, and never reaches K1 (nor the native library)."""
    scores, label = _case(2)
    orders = np.stack([np.random.default_rng(i).permutation(np.arange(1, 6)) for i in range(5)])

    def boom(*a, **k):
        raise AssertionError("EM-Fixed reached the adaptive E-step")

    monkeypatch.setattr(estep_ops, "estep_kernel", boom)
    monkeypatch.setattr(estep_ops, "estep", boom)
    jc = jcfg.EStepConfig(method="fixed", fixed_bias_units=units, fixed_fg_bias=4.0)
    want = np.asarray(jax_estep_labels(jnp.asarray(scores), jnp.asarray(label), None, jc))
    for impl in ("auto", "pallas", "jax", "native"):
        pc = pcfg.EStepConfig(method="fixed", fixed_bias_units=units, fixed_fg_bias=4.0,
                              impl=impl)
        got = estep_labels(torch.from_numpy(scores), torch.from_numpy(label),
                           torch.from_numpy(orders.astype(np.int32)), pc)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want, err_msg=impl)


def _cfgs(units):
    kw = dict(
        model=dict(num_classes=4, input_size=(33, 33), fc6_channels=16,
                   width_multiplier=0.125, dropout_keep_prob=1.0, init_scheme="he"),
        estep=dict(method="fixed", fixed_bias_units=units, num_iter=2),
        optim=dict(accum_steps=1, base_lr=0.05, lr_schedule=()),
        train=dict(batch_size=2, seed=0),
    )

    def build(mod):
        return mod.ExperimentConfig(
            model=mod.ModelConfig(**kw["model"]), estep=mod.EStepConfig(**kw["estep"]),
            optim=mod.OptimConfig(**kw["optim"]), train=mod.TrainConfig(**kw["train"]))

    return build(jcfg), build(pcfg)


@pytest.mark.parametrize("units", UNITS)
def test_train_step_with_fixed_method_matches_jax(units):
    """One step with method "fixed" (``tests/test_estep.py::
    test_trainer_step_with_fixed_method`` on shared weights and batch,
    keep-prob 1): weak labels identical, loss within rtol 1e-5, every
    gradient leaf within rtol 1e-4 and 1e-5 of its scale (as
    ``test_torch_train.py::test_one_step_matches_jax_step``)."""
    from em_adapt_tpu.models import DeepLabLargeFOV as JaxDeepLab
    from em_adapt_tpu.ops.resize import resize_nearest_tf
    from em_adapt_tpu.train.optim import build_optimizer
    from em_adapt_tpu.train.state import TrainState as JaxState
    from em_adapt_tpu.train.trainer import _step_fn

    jc, pc = _cfgs(units)
    jmodel = JaxDeepLab(jc.model)
    params = jmodel.init(jax.random.key(0))
    tx, _ = build_optimizer(jc.optim, 1)
    jstate = JaxState.create(params, tx, jax.random.key(1))
    g = np.random.default_rng(5)
    batch = {"image": (g.normal(size=(2, 33, 33, 3)) * 40).astype(np.float32),
             "label": np.zeros((2, 33, 33, 1), np.float32)}
    batch["label"][:, 11:, :16] = 1
    batch["label"][1, :11, 16:] = 3
    batch["label"][:, :3] = 255.0
    jbatch = jax.tree.map(jnp.asarray, batch)

    @jax.jit
    def weak_labels(p, b):
        logits = jmodel.apply(p, b["image"], train=False)
        shrunk = resize_nearest_tf(b["label"], (5, 5))[..., 0]
        return jax_estep_labels(logits, shrunk, None, jc.estep)

    weak_j = np.asarray(weak_labels(params, jbatch))
    new_jstate, jmetrics = jax.jit(_step_fn(jmodel, jc, tx))(jstate, jbatch)
    grads_j = optax.tree_utils.tree_get(new_jstate.opt_state, "trace")

    np_params = jax.tree.map(np.asarray, params)
    model = DeepLabLargeFOV(pc.model).load_params(np_params)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    orders = torch.zeros(2, 3, dtype=torch.int32)  # unused by EM-Fixed
    total, metrics = loss_fn(model, tbatch, pc, generator=torch.Generator(), orders=orders)
    np.testing.assert_array_equal(metrics["weak"].numpy(), weak_j)
    np.testing.assert_allclose(total.item(), float(jmetrics["loss"]), rtol=1e-5)
    total.backward()
    grads = to_jax_params({k: p.grad for k, p in model.state_dict(keep_vars=True).items()})
    for name in np_params:
        for k in ("w", "b"):
            want = np.asarray(grads_j[name][k])
            np.testing.assert_allclose(grads[name][k], want, rtol=1e-4,
                                       atol=1e-5 * np.abs(want).max(), err_msg=f"{name}.{k}")


@pytest.mark.parametrize("estep,hints", [
    (dict(method="adaptive"), 0),
    (dict(method="fixed"), 1),
    (dict(method="fixed", fixed_bias_units="spread", fixed_bg_bias=4.0, fixed_fg_bias=4.0), 0),
    (dict(method="fixed", fixed_bias_units="spread"), 1),
], ids=["adaptive", "fixed_logit", "fixed_spread_symmetric", "fixed_spread_asymmetric"])
def test_config_hints_equal_jax(estep, hints):
    """The EM-Fixed hints are JAX's ``config_hints`` strings, and Trainer
    emits each as a UserWarning (on a one-device plan, where JAX's
    spatial-mesh hint cannot fire)."""
    from em_adapt_tpu.train.trainer import config_hints as jax_config_hints

    jc = jcfg.ExperimentConfig(estep=jcfg.EStepConfig(**estep))
    pc = pcfg.ExperimentConfig(estep=pcfg.EStepConfig(**estep))
    plan = types.SimpleNamespace(mesh=types.SimpleNamespace(devices=np.zeros(1)),
                                 num_space_shards=1)
    want = jax_config_hints(jc, plan)
    assert config_hints(pc) == want
    assert len(want) == hints
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        Trainer(pc, device="cpu")
    assert [str(w.message) for w in caught if w.category is UserWarning] == want
