"""PyTorch port: the weak rehearsal's first EM steps from a given init,
against the JAX package's, at the rehearsal's full size on the CPU.

The configuration is ``convergence_rehearsal.run_rehearsal``'s: full-width
VGG, fc6 64, 4 classes, He init, keep 0.5, 129x129, batch 8 of
``LearnableSyntheticVOC``, accumulation 1, lr 1e-3. From the port's own
init for a seed (drawn on the CPU, as on the card), carried into the JAX
package, both take the same batches with JAX's dropout masks and class
orders injected into the port. From seed 3's init the first update
blows up (CE about 41 at step 1) and fc6's ReLUs die in both packages
within three steps; seed 4's survive. The weak artifact's seed 3, which
predicts all background at every eval, is this collapse.

Run as a script, it surveys how often each package's own init collapses
(each with its own draws: the port's init and ``torch.Generator``, the
JAX package's ``jax.random.key(seed)`` split as its trainer splits it):

    python -m tests.test_torch_rehearsal_collapse --seeds 16 --steps 12 [--first 16]
"""

import argparse
import functools
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import em_adapt_tpu.config as jcfg  # noqa: E402
from em_adapt_torch import config as pcfg  # noqa: E402
from em_adapt_torch.data import pipeline as ppipe  # noqa: E402
from em_adapt_torch.models.convert import to_jax_params  # noqa: E402
from em_adapt_torch.models.deeplab import DeepLabLargeFOV, build_model  # noqa: E402
from em_adapt_torch.train.optim import AccumulatingSGD  # noqa: E402
from em_adapt_torch.train.trainer import TrainState, train_step  # noqa: E402

torch.set_num_threads(4)

HW, FC6, KEEP = 129, 64, 0.5
OUT = -(-HW // 8)
#: fc6's share of positive pre-activations below which it counts as dead.
DEAD = 0.01


def _cfgs():
    def build(mod):
        return mod.ExperimentConfig(
            model=mod.ModelConfig(num_classes=4, input_size=(HW, HW), fc6_channels=FC6,
                                  dropout_keep_prob=KEEP, init_scheme="he"),
            estep=mod.EStepConfig(num_iter=5, bg_p=0.4, fg_p=0.2),
            optim=mod.OptimConfig(base_lr=1e-3, accum_steps=1, lr_schedule=()),
            data=mod.DataConfig(input_size=(HW, HW), num_workers=2, random_scale=False),
            train=mod.TrainConfig(batch_size=8))

    return build(jcfg), build(pcfg)


@functools.lru_cache(maxsize=1)
def _jax_step():
    from em_adapt_tpu.models import DeepLabLargeFOV as JaxDeepLab
    from em_adapt_tpu.train.optim import build_optimizer
    from em_adapt_tpu.train.trainer import _step_fn

    jc, _ = _cfgs()
    tx, _ = build_optimizer(jc.optim, 1)
    return tx, jax.jit(_step_fn(JaxDeepLab(jc.model), jc, tx))


def _batches(seed):
    _, pc = _cfgs()
    ds = ppipe.LearnableSyntheticVOC(n=512, num_classes=4, seed=seed, image_size=HW)
    return ppipe.batch_iterator(ds, pc.data, batch_size=8, seed=seed, train=True)


def fc6_live(params: dict, image: np.ndarray) -> float:
    """fc6's share of positive pre-activations on ``image`` (eval mode:
    dropout acts after fc6's ReLU, so the share is the same)."""
    _, pc = _cfgs()
    model = DeepLabLargeFOV(pc.model).load_params(params)
    seen = {}
    model.layers["fc6"].register_forward_hook(lambda m, i, o: seen.setdefault("x", o.clone()))
    with torch.no_grad():
        model(torch.from_numpy(image))
    return float((seen["x"] > 0).float().mean())


def _port_state(model):
    _, pc = _cfgs()
    names, params = zip(*model.named_parameters())
    return TrainState(model, AccumulatingSGD(params, pc.optim, names=names), torch.Generator())


def track(seed: int, steps: int) -> list[dict]:
    """``steps`` EM steps from the port's init for ``seed`` in both
    packages, JAX's masks and orders injected into the port: per step the
    two losses and fc6's live share after the update in each."""
    from em_adapt_tpu.ops.estep import make_class_orders as jax_orders
    from em_adapt_tpu.train.state import TrainState as JaxState

    _, pc = _cfgs()
    tx, step_fn = _jax_step()
    model = build_model(pc.model, seed, torch.device("cpu"))
    jstate = JaxState.create(jax.tree.map(jnp.asarray, to_jax_params(model)), tx,
                             jax.random.key(seed + 1))
    state = _port_state(model)
    out, it = [], _batches(seed)
    try:
        for _ in range(steps):
            batch = {k: v for k, v in next(it).items() if k in ("image", "label")}
            rng = jax.random.split(jax.random.fold_in(jstate.rng, jstate.step))[0]
            drop_rng, order_rng = jax.random.split(rng)
            masks = tuple(
                torch.from_numpy(np.array(jax.random.bernoulli(k, KEEP, (8, OUT, OUT, FC6))))
                .permute(0, 3, 1, 2) for k in jax.random.split(drop_rng, 2))
            orders = torch.from_numpy(np.array(jax_orders(order_rng, 5, 4)))
            jstate, jm = step_fn(jstate, jax.tree.map(jnp.asarray, batch))
            m = train_step(state, {k: torch.from_numpy(v) for k, v in batch.items()}, pc,
                           orders=orders, masks=masks)
            jparams = jax.tree.map(np.asarray, jstate.params)
            out.append({"loss": m["loss"].item(), "jax_loss": float(jm["loss"]),
                        "live": fc6_live(to_jax_params(model), batch["image"]),
                        "jax_live": fc6_live(jparams, batch["image"])})
    finally:
        it.close()
    return out


@pytest.mark.parametrize("seed,collapses", [(3, True), (4, False)])
def test_first_steps_track_jax_through_collapse(seed, collapses):
    """Four EM steps from the port's init for ``seed``: step 0's loss within
    rtol 1e-5 of JAX's, steps 1-3 within 1e-2 (updates of this size,
    fc8's gradient norm in the hundreds at lr 1e-3, carry f32 rounding
    forward, and a weak label that flips at a near tie then moves the
    mean CE over 2,312 pixels by 1e-3 to 1e-2); fc6's live share after
    each update within 1e-3 + 2% of JAX's. Seed 3's fc6 is dead (share
    < 0.01) after step 3 in both; seed 4's is not in either."""
    rows = track(seed, 4)
    for i, r in enumerate(rows):
        np.testing.assert_allclose(r["loss"], r["jax_loss"], rtol=1e-5 if i == 0 else 1e-2,
                                   err_msg=f"step {i}")
        assert abs(r["live"] - r["jax_live"]) <= 1e-3 + 0.02 * r["jax_live"], (i, r)
    assert (rows[-1]["live"] < DEAD) == collapses, rows
    assert (rows[-1]["jax_live"] < DEAD) == collapses, rows


def survey(seeds: int, steps: int, first: int = 0) -> dict:
    """Per package, the seeds whose fc6 is dead (live share < ``DEAD`` on
    the last step's batch) after ``steps`` EM steps from its own init and
    draws; the batches are the same (``LearnableSyntheticVOC``, per seed)."""
    from em_adapt_tpu.models import DeepLabLargeFOV as JaxDeepLab
    from em_adapt_tpu.train.state import TrainState as JaxState

    jc, pc = _cfgs()
    tx, step_fn = _jax_step()
    rows = []
    for seed in range(first, first + seeds):
        model = build_model(pc.model, seed, torch.device("cpu"))
        state = _port_state(model)
        state.generator.manual_seed(seed + 1)  # as Trainer.init_state
        k_params, k_state = jax.random.split(jax.random.key(seed))  # as the JAX trainer
        jstate = JaxState.create(JaxDeepLab(jc.model).init(k_params), tx, k_state)
        it = _batches(seed)
        try:
            for _ in range(steps):
                batch = {k: v for k, v in next(it).items() if k in ("image", "label")}
                train_step(state, {k: torch.from_numpy(v) for k, v in batch.items()}, pc)
                jstate, _ = step_fn(jstate, jax.tree.map(jnp.asarray, batch))
        finally:
            it.close()
        rows.append({"seed": seed, "live": fc6_live(to_jax_params(model), batch["image"]),
                     "jax_live": fc6_live(jax.tree.map(np.asarray, jstate.params),
                                          batch["image"])})
        print(rows[-1], flush=True)
    return {"seeds": [first, first + seeds], "steps": steps, "rows": rows,
            "dead": [r["seed"] for r in rows if r["live"] < DEAD],
            "jax_dead": [r["seed"] for r in rows if r["jax_live"] < DEAD]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="fc6 collapse survey, port and JAX, on the CPU")
    ap.add_argument("--seeds", type=int, default=16)
    ap.add_argument("--first", type=int, default=0, help="the first seed")
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args(argv)
    result = survey(args.seeds, args.steps, args.first)
    print({k: v for k, v in result.items() if k != "rows"}, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
