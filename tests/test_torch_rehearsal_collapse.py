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

With ``--track SEED``, it follows one init for many steps in four
trajectories (the port, the JAX package, and each again with one pixel of
the first batch moved by one f32 ulp), the draws shared as in
:func:`track`, and writes per step each one's loss, fc6 live share and
E-step class shares, and the relative L2 distances port-JAX, port-ulp
twin and JAX-ulp twin (about 8 s a step on 8 cores):

    python -m tests.test_torch_rehearsal_collapse --track 1 --steps 400 --out PARITY_LONG_TORCH.json

With ``--warm PRIOR.npy`` the four trajectories start instead from a
trained prior's parameters (``export --format npy``) under the schedule
rehearsal's weak-warmstart arguments (``schedule_rehearsal.train_cmd``
with strong fraction 0, its dotted overrides applied to each package's
defaults; its 768-image stream of seed 0), and each trajectory's val
mIoU by the VOC protocol on the schedule's 48 val images is logged at
step 0 and every 192 steps (:func:`track_warm`, :func:`warm_verdict`):

    python -m tests.test_torch_rehearsal_collapse --warm prior.npy --steps 384 --out PARITY_WEAK_WARMSTART_TORCH.json
"""

import argparse
import functools
import json
import math
import os
import sys
import time

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


@functools.lru_cache(maxsize=2)
def _jax_step(jc=None, steps_per_epoch: int = 1):
    from em_adapt_tpu.models import DeepLabLargeFOV as JaxDeepLab
    from em_adapt_tpu.train.optim import build_optimizer
    from em_adapt_tpu.train.trainer import _step_fn

    jc = jc or _cfgs()[0]
    tx, _ = build_optimizer(jc.optim, steps_per_epoch)
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


def _port_state(model, pc=None, steps_per_epoch: int = 1):
    pc = pc or _cfgs()[1]
    names, params = zip(*model.named_parameters())
    return TrainState(model, AccumulatingSGD(params, pc.optim, steps_per_epoch, names=names),
                      torch.Generator())


def _jax_draws(jstate):
    """The key of the JAX state's next step, and the dropout masks (NCHW
    bool) and class orders it draws, as the port takes them injected."""
    from em_adapt_tpu.ops.estep import make_class_orders as jax_orders

    rng = jax.random.split(jax.random.fold_in(jstate.rng, jstate.step))[0]
    drop_rng, order_rng = jax.random.split(rng)
    masks = tuple(
        torch.from_numpy(np.array(jax.random.bernoulli(k, KEEP, (8, OUT, OUT, FC6))))
        .permute(0, 3, 1, 2) for k in jax.random.split(drop_rng, 2))
    return rng, masks, torch.from_numpy(np.array(jax_orders(order_rng, 5, 4)))


def track(seed: int, steps: int) -> list[dict]:
    """``steps`` EM steps from the port's init for ``seed`` in both
    packages, JAX's masks and orders injected into the port: per step the
    two losses and fc6's live share after the update in each."""
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
            _, masks, orders = _jax_draws(jstate)
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


@functools.lru_cache(maxsize=2)
def _jax_weak(jc=None):
    """The JAX step's E-step labels: its forward and ``estep_labels`` with
    the dropout and order keys that ``_step_fn`` and ``loss_fn`` derive."""
    from em_adapt_tpu.models import DeepLabLargeFOV as JaxDeepLab
    from em_adapt_tpu.ops.estep import estep_labels, make_class_orders
    from em_adapt_tpu.ops.resize import resize_nearest_tf

    jc = jc or _cfgs()[0]
    model = JaxDeepLab(jc.model)

    def weak(params, batch, rng):
        drop_rng, order_rng = jax.random.split(rng)
        logits = model.apply(params, batch["image"], train=True, rng=drop_rng)
        shrunk = resize_nearest_tf(batch["label"], logits.shape[1:3])[..., 0]
        orders = make_class_orders(order_rng, jc.estep.num_iter, jc.model.num_classes)
        return estep_labels(logits, shrunk, orders, jc.estep)

    return jax.jit(weak)


def rel_l2(a: dict, b: dict) -> float:
    """||a - b|| / ||b|| over every parameter of two ``{layer: {"w", "b"}}``
    trees, in f64."""
    num = den = 0.0
    for layer, leaves in b.items():
        for k, v in leaves.items():
            v = np.asarray(v, np.float64)
            num += float(np.sum((np.asarray(a[layer][k], np.float64) - v) ** 2))
            den += float(np.sum(v * v))
    return math.sqrt(num / den)


def _shares(labels, c: int = 4) -> list[float]:
    counts = np.bincount(np.asarray(labels).reshape(-1), minlength=c)
    return (counts / counts.sum()).tolist()


def _four_tracks(init: dict, cfgs, batches, steps: int, jax_key, *, steps_per_epoch: int = 1,
                 val_fn=None, val_every: int | None = None, log=None) -> tuple[list, list]:
    """The four trajectories of :func:`track_long` from the parameter tree
    ``init`` under ``cfgs`` (JAX's, the port's): (per-step rows, val
    records). With ``val_fn(name, params)``, a val record {step, port,
    jax, port_ulp, jax_ulp} at step 0 and after every ``val_every`` steps."""
    from em_adapt_tpu.train.state import TrainState as JaxState

    jc, pc = cfgs
    tx, step_fn = _jax_step(jc, steps_per_epoch)
    weak_fn = _jax_weak(jc)
    ports = {name: _port_state(DeepLabLargeFOV(pc.model).load_params(init), pc, steps_per_epoch)
             for name in ("port", "port_ulp")}
    jaxes = {name: JaxState.create(jax.tree.map(jnp.asarray, init), tx, jax_key)
             for name in ("jax", "jax_ulp")}
    names = ("port", "jax", "port_ulp", "jax_ulp")
    vals = []
    if val_fn is not None:
        params = {n: to_jax_params(ports[n].model) for n in ports}
        params.update({n: jax.tree.map(np.asarray, jaxes[n].params) for n in jaxes})
        vals.append({"step": 0, **{n: val_fn(n, params[n]) for n in names}})
        if log is not None:
            log(vals[-1])
    rows = []
    t0 = time.time()
    for i in range(steps):
        batch = {k: v for k, v in next(batches).items() if k in ("image", "label")}
        twin = dict(batch)
        if i == 0:
            twin["image"] = image = batch["image"].copy()
            image[0, 0, 0, 0] = np.nextafter(image[0, 0, 0, 0], np.float32(np.inf))
        inputs = {"port": batch, "port_ulp": twin, "jax": batch, "jax_ulp": twin}
        rng, masks, orders = _jax_draws(jaxes["jax"])
        row, params = {"step": i}, {}
        for name, state in ports.items():
            m = train_step(state, {k: torch.from_numpy(v) for k, v in inputs[name].items()},
                           pc, orders=orders, masks=masks)
            params[name] = to_jax_params(state.model)
            row[name] = {"loss": m["loss"].item(), "shares": _shares(m["weak"])}
        for name, js in jaxes.items():
            b = jax.tree.map(jnp.asarray, inputs[name])
            weak = weak_fn(js.params, b, rng)
            jaxes[name], jm = step_fn(js, b)
            params[name] = jax.tree.map(np.asarray, jaxes[name].params)
            row[name] = {"loss": float(jm["loss"]), "shares": _shares(weak)}
        for name in inputs:
            row[name]["live"] = fc6_live(params[name], inputs[name]["image"])
        row["d_port_jax"] = rel_l2(params["port"], params["jax"])
        row["d_port_ulp"] = rel_l2(params["port_ulp"], params["port"])
        row["d_jax_ulp"] = rel_l2(params["jax_ulp"], params["jax"])
        row["seconds"] = time.time() - t0
        rows.append(row)
        if log is not None:
            log(row)
        if val_fn is not None and val_every and (i + 1) % val_every == 0:
            vals.append({"step": i + 1, **{n: val_fn(n, params[n]) for n in names}})
            if log is not None:
                log(vals[-1])
    return rows, vals


def track_long(seed: int, steps: int, log=None) -> dict:
    """``steps`` EM steps from the port's init for ``seed`` in four
    trajectories: the port ("port"), the JAX package ("jax"), and each
    with pixel [0, 0, 0, 0] of the first batch moved up by one f32 ulp
    ("port_ulp", "jax_ulp"). All four share the batches, and JAX's dropout
    masks and class orders are injected into both port runs, so the two
    pairs differ only in that ulp and port-JAX only in arithmetic. Per
    step (after its update) each run's loss, fc6 live share on the
    step's batch and E-step class shares, and the relative L2 distances of
    all parameters: port-JAX ("d_port_jax"), port-port_ulp ("d_port_ulp"),
    JAX-jax_ulp ("d_jax_ulp")."""
    cfgs = _cfgs()
    init = to_jax_params(build_model(cfgs[1].model, seed, torch.device("cpu")))
    it = _batches(seed)
    try:
        rows, _ = _four_tracks(init, cfgs, it, steps, jax.random.key(seed + 1), log=log)
    finally:
        it.close()
    return {"seed": seed, "steps": steps, "config": {
        "input_size": HW, "fc6_channels": FC6, "num_classes": 4, "keep": KEEP,
        "init_scheme": "he", "batch_size": 8, "lr": 1e-3, "torch_threads": torch.get_num_threads()},
        "rows": rows}


#: The fault criterion (PERF.md): the port-JAX distance that counts as
#: apart, and the one-step growth that counts as a jump.
APART, JUMP = 1e-2, 10.0


def verdict(rows: list[dict]) -> dict:
    """The fault criterion on a :func:`track_long` record. ``first_apart``
    per distance: the first step (1-based count of steps taken) at which it
    reaches ``APART``, or None. A fault is indicated when port-JAX gets
    there in fewer than half the steps of either ulp pair (a pair that
    never does counts as infinitely many), or when in one step port-JAX
    grows by ``JUMP`` or more while neither ulp pair does (steps where
    any of the three was 0 before are skipped)."""
    keys = ("d_port_jax", "d_port_ulp", "d_jax_ulp")
    first = {k: next((r["step"] + 1 for r in rows if r[k] >= APART), None) for k in keys}
    inf = float("inf")
    pj = first["d_port_jax"] or inf
    ulp = min(first["d_port_ulp"] or inf, first["d_jax_ulp"] or inf)
    slow = pj < inf and pj < ulp / 2
    jumps = []
    for prev, r in zip(rows, rows[1:]):
        if min(prev[k] for k in keys) <= 0:
            continue
        g = {k: r[k] / prev[k] for k in keys}
        if g["d_port_jax"] >= JUMP and g["d_port_ulp"] < JUMP and g["d_jax_ulp"] < JUMP:
            jumps.append({"step": r["step"], **g})
    return {"first_apart": first, "apart_early": slow, "jumps": jumps,
            "fault": bool(slow or jumps)}


def test_track_mode_records_three_steps(tmp_path):
    """``--track``'s code path for 3 steps from seed 1's init: the record's
    keys per step and per trajectory, distances that start at 0 < d, and
    the criterion's verdict, written as JSON."""
    threads = torch.get_num_threads()
    out = tmp_path / "track.json"
    try:
        assert main(["--track", "1", "--steps", "3", "--threads", "4", "--out", str(out)]) == 0
    finally:
        torch.set_num_threads(threads)
    rec = json.loads(out.read_text())
    assert rec["seed"] == 1 and rec["steps"] == 3 and len(rec["rows"]) == 3
    assert set(rec["verdict"]) == {"first_apart", "apart_early", "jumps", "fault"}
    for i, row in enumerate(rec["rows"]):
        assert set(row) == {"step", "port", "jax", "port_ulp", "jax_ulp", "d_port_jax",
                            "d_port_ulp", "d_jax_ulp", "seconds"}
        assert row["step"] == i
        for name in ("port", "jax", "port_ulp", "jax_ulp"):
            assert set(row[name]) == {"loss", "shares", "live"}
            assert len(row[name]["shares"]) == 4 and abs(sum(row[name]["shares"]) - 1) < 1e-9
        assert 0 < row["d_port_jax"] < 1e-3 and 0 < row["d_port_ulp"] < 1e-3
        assert 0 < row["d_jax_ulp"] < 1e-3
    first = rec["rows"][0]
    np.testing.assert_allclose(first["port"]["loss"], first["jax"]["loss"], rtol=1e-5)


def _rows(pj, pp, jj):
    return [{"step": i, "d_port_jax": a, "d_port_ulp": b, "d_jax_ulp": c}
            for i, (a, b, c) in enumerate(zip(pj, pp, jj))]


@pytest.mark.parametrize("pj,pp,jj,fault,early,jumps", [
    # All three part at the same pace: no fault.
    ([1e-6, 1e-4, 1e-3, 2e-2], [1e-9, 1e-4, 2e-3, 3e-2], [1e-9, 1e-4, 1e-3, 1e-2],
     False, False, []),
    # Port-JAX apart at step 2, the ulp pairs at 5 and never: fault (a).
    ([1e-4, 2e-2, 3e-2, 4e-2, 5e-2], [1e-9, 2e-9, 4e-9, 8e-9, 1e-2], [1e-9] * 5,
     True, True, [1]),
    # A tenfold jump in port-JAX alone at step 2: fault (b).
    ([1e-6, 1e-5, 1e-4, 2e-4], [1e-6, 2e-6, 4e-6, 8e-6], [1e-6, 2e-6, 4e-6, 8e-6],
     True, False, [1, 2]),
    # A tenfold jump in all three at once is chaos, not a fault.
    ([1e-6, 1e-5, 1e-4], [1e-7, 1e-6, 1e-5], [1e-7, 1e-6, 1e-5], False, False, []),
    # A zero distance before a step skips that step's growth.
    ([0.0, 1e-5, 2e-5], [0.0, 1e-6, 2e-6], [0.0, 1e-6, 2e-6], False, False, []),
])
def test_fault_criterion(pj, pp, jj, fault, early, jumps):
    v = verdict(_rows(pj, pp, jj))
    assert v["fault"] is fault and v["apart_early"] is early
    assert [j["step"] for j in v["jumps"]] == jumps


def test_committed_parity_record_matches_its_verdict():
    """PARITY_LONG_TORCH.json: four 400-step trajectories from seed 1's
    init, every distance recorded, and the verdict stored with it the one
    the criterion gives on its rows."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "PARITY_LONG_TORCH.json")
    with open(path) as f:
        rec = json.load(f)
    assert rec["seed"] == 1 and rec["steps"] == 400 and len(rec["rows"]) == 400
    assert all(np.isfinite(r[k]) for r in rec["rows"]
               for k in ("d_port_jax", "d_port_ulp", "d_jax_ulp"))
    assert rec["verdict"] == json.loads(json.dumps(verdict(rec["rows"])))


def _warm_cfgs():
    """(JAX's, the port's) config of the schedule rehearsal's weak-warmstart
    arms: ``schedule_rehearsal.train_cmd``'s dotted overrides at strong
    fraction 0 (so no semi-supervision) on each package's defaults."""
    from em_adapt_torch.tools import schedule_rehearsal as sr

    cmd = sr.train_cmd(sr.PROTOCOL, "unused", "unused.jsonl", strong_fraction=0.0)
    overrides = [a for a in cmd if "=" in a and "." in a.partition("=")[0]
                 and not a.startswith("-")]
    return (jcfg.apply_overrides(jcfg.ExperimentConfig(), overrides),
            pcfg.apply_overrides(pcfg.ExperimentConfig(), overrides)), overrides


def _load_prior(path: str) -> dict:
    tree = np.load(path, allow_pickle=True).item()
    return {layer: {k: np.asarray(v, np.float32) for k, v in leaves.items()}
            for layer, leaves in tree.items()}


def track_warm(prior: str, steps: int, *, val_every: int = 192, val_images: int | None = None,
               log=None) -> dict:
    """The four trajectories of :func:`track_long` from the parameters in
    the npy file ``prior`` (the reference's init.npy layout, ``export
    --format npy``) under :func:`_warm_cfgs`, on the schedule rehearsal's
    stream (``LearnableSyntheticVOC`` of its size and seed 0, strong
    fraction 0, ``batch_iterator`` at the train seed, as ``train`` feeds
    ``fit``), with the LR schedule over its epochs and the JAX state's key
    as the JAX trainer splits it for seed 0. Each trajectory's val mIoU by
    the VOC protocol on the schedule's val images (seed 0, "val") at step
    0 and every ``val_every`` steps. ``init_distance``: each package's
    parameters before the first step against the prior's, and against
    each other (0 when the carry-over is exact)."""
    import hashlib

    from em_adapt_torch.eval.predict import Evaluator
    from em_adapt_torch.tools import schedule_rehearsal as sr
    from em_adapt_tpu.eval.predict import Evaluator as JaxEvaluator
    from em_adapt_tpu.models import DeepLabLargeFOV as JaxDeepLab
    from em_adapt_tpu.train.state import TrainState as JaxState

    (jc, pc), overrides = _warm_cfgs()
    proto = sr.PROTOCOL
    init = _load_prior(prior)
    with open(prior, "rb") as f:
        sha = hashlib.sha256(f.read()).hexdigest()
    port0 = to_jax_params(DeepLabLargeFOV(pc.model).load_params(init))
    k_state = jax.random.split(jax.random.key(jc.train.seed))[1]  # as _build_state
    tx, _ = _jax_step(jc, proto.steps_per_epoch)
    jax0 = jax.tree.map(np.asarray, JaxState.create(jax.tree.map(jnp.asarray, init), tx,
                                                    k_state).params)
    init_distance = {"port_prior": rel_l2(port0, init), "jax_prior": rel_l2(jax0, init),
                     "port_jax": rel_l2(port0, jax0)}
    n_val = proto.val_images if val_images is None else val_images
    val_ds = ppipe.LearnableSyntheticVOC(n_val, 4, seed=pc.train.seed, category="val",
                                         image_size=pc.data.input_size[0])
    jev = JaxEvaluator(jc, JaxDeepLab(jc.model))

    def val_fn(name: str, params: dict) -> float:
        if name.startswith("port"):
            model = DeepLabLargeFOV(pc.model).load_params(params)
            return Evaluator(pc, model).evaluate_voc(val_ds, use_crf=False)[0]
        return float(jev.evaluate_voc(jax.tree.map(jnp.asarray, params), val_ds,
                                      use_crf=False)[0])

    ds = ppipe.LearnableSyntheticVOC(proto.images, 4, seed=pc.train.seed,
                                     image_size=pc.data.input_size[0], strong_fraction=0.0)
    it = ppipe.batch_iterator(ds, pc.data, batch_size=pc.train.batch_size, seed=pc.train.seed)
    try:
        rows, vals = _four_tracks(init, (jc, pc), it, steps, k_state,
                                  steps_per_epoch=proto.steps_per_epoch, val_fn=val_fn,
                                  val_every=val_every, log=log)
    finally:
        it.close()
    return {"prior": {"path": os.path.basename(prior), "sha256": sha}, "steps": steps,
            "config": {"overrides": overrides, "images": proto.images, "val_images": n_val,
                       "steps_per_epoch": proto.steps_per_epoch, "val_every": val_every,
                       "torch_threads": torch.get_num_threads()},
            "init_distance": init_distance, "rows": rows, "val": vals}


#: The weak regime's fault criterion on val mIoU (PERF.md): how far the
#: port's last val may lie outside the interval of JAX and its ulp twin.
MIOU_SLACK = 0.03


def warm_verdict(rows: list[dict], vals: list[dict]) -> dict:
    """The fault criterion on a :func:`track_warm` record: a port fault when
    port-JAX grows ``JUMP``-fold in one step where neither ulp pair does
    (:func:`verdict`'s jumps), or when the port's mIoU at the last val
    lies more than ``MIOU_SLACK`` outside [min, max] of JAX's and its ulp
    twin's there. :func:`verdict`'s other fields are kept for the record."""
    base = verdict(rows)
    last = vals[-1]
    lo, hi = min(last["jax"], last["jax_ulp"]), max(last["jax"], last["jax_ulp"])
    outside = max(lo - last["port"], last["port"] - hi, 0.0)
    return {"jumps": base["jumps"], "first_apart": base["first_apart"],
            "apart_early": base["apart_early"], "val_step": last["step"],
            "jax_interval": [lo, hi], "port_miou": last["port"], "port_outside": outside,
            "fault": bool(base["jumps"] or outside > MIOU_SLACK)}


def test_warm_track_starts_from_the_prior_bit_for_bit(tmp_path):
    """``--warm``'s code path for one step from an exported prior (the
    port's seed-5 He init, written by ``export_params_npy``): both
    packages hold the prior bit for bit before the first step (every
    initial distance 0, so the first step's distances come from
    arithmetic alone), the four step-0 val mIoUs are equal, and the
    record's rows, val points and verdict are written as JSON."""
    from em_adapt_torch.eval.export import export_params_npy

    (jc, pc), overrides = _warm_cfgs()
    assert (pc.optim.base_lr, pc.train.batch_size, pc.data.random_scale) == (1e-3, 8, False)
    assert (jc.optim.base_lr, jc.train.batch_size, jc.data.random_scale) == (1e-3, 8, False)
    assert pc.model.input_size == jc.model.input_size == (HW, HW)
    assert pc.model.fc6_channels == FC6 and not pc.semi_supervised
    prior = tmp_path / "prior.npy"
    export_params_npy(build_model(pc.model, 5, torch.device("cpu")), str(prior))
    out = tmp_path / "warm.json"
    threads = torch.get_num_threads()
    try:
        assert main(["--warm", str(prior), "--steps", "1", "--val-every", "1",
                     "--val-images", "2", "--threads", "4", "--out", str(out)]) == 0
    finally:
        torch.set_num_threads(threads)
    rec = json.loads(out.read_text())
    assert rec["init_distance"] == {"port_prior": 0.0, "jax_prior": 0.0, "port_jax": 0.0}
    assert len(rec["prior"]["sha256"]) == 64 and rec["steps"] == 1
    assert [v["step"] for v in rec["val"]] == [0, 1]
    v0 = rec["val"][0]
    assert v0["port"] == v0["jax"] == v0["port_ulp"] == v0["jax_ulp"]
    row = rec["rows"][0]
    assert 0 < row["d_port_jax"] < 1e-3 and 0 < row["d_port_ulp"] < 1e-3
    np.testing.assert_allclose(row["port"]["loss"], row["jax"]["loss"], rtol=1e-5)
    assert rec["verdict"] == json.loads(json.dumps(warm_verdict(rec["rows"], rec["val"])))


@pytest.mark.parametrize("port,jax_,jax_ulp,fault", [
    (0.30, 0.31, 0.29, False),   # inside JAX's interval
    (0.25, 0.31, 0.29, True),    # 0.04 below it
    (0.265, 0.31, 0.29, False),  # 0.025 below: within the slack
    (0.35, 0.31, 0.29, True),    # 0.04 above it
])
def test_warm_miou_criterion(port, jax_, jax_ulp, fault):
    rows = _rows([1e-6, 2e-6], [1e-6, 2e-6], [1e-6, 2e-6])
    vals = [{"step": 0, "port": 0.3, "jax": 0.3, "port_ulp": 0.3, "jax_ulp": 0.3},
            {"step": 2, "port": port, "jax": jax_, "port_ulp": port, "jax_ulp": jax_ulp}]
    v = warm_verdict(rows, vals)
    assert v["fault"] is fault and v["jumps"] == []
    assert v["jax_interval"] == [min(jax_, jax_ulp), max(jax_, jax_ulp)]


def test_committed_warm_parity_record_matches_its_verdict():
    """PARITY_WEAK_WARMSTART_TORCH.json: four 384-step trajectories from the
    weak-EM prior, every distance recorded, val points at 0, 192 and 384,
    the prior's sha256, and the verdict stored with it the one the
    criterion gives on its rows and val points."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "PARITY_WEAK_WARMSTART_TORCH.json")
    if not os.path.exists(path):
        pytest.skip("PARITY_WEAK_WARMSTART_TORCH.json not generated yet")
    with open(path) as f:
        rec = json.load(f)
    assert rec["steps"] == 384 and len(rec["rows"]) == 384
    assert [v["step"] for v in rec["val"]] == [0, 192, 384]
    assert len(rec["prior"]["sha256"]) == 64
    assert rec["init_distance"] == {"port_prior": 0.0, "jax_prior": 0.0, "port_jax": 0.0}
    assert all(np.isfinite(r[k]) for r in rec["rows"]
               for k in ("d_port_jax", "d_port_ulp", "d_jax_ulp"))
    assert rec["verdict"] == json.loads(json.dumps(warm_verdict(rec["rows"], rec["val"])))


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
    ap.add_argument("--track", type=int, default=None, metavar="SEED",
                    help="follow SEED's init in four trajectories (see track_long)")
    ap.add_argument("--warm", default=None, metavar="PRIOR.npy",
                    help="follow four trajectories from this prior under the schedule "
                         "rehearsal's weak-warmstart arguments (see track_warm)")
    ap.add_argument("--val-every", type=int, default=192, help="--warm's val cadence")
    ap.add_argument("--val-images", type=int, default=None,
                    help="--warm's val images (default: the schedule's 48)")
    ap.add_argument("--out", default=None, help="--track's or --warm's JSON record")
    ap.add_argument("--threads", type=int, default=os.cpu_count() or 4,
                    help="--track's and --warm's torch threads (default: every core)")
    args = ap.parse_args(argv)
    if args.warm is not None:
        torch.set_num_threads(args.threads)

        def log(rec):
            if "d_port_jax" not in rec:  # a val record
                print(json.dumps(rec), flush=True)
            elif rec["step"] % 8 == 0:
                print(json.dumps({k: rec[k] for k in ("step", "d_port_jax", "d_port_ulp",
                                                        "d_jax_ulp", "seconds")}
                                 | {n: rec[n]["loss"] for n in ("port", "jax")}), flush=True)

        result = track_warm(args.warm, args.steps, val_every=args.val_every,
                            val_images=args.val_images, log=log)
        result["verdict"] = warm_verdict(result["rows"], result["val"])
        print(json.dumps(result["verdict"]), flush=True)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(result, f, indent=1)
        return 0
    if args.track is not None:
        torch.set_num_threads(args.threads)

        def log(row):
            print(json.dumps({k: row[k] for k in ("step", "d_port_jax", "d_port_ulp",
                                                    "d_jax_ulp", "seconds")}
                             | {n: row[n]["live"] for n in ("port", "jax")}), flush=True)

        result = track_long(args.track, args.steps, log)
        result["verdict"] = verdict(result["rows"])
        print(json.dumps(result["verdict"]), flush=True)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(result, f, indent=1)
        return 0
    result = survey(args.seeds, args.steps, args.first)
    print({k: v for k, v in result.items() if k != "rows"}, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
