"""What the weak rehearsal's network does in its first steps, seed by seed.

    python -m em_adapt_torch.tools.rehearsal_probe --seeds 3 4 --steps 400 \\
        --out chiprun_out/rehearsal_probe.json

Runs phase 1 of ``convergence_rehearsal.run_rehearsal`` at its own
configuration (``rehearsal_config``: full-width VGG, fc6 64, 4 classes,
He init, keep 0.5, 129x129, batch 8, lr 1e-3, the same batches and
generator) one ``Trainer.train_step`` at a time, which are the steps
``Trainer.fit`` takes, and records at step 0, at every one of the first
``--dense`` steps and every ``--every`` steps after:

* ``loss``: the cross-entropy against the E-step's labels (no L2);
* ``weak_share`` and ``true_share``: the class shares of the E-step's
  labels and of the true masks at the score map's size, and
  ``pred_share``: those of the logits' argmax;
* for each layer: ``pos``, the share of positive pre-activations (the
  ReLU's live units); ``alive``, the share of channels positive anywhere
  in the batch; and the weight gradient's norm ``grad``;
* ``logit_std``: fc8's spatial standard deviation per class (over the
  17x17 map, averaged over the batch), and ``logit_mean`` per class;

and the val mIoU at step 0 and every ``steps // 20`` steps of a
4000-step run (200), the points of the rehearsal's own curve. Prints one
line per record and writes everything as JSON (``--out``).
``--estep-impl jax`` runs the E-step's sort reference (plain PyTorch) in
place of K1, to take the kernel out of a trajectory. ``--deterministic``
sets cuDNN's deterministic algorithms before any model is built, as the
rehearsal tool's flag does, so that a probe of a seed repeats the tool's
run of it (and two probes agree bit for bit). On the CPU
(``--device cpu``) it runs, slowly, at the full size: use few steps.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import tempfile
import time

import torch

from em_adapt_torch.data.pipeline import LearnableSyntheticVOC, batch_iterator
from em_adapt_torch.device import card_info, resolve_device, set_deterministic
from em_adapt_torch.ops.resize import resize_nearest_tf
from em_adapt_torch.tools.convergence_rehearsal import _val_fn, rehearsal_config
from em_adapt_torch.train.trainer import Trainer, to_device


def _shares(labels: torch.Tensor, c: int) -> list[float]:
    counts = torch.bincount(labels.flatten(), minlength=c)[:c].float()
    return [round(v, 4) for v in (counts / counts.sum().clamp(min=1)).tolist()]


def probe_seed(seed: int, steps: int, dense: int, every: int, device, estep_impl: str = "auto",
               log=print) -> dict:
    """Phase 1's first ``steps`` steps for ``seed``, with the records above;
    ``estep_impl="jax"`` swaps K1 for the E-step's sort reference."""
    run_steps = 4000
    with tempfile.TemporaryDirectory(prefix="rehearsal_probe_") as save_dir:
        cfg = rehearsal_config(run_steps, seed, save_dir=save_dir)
        cfg = dataclasses.replace(cfg, estep=dataclasses.replace(cfg.estep, impl=estep_impl))
        c = cfg.model.num_classes
        trainer = Trainer(cfg, device=device, steps_per_epoch=64)
        state = trainer.init_state()
        model = state.model
        val = _val_fn(cfg, LearnableSyntheticVOC(n=32, num_classes=c, seed=seed,
                                                 category="val", image_size=129))
        train_ds = LearnableSyntheticVOC(n=512, num_classes=c, seed=seed, image_size=129)
        batches = batch_iterator(train_ds, cfg.data, batch_size=8, seed=seed, epochs=None,
                                 train=True)
        acts: dict[str, torch.Tensor] = {}
        watching = [False]

        def hook(name):
            def record(module, inputs, out):
                if watching[0]:
                    acts[name] = out.detach().clone()
            return record

        handles = [layer.register_forward_hook(hook(name))
                   for name, layer in model.layers.items()]
        eval_every = run_steps // 20
        curve, records = [(0, round(float(val(state)[0]), 4))], []
        t0 = time.perf_counter()
        try:
            for step in range(steps):
                batch = to_device(next(batches), trainer.device)
                watching[0] = step < dense or step % every == 0 or step == steps - 1
                model.train()
                metrics = trainer.train_step(state, batch)
                if watching[0]:
                    records.append(_record(step, batch, metrics, acts, model, c))
                    r = records[-1]
                    log(f"[seed {seed}] step {step}: loss {r['loss']:.4f} weak "
                        f"{r['weak_share']} true {r['true_share']} pred {r['pred_share']} "
                        f"logit std {r['logit_std']} mean {r['logit_mean']} pos "
                        + " ".join(f"{k}={v['pos']:.3f}/{v['alive']:.3f}/{v['grad']:.3g}"
                                   for k, v in r["layers"].items()))
                    acts.clear()
                    watching[0] = False
                if (step + 1) % eval_every == 0:
                    curve.append((step + 1, round(float(val(state)[0]), 4)))
                    log(f"[seed {seed}] step {step + 1}: val mIoU {curve[-1][1]}")
        finally:
            batches.close()
            for h in handles:
                h.remove()
            trainer.checkpointer.close()
        return {"seed": seed, "estep_impl": estep_impl, "steps": steps, "miou_curve": curve,
                "records": records,
                "seconds": round(time.perf_counter() - t0, 1)}


def _record(step, batch, metrics, acts, model, c) -> dict:
    logits = acts["fc8"]  # NCHW, before the NHWC view
    out_hw = tuple(logits.shape[2:])
    true = resize_nearest_tf(batch["label"], out_hw)[..., 0].to(torch.int64)
    layers = {}
    for name, layer in model.layers.items():
        pre = acts[name]
        grad = layer.weight.grad
        layers[name] = {
            "pos": float((pre > 0).float().mean()),
            "alive": float((pre > 0).transpose(0, 1).flatten(1).any(1).float().mean()),
            "grad": float(grad.norm()) if grad is not None else 0.0,
        }
    return {
        "step": step,
        "loss": float(metrics["loss_norm"]),
        "weak_share": _shares(metrics["weak"], c),
        "true_share": _shares(true[true < c], c),
        "pred_share": _shares(logits.argmax(1), c),
        "logit_std": [round(v, 4) for v in logits.flatten(2).std(2).mean(0).tolist()],
        "logit_mean": [round(v, 4) for v in logits.mean((0, 2, 3)).tolist()],
        "layers": layers,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[3, 4])
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--dense", type=int, default=20, help="record every one of the first N steps")
    ap.add_argument("--every", type=int, default=10, help="then every N steps")
    ap.add_argument("--estep-impl", default="auto", choices=("auto", "jax"),
                    help="'jax': the E-step's sort reference in place of K1")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    ap.add_argument("--deterministic", action="store_true",
                    help="cuDNN's deterministic algorithms, no autotuning (as the tool's flag)")
    args = ap.parse_args(argv)
    if args.deterministic:
        set_deterministic()
    device = resolve_device(args.device)
    card = card_info() if device.type == "cuda" else None
    print(f"card: {card}", flush=True)
    runs = [probe_seed(s, args.steps, args.dense, args.every, device, args.estep_impl)
            for s in args.seeds]
    result = {"card": card, "platform": device.type, "deterministic": args.deterministic,
              "runs": runs}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f)
    for run in runs:
        print(json.dumps({"seed": run["seed"], "estep_impl": run["estep_impl"],
                          "miou_curve": run["miou_curve"],
                          "seconds": run["seconds"]}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
