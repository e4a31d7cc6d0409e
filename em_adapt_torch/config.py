"""Typed configuration tree for the PyTorch port.

A copy of the dataclasses of ``em_adapt_tpu/config.py`` with the fields
the ported slices read, and the same defaults: ``ExperimentConfig()``
is the reference recipe (f32, batch 6, accumulation 5, 321x321 input, 21
classes). Fields of later slices are added with them. Values the port
does not run yet in a mode (training or evaluation) are rejected by
:func:`check_supported`, which names the ROADMAP.md item that brings them.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class EStepConfig:
    """E-step parameters (reference deeplab.py:181): bg_p=0.4, fg_p=0.2,
    num_iter=5, suppress_others=True, margin_others=1e-5.

    ``impl``: "auto" or "pallas" run the E-step kernel (the hand-written
    CUDA kernel on a CUDA tensor, its plain PyTorch version on a CPU
    tensor); "jax" runs the sort reference. The names follow the JAX
    package so that one config file drives both.
    """

    method: str = "adaptive"
    bg_p: float = 0.4
    fg_p: float = 0.2
    num_iter: int = 5
    suppress_others: bool = True
    margin_others: float = 1e-5
    impl: str = "auto"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """DeepLab-LargeFOV (VGG-16 + atrous) knobs (reference deeplab.py:35-107)."""

    num_classes: int = 21
    input_size: tuple[int, int] = (321, 321)
    input_channels: int = 3
    #: TF1 ``tf.nn.dropout`` keep probability (reference deeplab.py:104, :266).
    dropout_keep_prob: float = 0.5
    #: Uniform width multiplier on the VGG blocks (1.0 = reference widths).
    width_multiplier: float = 1.0
    conv5_rate: int = 2
    fc6_rate: int = 4
    fc6_channels: int = 4096
    #: "float32", or "bfloat16" (one cast at the model's entry, f32 logits).
    compute_dtype: str = "float32"
    remat: bool = False
    #: "xla" runs the conv path; "pallas" the fused block1 (the CUDA
    #: kernels K2 forward and K3 backward on the card); "auto" picks one
    #: (models/deeplab.py::DeepLabLargeFOV._block1_mode).
    block1_impl: str = "auto"
    #: Caffe-converted ``init.npy`` (reference deeplab.py:293); None = random.
    init_model_path: str | None = None
    #: "reference" (N(0, 0.01) weights, zero bias) or "he".
    init_scheme: str = "reference"


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Input pipeline (reference dataset.py:7-19, :107-145)."""

    #: The VOC tree (JPEGImages, SegmentationClassAug) and the directory
    #: of the split lists ``{split}.txt`` that ``VOCSegmentation`` reads.
    main_path: str = "pascal/VOCdevkit/VOC2012"
    list_dir: str = "pascal/txt"
    input_size: tuple[int, int] = (321, 321)
    random_scale: bool = True
    scale_range: tuple[float, float] = (0.75, 1.25)
    flip: bool = True
    #: Keep only the first ``length`` ids of a split (reference dataset.py:38-42).
    length: int | None = None
    #: Host loader threads, and the batches ``DevicePrefetcher`` holds
    #: ready on the device ahead of the step (0: no prefetcher).
    num_workers: int = 8
    prefetch: int = 2
    #: "float32" (BGR mean-subtracted on the host) or "uint8" (raw RGB,
    #: normalized on the device).
    wire_dtype: str = "float32"
    #: Shrink train labels to this size on the host (same TF1 grid).
    train_label_size: tuple[int, int] | None = None


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    """SGD + momentum with accumulation and staged LR (reference
    deeplab.py:188-208, :243-262)."""

    base_lr: float = 1e-3
    momentum: float = 0.9
    weight_decay: float = 1e-5
    accum_steps: int = 5
    lr_schedule: tuple[tuple[int, float], ...] = ((10, 1e-4), (20, 1e-5), (30, 1e-6))
    #: Caffe LR groups (bias x2, fc8 weight x10, fc8 bias x20), the
    #: paper's recipe; off for parity with the reference's code.
    lr_multipliers: bool = False


@dataclasses.dataclass(frozen=True)
class CheckpointConfig:
    """Full-state checkpoints (``em_adapt_tpu/config.py:189-202``): "norm"
    every ``save_every_steps`` microbatch steps (reference deeplab.py:277-278;
    0 disables it), the newest ``max_to_keep`` kept (reference
    network.py:100), and an "lr" snapshot right before each LR drop
    (reference deeplab.py:248, :254, :260)."""

    save_dir: str = "saver"
    save_every_steps: int = 6000
    max_to_keep: int = 2
    snapshot_on_lr_drop: bool = True
    #: Copy the state to host memory in ``save`` and write the file on a thread.
    async_save: bool = True


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 6  # reference deeplab.py:288
    #: The step budget when none is given: epochs * steps_per_epoch
    #: (reference deeplab.py:291).
    epochs: int = 40
    seed: int = 0
    #: ``Trainer.fit`` waits for the card and hands ``log_fn`` a record
    #: every this many steps (reference deeplab.py:273); 0: never.
    log_every_steps: int = 500
    #: Run validation every N steps and keep a "best"-mIoU checkpoint (the
    #: reference created a "best" saver but never used it, network.py:102).
    #: None disables periodic eval.
    eval_every_steps: int | None = None
    #: Protocol of the periodic eval: "fixed" (at the training resolution).
    #: "voc" (per image at its original resolution) is ROADMAP.md Queue 1
    #: item 7.
    eval_protocol: str = "fixed"
    #: Accepted so that one config file drives both packages, and not
    #: ported: levers of the JAX package's TPU dispatch (donated buffers,
    #: K steps fused into one dispatch, the hardware PRNG). The port runs
    #: single steps, which give the same update.
    donate_state: bool = True
    macro_steps: int = 1
    rng_impl: str = "threefry"
    #: Time the deployed E-step (µs/image at this run's score-map shape)
    #: once at train start and stamp it into every train record.
    calibrate_estep: bool = True
    #: Train the first N steps on the weak-tag classification loss
    #: (``train/trainer.py::tag_classification_loss``: LSE-pooled logits
    #: against the image-level tags) instead of the EM objective, then
    #: switch. 0 = off (reference parity: the reference starts EM from a
    #: classification-pretrained init.npy). From random init it makes that
    #: missing prior from the same weak tags.
    tag_warmup_steps: int = 0
    #: Label smoothing of the warm-up's tag BCE: targets in [eps, 1-eps]
    #: give it a finite minimizer (pooled logit ±logit(1-eps), about ±2.9
    #: at 0.05), so the logits cannot run away during the warm-up.
    tag_warmup_smoothing: float = 0.05
    #: LSE pooling sharpness r: (1/r)(logsumexp(r·x) − log HW), the mean
    #: at r→0 and the max at r→∞. At r=1 a spatially constant map already
    #: satisfies the tags; sharper pooling makes peaked maps the cheap
    #: solution.
    tag_warmup_pool_r: float = 4.0


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    """Prediction + mIoU (``em_adapt_tpu/config.py:271-294``); the CRF
    fields come with the CRF (ROADMAP.md Queue 1 item 7)."""

    batch_size: int = 6
    use_crf: bool = False


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    estep: EStepConfig = dataclasses.field(default_factory=EStepConfig)
    optim: OptimConfig = dataclasses.field(default_factory=OptimConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    eval: EvalConfig = dataclasses.field(default_factory=EvalConfig)
    checkpoint: CheckpointConfig = dataclasses.field(default_factory=CheckpointConfig)
    #: Images flagged ``is_strong`` in a batch train on their true masks
    #: (void pixels masked out) instead of the E-step's labels.
    semi_supervised: bool = False

    def replace(self, **kw) -> "ExperimentConfig":
        return dataclasses.replace(self, **kw)


def check_supported(cfg: ExperimentConfig, mode: str = "train") -> None:
    """Raise for a config value this port does not run in ``mode``
    ("train" or "eval")."""
    if mode not in ("train", "eval"):
        raise ValueError(f"mode={mode!r}: expected 'train' or 'eval'")
    train = mode == "train"
    unsupported = [
        (train and cfg.estep.impl == "native", "estep.impl='native'",
         "Queue 1 item 4 (the native E-step binding)"),
        (train and cfg.estep.method == "fixed", "estep.method='fixed'",
         "Queue 1 item 3 (EM-Fixed)"),
        (train and cfg.train.eval_protocol == "voc", "train.eval_protocol='voc'",
         "Queue 1 item 7 (the VOC protocol and the CRF)"),
        (not train and cfg.eval.use_crf, "eval.use_crf=True",
         "Queue 1 item 7 (the VOC protocol and the CRF)"),
    ]
    for bad, what, item in unsupported:
        if bad:
            raise NotImplementedError(
                f"{what} is not ported yet: ROADMAP.md {item} brings it"
            )
    if cfg.model.compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(
            f"model.compute_dtype={cfg.model.compute_dtype!r}: expected 'float32' or 'bfloat16'"
        )
    if cfg.model.block1_impl not in ("auto", "xla", "pallas"):
        raise ValueError(
            f"model.block1_impl={cfg.model.block1_impl!r}: expected 'auto', 'xla' or 'pallas'"
        )
    if not train:
        return
    if cfg.estep.method != "adaptive":
        raise ValueError(f"estep.method={cfg.estep.method!r}: expected 'adaptive'")
    if cfg.estep.impl not in ("auto", "jax", "pallas"):
        raise ValueError(
            f"estep.impl={cfg.estep.impl!r}: expected 'auto', 'jax' or 'pallas'"
        )
    if cfg.train.eval_protocol != "fixed":
        raise ValueError(
            f"train.eval_protocol={cfg.train.eval_protocol!r}: expected 'fixed' or 'voc'"
        )


def _coerce_override(raw: str, tp, key: str):
    """Parse one CLI override value and validate it against the field type
    (``true``/``false``/``none`` spellings accepted; a string that cannot
    be read as the field's type is an error)."""
    import ast
    import types as _types
    import typing

    try:
        value = ast.literal_eval(raw)
    except (ValueError, SyntaxError):
        value = raw

    if tp is None:
        return value
    options = (
        typing.get_args(tp)
        if typing.get_origin(tp) in (typing.Union, _types.UnionType)
        else (tp,)
    )
    concrete = tuple(
        c
        for c in (typing.get_origin(o) or o for o in options)
        if isinstance(c, type)
    )
    if isinstance(value, str):
        low = value.strip().lower()
        if bool in concrete and low in ("true", "false"):
            return low == "true"
        if type(None) in concrete and low in ("none", "null"):
            return None
        if str in concrete:
            return value
        raise ValueError(f"override {key}={raw!r}: cannot interpret {raw!r} as {tp}")
    if isinstance(value, int) and not isinstance(value, bool):
        if float in concrete and int not in concrete:
            return float(value)
    if concrete and not isinstance(value, concrete):
        raise ValueError(
            f"override {key}={raw!r}: parsed {value!r} "
            f"({type(value).__name__}) does not match field type {tp}"
        )
    return value


def apply_overrides(cfg: ExperimentConfig, overrides: Sequence[str]) -> ExperimentConfig:
    """Apply CLI 'dotted.key=value' overrides to a config tree.

    ``model.input_size`` and ``data.input_size`` are one quantity:
    overriding either syncs the other; overriding both differently raises.
    """
    import typing

    keys = set()
    for item in overrides:
        key, sep, raw = item.partition("=")
        if not sep:
            raise ValueError(f"override {item!r} must look like key=value")
        keys.add(key)
        parts = key.split(".")
        node = cfg
        for p in parts[:-1]:
            node = getattr(node, p)
        try:
            tp = typing.get_type_hints(type(node)).get(parts[-1])
        except Exception:
            tp = None
        cfg = _replace_path(cfg, parts, _coerce_override(raw, tp, key))
    if cfg.model.input_size != cfg.data.input_size:
        m_set = "model.input_size" in keys
        d_set = "data.input_size" in keys
        if m_set and d_set:
            raise ValueError(
                f"model.input_size={cfg.model.input_size} and "
                f"data.input_size={cfg.data.input_size} disagree — they "
                "are the same quantity; set just one"
            )
        if m_set:
            cfg = cfg.replace(data=dataclasses.replace(cfg.data, input_size=cfg.model.input_size))
        elif d_set:
            cfg = cfg.replace(model=dataclasses.replace(cfg.model, input_size=cfg.data.input_size))
    return cfg


def _replace_path(node, parts, value):
    if len(parts) == 1:
        return dataclasses.replace(node, **{parts[0]: value})
    child = getattr(node, parts[0])
    return dataclasses.replace(node, **{parts[0]: _replace_path(child, parts[1:], value)})
