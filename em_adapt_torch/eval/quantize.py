"""int8 post-training quantization for the serving path.

The counterpart of ``em_adapt_tpu/eval/quantize.py``, with its names and
its scheme (standard symmetric PTQ):

* weights: per-output-channel symmetric int8, ``s_w = max|w[..., c]| /
  127`` (zero-point 0, so SAME zero padding stays exact);
* activations: per-tensor symmetric int8, ``s_x`` = the max |input| each
  conv saw over a calibration set / 127 (max-abs calibration);
* accumulation: int32, then one dequantization, ``y = y_i32 * (s_x *
  s_w[c]) + b``, in float32.

The s8 x s8 -> s32 convolution is :func:`conv_s8`: an im2col of the
zero-padded int8 input and ``torch._int_mm``, on the CPU and on the card
alike. The JAX package's is plain XLA (``lax.conv_general_dilated`` with
an int32 result), no Pallas kernel, so the port has no kernel here either.

:class:`QuantizedDeepLabLargeFOV` is an ``nn.Module`` whose buffers hold
the quantized parameters: ``.to(device)`` moves them, ``predict``
returns (upsampled logits, labels) as the float model's does, so it
drops into ``eval/predict.py::Evaluator`` and ``eval/export.py``
unchanged. Training is not quantized: this is a serving-only trade of
accuracy for latency, and :func:`quantization_agreement` measures its
label-flip rate.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from em_adapt_torch.config import ModelConfig
from em_adapt_torch.data.augment import normalize_uint8
from em_adapt_torch.device import set_precision
from em_adapt_torch.models.deeplab import POOLS, layer_specs, require_vgg
from em_adapt_torch.ops.conv import conv2d_same, same_padding
from em_adapt_torch.ops.pooling import max_pool_same
from em_adapt_torch.ops.resize import resize_bilinear_tf


def _float_layers(model_or_params) -> dict[str, tuple[torch.Tensor, torch.Tensor]]:
    """{layer: (OIHW weight, bias)} float32 of a ``DeepLabLargeFOV`` or of a
    ``{layer: {"w": HWIO, "b"}}`` tree (numpy or tensors, on the CPU)."""
    if isinstance(model_or_params, nn.Module):
        return {name: (layer.weight.detach().float(), layer.bias.detach().float())
                for name, layer in model_or_params.layers.items()}

    def tensor(a) -> torch.Tensor:
        return a.float() if torch.is_tensor(a) else torch.from_numpy(np.array(a, np.float32))

    return {name: (tensor(p["w"]).permute(3, 2, 0, 1), tensor(p["b"]))
            for name, p in model_or_params.items()}


@torch.no_grad()
def observe_activation_ranges(cfg: ModelConfig, model_or_params, batches) -> dict[str, float]:
    """The calibration pass: the max |input| of every conv layer over
    ``batches`` (each [B,H,W,3], preprocessed float or raw uint8, which is
    normalized first as the model normalizes it), in float32 with ReLU
    after every layer but fc8 and the pools at ``POOLS``. Returns
    {layer: amax}; a range <= 0 becomes 1.0 (an all-zero input: any scale
    works). One copy to the host a batch."""
    require_vgg(cfg, "int8 PTQ (eval --int8)")
    set_precision()
    layers = _float_layers(model_or_params)
    device = next(iter(layers.values()))[0].device
    out: dict[str, float] = {}
    for batch in batches:
        h = normalize_uint8(torch.as_tensor(batch).to(device)).float().permute(0, 3, 1, 2)
        amax = []
        for name, _, _, _, _, rate in layer_specs(cfg):
            amax.append(h.abs().amax())
            w, b = layers[name]
            h = conv2d_same(h, w, b, rate=rate)
            if name != "fc8":
                h = F.relu(h)
            if name in POOLS:
                h = max_pool_same(h, 3, POOLS[name])
        for (name, *_), v in zip(layer_specs(cfg), torch.stack(amax).tolist()):
            out[name] = max(out.get(name, 0.0), v)
    return {k: (v if v > 0.0 else 1.0) for k, v in out.items()}


def quantize_params(params, act_ranges: dict[str, float], cfg: ModelConfig) -> dict:
    """Float parameters (a ``DeepLabLargeFOV`` or a ``{layer: {"w": HWIO,
    "b"}}`` tree) -> the quantized tree, per layer: ``w8`` int8 HWIO
    (round half to even, as ``jnp.round``, then clip to ±127), ``scale`` =
    s_w * s_x per output channel (the one dequantization multiplier),
    ``inv_sx`` = 1 / s_x for the input quantizer, ``b`` float32."""
    require_vgg(cfg, "int8 PTQ (eval --int8)")
    layers = _float_layers(params)
    q = {}
    for name, *_ in layer_specs(cfg):
        w_oihw, b = layers[name]
        w = w_oihw.permute(2, 3, 1, 0)  # HWIO
        s_w = torch.clamp(w.abs().amax(dim=(0, 1, 2)), min=1e-12) / 127.0
        w8 = torch.clamp(torch.round(w / s_w), -127, 127).to(torch.int8)
        s_x = float(act_ranges[name]) / 127.0
        q[name] = {
            "w8": w8.contiguous(),
            "scale": (s_w * s_x).to(torch.float32),
            "inv_sx": torch.tensor(1.0 / s_x, dtype=torch.float32, device=w.device),
            "b": b.clone(),
        }
    return q


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def conv_s8(x8: torch.Tensor, w8: torch.Tensor, rate: int) -> torch.Tensor:
    """s8 x s8 -> s32 stride-1 SAME convolution at atrous ``rate``, exact:
    x8 [B,H,W,Cin] int8, w8 [kh,kw,Cin,Cout] int8 (HWIO) -> [B,H,W,Cout]
    int32 (zero padding is exact: the zero-point is 0).

    The im2col is built from the kh*kw shifted slices of the zero-padded
    input, concatenated along the channels in HWIO's (u, v, c) order
    (``F.unfold`` has no int8 kernel on the CPU), then one
    ``torch._int_mm`` against the weights as a [K, Cout] matrix. The sums
    cannot overflow: at most 127² * K, 1.3e8 at fc6's K = 4*4*512, far
    below 2^31.

    ``torch._int_mm``'s rules on the card (torch 2.11, CUDA 12.8, an H100):
    more than 16 rows, and inner and output sizes that are multiples of 8
    (it raises otherwise); and at 17 rows cuBLASLt refuses a row-major
    second operand (CUBLAS_STATUS_NOT_SUPPORTED) where a column-major one
    runs. So the rows are padded to 17 when there are fewer, K (27 at
    conv1_1) and Cout (21 at fc8) up to multiples of 8 with zeros (exact
    pads all; the CPU gets the same shapes), and the weights go in
    column-major: a [Cout, K] contiguous matrix, transposed."""
    b, h, w, cin = x8.shape
    kh, kw, _, cout = w8.shape
    (top, bottom), (left, right) = same_padding(kh, rate), same_padding(kw, rate)
    k, kp, np_ = kh * kw * cin, _round_up(kh * kw * cin, 8), _round_up(cout, 8)
    xp = F.pad(x8, (0, 0, left, right, top, bottom))
    cols = [xp[:, u * rate:u * rate + h, v * rate:v * rate + w, :]
            for u in range(kh) for v in range(kw)]
    if kp > k:
        cols.append(x8.new_zeros(b, h, w, kp - k))
    a = (torch.cat(cols, dim=-1) if len(cols) > 1 else cols[0]).reshape(b * h * w, kp)
    m = a.shape[0]
    if m <= 16:
        a = torch.cat([a, a.new_zeros(17 - m, kp)])
    wm = w8.new_zeros(np_, kp)
    wm[:cout, :k] = w8.reshape(k, cout).t()
    y = torch._int_mm(a, wm.t())
    return y[:m, :cout].reshape(b, h, w, cout)


class _QLayer(nn.Module):
    def __init__(self, kh: int, kw: int, cin: int, cout: int, rate: int):
        super().__init__()
        self.rate = rate
        self.register_buffer("w8", torch.zeros(kh, kw, cin, cout, dtype=torch.int8))
        self.register_buffer("scale", torch.ones(cout))
        self.register_buffer("inv_sx", torch.ones(()))
        self.register_buffer("b", torch.zeros(cout))


class QuantizedDeepLabLargeFOV(nn.Module):
    """DeepLab-LargeFOV over a quantized parameter tree, held as buffers
    (:meth:`load_qparams`). ``model(x)`` -> f32 logits [B,h,w,C] NHWC;
    :meth:`predict` -> (upsampled logits, argmax labels): the contracts
    ``Evaluator`` and ``export_program`` consume."""

    def __init__(self, cfg: ModelConfig = ModelConfig()):
        super().__init__()
        self.cfg = cfg
        self.layers = nn.ModuleDict(
            {name: _QLayer(kh, kw, cin, cout, rate)
             for name, kh, kw, cin, cout, rate in layer_specs(cfg)})

    def load_qparams(self, qparams: dict) -> "QuantizedDeepLabLargeFOV":
        """Copy :func:`quantize_params`' tree into the buffers."""
        for name, layer in self.layers.items():
            for key in ("w8", "scale", "inv_sx", "b"):
                src = qparams[name][key]
                getattr(layer, key).copy_(src if torch.is_tensor(src) else torch.from_numpy(
                    np.array(src)))
        return self

    def forward(self, x: torch.Tensor, *, train: bool = False) -> torch.Tensor:
        """x [B,H,W,3], preprocessed float or raw uint8. Per layer: the
        input quantized to s8 as clip(round(h * inv_sx), ±127), the s8
        convolution, then ``y * scale + b`` in float32, ReLU after every
        layer but fc8, the pools at ``POOLS``."""
        if train:
            raise ValueError("QuantizedDeepLabLargeFOV is serving-only: training runs the "
                             "f32/bf16 model (ModelConfig.compute_dtype)")
        h = normalize_uint8(x).to(torch.float32)
        for name, layer in self.layers.items():
            x8 = torch.clamp(torch.round(h * layer.inv_sx), -127, 127).to(torch.int8)
            h = conv_s8(x8, layer.w8, layer.rate).to(torch.float32) * layer.scale + layer.b
            if name != "fc8":
                h = F.relu(h)
            if name in POOLS:
                h = max_pool_same(h.permute(0, 3, 1, 2), 3, POOLS[name]).permute(0, 2, 3, 1)
        return h

    def predict(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Bilinear (TF1 grid) upsampled logits at input resolution and
        their argmax."""
        up = resize_bilinear_tf(self(x), (x.shape[1], x.shape[2]))
        return up, up.argmax(3)


def quantize_model(cfg: ModelConfig, model_or_params, calib_batches) -> QuantizedDeepLabLargeFOV:
    """One-call PTQ: calibrate on ``calib_batches``, quantize, and return
    the quantized model on the float model's device (the CPU for a
    parameter tree). The JAX package returns (model, qparams); here the
    module holds its qparams."""
    ranges = observe_activation_ranges(cfg, model_or_params, calib_batches)
    qparams = quantize_params(model_or_params, ranges, cfg)
    device = qparams[next(iter(qparams))]["w8"].device
    return QuantizedDeepLabLargeFOV(cfg).to(device).load_qparams(qparams).eval()


@torch.no_grad()
def quantization_agreement(cfg: ModelConfig, model: nn.Module, qmodel: QuantizedDeepLabLargeFOV,
                           batches) -> dict:
    """The int8-against-float label agreement on ``batches``: {"pixel_agreement":
    fraction, "n_pixels": int}. Each batch is counted on the device, and
    one scalar comes back."""
    was_training = model.training
    model.eval()
    device = next(qmodel.buffers()).device
    agree = total = 0
    try:
        for batch in batches:
            x = torch.as_tensor(batch).to(device)
            agree += int((model.predict(x)[1] == qmodel.predict(x)[1]).sum())
            total += x.shape[0] * x.shape[1] * x.shape[2]
    finally:
        model.train(was_training)
    return {"pixel_agreement": agree / max(total, 1), "n_pixels": total}
