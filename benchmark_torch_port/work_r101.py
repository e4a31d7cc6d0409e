"""Operations and bytes of DeepLab-v2 ResNet-101 from shapes, independent
of the program: ``work.py``'s yardstick for this network.

The layer table is the plain reference's (``reference/deeplab_v2.py``).
FLOP count dense taps (an atrous conv's padding taps included, as
``work.py`` counts VGG's), and no recompute. The bytes of the frozen-BN,
ReLU and residual-add path are the least any implementation must move
(bf16, 2 bytes an element): forward, each trunk conv's output read once,
each activation (the stem's, each bottleneck's branch2a and branch2b, its
output) written once, and at each identity add the shortcut read once;
backward, each activation's gradient and the activation itself (the
ReLU's mask) read once, each conv output's gradient written once, and at
each add the shortcut's gradient read once.
"""

from __future__ import annotations

import work
from reference import deeplab_v2 as ref

#: bf16
ELEMENT_BYTES = 2


def _up(n: int, s: int) -> int:
    return -(-n // s)


def layer_resolutions(h: int, w: int, num_classes: int = 21, width: float = 1.0, **_):
    """(name, k, cin, cout, output h, output w) of each conv at an h x w
    input: conv1 at ceil(H/2), the pool to ceil(H/4), res3a's strided 1x1s
    to ceil(H/8)."""
    out, block_in = [], None
    for name, k, cin, cout, stride, _, _ in ref.layers(num_classes, width):
        if name == "conv1":
            oh, ow = _up(h, stride), _up(w, stride)
            block_in = (_up(oh, 2), _up(ow, 2))
        elif name.endswith(("_branch1", "_branch2a")):
            oh, ow = _up(block_in[0], stride), _up(block_in[1], stride)
        elif name.endswith("_branch2c"):
            block_in = (oh, ow)
        else:  # branch2b at the block's output size; ASPP at res5's
            oh, ow = (oh, ow) if name.endswith("_branch2b") else block_in
        out.append((name, k, cin, cout, oh, ow))
    return out


def forward_flops(h: int, w: int, batch: int, **widths) -> int:
    """Multiply-adds (x2) of the network's forward pass."""
    return sum(2 * k * k * cin * cout * oh * ow * batch
               for _, k, cin, cout, oh, ow in layer_resolutions(h, w, **widths))


def train_flops(h: int, w: int, batch: int, **widths) -> int:
    """Multiply-adds (x2) of one training step's convolutions: the forward,
    the input gradient (none for conv1, whose input needs none) and the
    weight gradient. No recompute."""
    return sum(2 * k * k * cin * cout * oh * ow * batch * (2 if name == "conv1" else 3)
               for name, k, cin, cout, oh, ow in layer_resolutions(h, w, **widths))


def norm_elements(h: int, w: int, batch: int, **widths) -> dict:
    """Elements of the frozen-BN/ReLU/add path an h x w step of ``batch``:
    ``conv`` (every trunk conv's output), ``act`` (the activations
    written: the stem's, and each bottleneck's branch2a, branch2b and
    output), ``identity`` (the identity shortcuts read at their adds) and
    ``adds`` (every bottleneck's output, one add each)."""
    n = {"conv": 0, "act": 0, "identity": 0, "adds": 0}
    projected = set()
    for name, _, _, cout, oh, ow in layer_resolutions(h, w, **widths):
        e = cout * oh * ow * batch
        if name.startswith("fc1_voc12"):
            continue
        n["conv"] += e
        if name.endswith("_branch1"):
            projected.add(name[:-len("_branch1")])
        elif name.endswith("_branch2c"):
            n["act"] += e
            n["adds"] += e
            if name[:-len("_branch2c")] not in projected:
                n["identity"] += e
        else:  # conv1, branch2a, branch2b: BN then ReLU
            n["act"] += e
    return n


def norm_bytes(h: int, w: int, batch: int, **widths) -> int:
    """The least bytes the frozen-BN/ReLU/add path moves in a training
    step (forward and backward; the module's docstring)."""
    n = norm_elements(h, w, batch, **widths)
    forward = n["conv"] + n["act"] + n["identity"]
    backward = 2 * n["act"] + n["conv"] + n["adds"]
    return ELEMENT_BYTES * (forward + backward)


def norm(h: int, w: int, batch: int, **widths) -> dict:
    nbytes = norm_bytes(h, w, batch, **widths)
    return {"flops": 0, "bytes": nbytes, "bound_s": nbytes / work.HBM_BYTES_PER_S}
