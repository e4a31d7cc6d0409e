"""Tensor parallelism of fc6 and fc7 over the mesh's ``model`` axis.

The counterpart of ``em_adapt_tpu/parallel/mesh.py::TP_RULES`` and of the
collectives that XLA's partitioner inserts for it. fc6 is column-parallel:
each of the n model ranks holds ``cout/n`` of its output channels and
their biases. fc7 is row-parallel: each holds ``cin/n`` of its input
channels, which are fc6's channels on that rank, and the whole bias. The
trunk before fc6, fc7's bias and fc8 are whole on every rank. Megatron's
two links (Shoeybi et al., arXiv:1909.08053 §3) join the halves:

* :func:`copy_to_model` (``f``) on fc6's input: the identity forward, an
  all-reduce of the gradient over the model group backward, since every
  rank's fc6 shard takes its part of the input's gradient;
* :func:`reduce_from_model` (``g``) on fc7's partial output, before the
  bias: an all-reduce over the model group forward, the identity
  backward.

The sums run in float32 (a bf16 partial is widened, summed and rounded
back), so a bf16 world rounds fc7's partial sums where one process rounds
their total. :func:`shard_params` and :func:`gather_params` slice a whole
parameter tree by ``TP_RULES`` and put the slices back together; a
checkpoint holds the whole tree (``train/checkpoint.py``), so any layout
restores it.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from em_adapt_torch.parallel.mesh import TP_RULES, MeshPlan

#: TP_RULES' HWIO dimension -> the port's OIHW one.
_OIHW = {3: 0, 2: 1, 0: 2, 1: 3}


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    y = x.to(torch.float32, copy=True)
    with torch.profiler.record_function("model_allreduce"):
        dist.all_reduce(y, group=group)
    return y.to(x.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, plan: MeshPlan) -> torch.Tensor:
    """``f``: ``x`` forward; its gradient summed over the model group."""
    return x if plan.num_model_shards == 1 else _CopyToModel.apply(x, plan.model_group)


def reduce_from_model(x: torch.Tensor, plan: MeshPlan) -> torch.Tensor:
    """``g``: ``x`` summed over the model group forward; the gradient as it is."""
    return x if plan.num_model_shards == 1 else _ReduceFromModel.apply(x, plan.model_group)


def shard_dims(params: dict) -> dict:
    """{key: dimension} of the leaves of ``params`` that ``TP_RULES`` shards:
    ``(layer, "w"|"b")`` for a ``{layer: {"w", "b"}}`` tree in the JAX
    package's HWIO layout, ``"layers.<layer>.weight"|".bias"`` for a state
    dict of :class:`~em_adapt_torch.models.deeplab.DeepLabLargeFOV` (OIHW)."""
    out = {}
    for (layer, leaf), dim in TP_RULES.items():
        if isinstance(params.get(layer), dict):
            out[(layer, leaf)] = dim
        else:
            key = f"layers.{layer}.{'weight' if leaf == 'w' else 'bias'}"
            if key in params:
                out[key] = _OIHW[dim] if leaf == "w" else dim
    return out


def _get(params: dict, key):
    return params[key[0]][key[1]] if isinstance(key, tuple) else params[key]


def _with(params: dict, values: dict) -> dict:
    """A copy of ``params`` with the leaves of ``values`` replaced."""
    out = {k: dict(v) if isinstance(v, dict) else v for k, v in params.items()}
    for key, v in values.items():
        if isinstance(key, tuple):
            out[key[0]][key[1]] = v
        else:
            out[key] = v
    return out


def _slice(t, dim: int, index: int, n: int):
    size = t.shape[dim] // n
    if size * n != t.shape[dim]:
        raise ValueError(f"a dimension of {t.shape[dim]} does not divide over {n} model ranks")
    if isinstance(t, torch.Tensor):
        return t.narrow(dim, index * size, size).clone()
    return np.take(t, np.arange(index * size, (index + 1) * size), axis=dim)


def shard_params(params: dict, index: int, n: int) -> dict:
    """Model rank ``index`` of ``n``'s slices of a whole ``params`` (either
    layout of :func:`shard_dims`; tensors or numpy arrays); the other
    leaves as they are."""
    if n == 1:
        return params
    return _with(params, {k: _slice(_get(params, k), d, index, n)
                          for k, d in shard_dims(params).items()})


def _gather(t: torch.Tensor, dim: int, plan: MeshPlan) -> torch.Tensor:
    parts = [torch.empty_like(t) for _ in range(plan.num_model_shards)]
    dist.all_gather(parts, t.contiguous(), group=plan.model_group)
    return torch.cat(parts, dim)


def gather_params(params: dict, plan: MeshPlan) -> dict:
    """The whole tree from every model rank's ``params`` (tensors): an
    all-gather over the model group, which every rank of it enters."""
    if plan.num_model_shards == 1:
        return params
    return _with(params, {k: _gather(_get(params, k), d, plan)
                          for k, d in shard_dims(params).items()})


def _state_leaves(sd: dict) -> dict[int, int]:
    """{index in the optimizer's lists: dimension} of a TrainState dict's
    sharded leaves (the lists follow the parameters' order)."""
    dims = shard_dims(sd["params"])
    return {i: dims[k] for i, k in enumerate(sd["params"]) if k in dims}


def _map_state(sd: dict, fn) -> dict:
    """``sd`` (``TrainState.state_dict``) with ``fn(tensor, dim)`` applied
    to every sharded parameter and its momentum and accumulator slots."""
    leaves = _state_leaves(sd)
    opt = dict(sd["optimizer"])
    for slot in ("momentum", "acc"):
        if opt.get(slot) is not None:
            opt[slot] = [fn(t, leaves[i]) if i in leaves and t is not None else t
                         for i, t in enumerate(opt[slot])]
    dims = shard_dims(sd["params"])
    params = {k: fn(t, dims[k]) if k in dims else t for k, t in sd["params"].items()}
    return {**sd, "params": params, "optimizer": opt}


def shard_state(sd: dict, plan: MeshPlan) -> dict:
    """This model rank's part of a whole ``TrainState.state_dict``: the
    sharded parameters and their optimizer slots sliced."""
    if plan.num_model_shards == 1:
        return sd
    return _map_state(sd, lambda t, d: _slice(t, d, plan.model_index, plan.num_model_shards))


def gather_state(sd: dict, plan: MeshPlan) -> dict:
    """The whole ``TrainState.state_dict`` from every model rank's part
    (a collective over the model group)."""
    if plan.num_model_shards == 1:
        return sd
    return _map_state(sd, lambda t, d: _gather(t, d, plan))
