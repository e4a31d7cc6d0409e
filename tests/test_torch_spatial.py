"""PyTorch port: the layers of the mesh's space and model axes
(``em_adapt_torch/parallel/spatial.py``, ``parallel/tensor.py``) against
the whole-tensor ops, in worlds of gloo processes on the CPU
(``tests/torch_world.py``).

Space: every strip layer (3x3 convs at rate 1 and 2, fc6's 4x4 at rate
4, a 1x1 conv, max pools of stride 2 and 1) forward and backward equals
the op on the whole tensor, over 3 ranks, including a halo that comes
from two ranks away (fc6's 6 rows over strips of 2, 2 and 1). Model: the
DeepLab forward with fc6 column-parallel and fc7 row-parallel over 2
ranks equals one process's, forward and every gradient. Dropout: the
masks each rank draws are its slices of one process's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from em_adapt_torch.config import MeshConfig, ModelConfig  # noqa: E402
from em_adapt_torch.ops.conv import conv2d_same  # noqa: E402
from em_adapt_torch.ops.pooling import max_pool_same  # noqa: E402
from em_adapt_torch.parallel.spatial import check_image_rows, row_split  # noqa: E402
from tests.torch_world import run_world  # noqa: E402

MODULE = "tests.test_torch_spatial"

#: name -> (kind, rows of the input, kernel, rate or stride, dtype)
LAYERS = {
    "conv3_rate1": ("conv", 33, 3, 1, "float32"),
    "conv3_rate2": ("conv", 9, 3, 2, "float32"),
    "fc6_4x4_rate4_two_away": ("conv", 5, 4, 4, "float32"),
    "conv1x1": ("conv", 7, 1, 1, "float32"),
    "conv3_rate1_bf16": ("conv", 9, 3, 1, "bfloat16"),
    "pool_stride2": ("pool", 33, 3, 2, "float32"),
    "pool_stride2_uneven": ("pool", 9, 3, 2, "float32"),
    "pool_stride1": ("pool", 5, 3, 1, "float32"),
}


def _layer_case(name: str, seed: int) -> dict:
    kind, h, k, r, dtype = LAYERS[name]
    g = np.random.default_rng(seed)
    b, c, w = 2, 3, 6
    s = 1 if kind == "conv" else r
    case = {"x": g.normal(size=(b, c, h, w)).astype(np.float32),
            "dy": g.normal(size=(b, 4 if kind == "conv" else c, -(-h // s), -(-w // s)))
            .astype(np.float32)}
    if kind == "conv":
        case["w"] = g.normal(size=(4, c, k, k)).astype(np.float32) * 0.3
        case["b"] = g.normal(size=4).astype(np.float32)
    return case


def _whole_layer(name: str, case: dict, strip_fn=None):
    """(y, dx, dw, db) of the layer on tensors ``case``; ``strip_fn(x, w, b)``
    replaces the whole op (a rank's strip)."""
    kind, _, _, r, dtype = LAYERS[name]
    x = torch.from_numpy(case["x"]).requires_grad_(True)
    w = b = None
    if kind == "conv":
        w = torch.from_numpy(case["w"]).requires_grad_(True)
        b = torch.from_numpy(case["b"]).requires_grad_(True)
    cdt = torch.bfloat16 if dtype == "bfloat16" else None
    if strip_fn is not None:
        y = strip_fn(x, w, b, cdt)
    elif kind == "conv":
        y = conv2d_same(x, w, b, rate=r, compute_dtype=cdt)
    else:
        y = max_pool_same(x, 3, r)
    return y, x, w, b


def _grads(y, dy, x, w, b):
    (y * dy).sum().backward()
    out = [y.detach().numpy(), x.grad.numpy()]
    if w is not None:
        out += [w.grad.numpy(), b.grad.numpy()]
    return out


def _space_world(world, p):
    """Each layer on this rank's rows; the gathered rows with and without
    gradient; the dropout masks this rank draws."""
    from em_adapt_torch.models.deeplab import dropout
    from em_adapt_torch.parallel.mesh import make_plan
    from em_adapt_torch.parallel.spatial import conv_rows, gather_rows, my_rows, pool_rows

    plan = make_plan(MeshConfig(axes=(("data", 1), ("space", 3))), world)
    out = {}
    for name, case in p["layers"].items():
        kind, h, _, r, _ = LAYERS[name]
        mine = {k: my_rows(torch.from_numpy(v), plan, 2) if k in ("x", "dy") else v
                for k, v in case.items()}

        def strip(x, w, b, cdt, kind=kind, h=h, r=r):
            if kind == "conv":
                return conv_rows(x, w, b, rate=r, compute_dtype=cdt, plan=plan, h=h)
            return pool_rows(x, 3, r, plan=plan, h=h)[0]

        y, x, w, b = _whole_layer(name, {**case, "x": mine["x"].numpy()}, strip)
        out[name] = _grads(y, mine["dy"], x, w, b)
    x = my_rows(torch.from_numpy(p["gather"]), plan, 2).clone().requires_grad_(True)
    whole = gather_rows(x, plan, p["gather"].shape[2])
    (whole * torch.from_numpy(p["gather_w"])).sum().backward()
    out["gather"] = (whole.detach().numpy(), x.grad.numpy())
    g = torch.Generator().manual_seed(4)
    rows = (*row_split(9, 3)[plan.space_index], 9)
    out["mask"] = dropout(torch.ones(2, 5, rows[1] - rows[0], 7), 0.5, generator=g, shard=(1, 2),
                          rows=rows).numpy()
    return out


@pytest.fixture(scope="module")
def space_world(tmp_path_factory):
    layers = {name: _layer_case(name, i) for i, name in enumerate(LAYERS)}
    g = np.random.default_rng(99)
    payload = {"layers": layers, "gather": g.normal(size=(2, 3, 5, 4)).astype(np.float32),
               "gather_w": g.normal(size=(2, 3, 5, 4)).astype(np.float32)}
    ranks = run_world(MODULE, "_space_world", 3, payload, tmp_path_factory.mktemp("space"))
    return payload, ranks


@pytest.mark.parametrize("name", list(LAYERS))
def test_strip_layer_equals_whole_op(space_world, name):
    """Over 3 space ranks, the rows of each rank's output and input
    gradient joined equal the whole op's, and the weight and bias
    gradients summed over the ranks equal the whole op's (float32 to
    1e-5 of the scale; bf16 convs to bf16's resolution)."""
    payload, ranks = space_world
    case = payload["layers"][name]
    y, x, w, b = _whole_layer(name, case)
    want = _grads(y, torch.from_numpy(case["dy"]), x, w, b)
    got = [np.concatenate([r[name][0] for r in ranks], 2),
           np.concatenate([r[name][1] for r in ranks], 2)]
    if len(want) == 4:
        got += [sum(r[name][2] for r in ranks), sum(r[name][3] for r in ranks)]
    tol = 1e-2 if LAYERS[name][4] == "bfloat16" else 1e-5
    for what, g_, w_ in zip(("y", "dx", "dw", "db"), got, want):
        assert g_.shape == w_.shape, what
        np.testing.assert_allclose(g_, w_, rtol=tol, atol=tol * np.abs(w_).max(),
                                   err_msg=f"{name} {what}")


def test_halo_from_two_ranks_away_and_moving_boundaries():
    """The rows each rank owns follow ⌈h/n⌉ at each activation's own
    height: fc6 at a 33-row input over 3 reads 6 rows above and below
    strips of 2, 2 and 1, so the last rank's halo reaches rank 0's rows;
    a stride-2 pool moves the boundaries; 41 rows over 3 are 14, 14, 13."""
    assert row_split(5, 3) == [(0, 2), (2, 4), (4, 5)]
    assert row_split(41, 3) == [(0, 14), (14, 28), (28, 41)]
    assert row_split(161, 3) == [(0, 54), (54, 108), (108, 161)]
    assert [hi - lo for lo, hi in row_split(65, 3)] == [22, 22, 21]
    lo, hi = row_split(5, 3)[2]
    assert lo - 6 < row_split(5, 3)[1][0]  # fc6's 6-row halo passes rank 1's strip
    with pytest.raises(ValueError, match="leave rank 2 no rows"):
        row_split(4, 3)
    with pytest.raises(ValueError, match="image height 32 is not divisible by the space axis"):
        check_image_rows(32, 3)
    check_image_rows(33, 3)
    check_image_rows(32, 1)


def test_gather_rows_forward_and_its_gradient_is_the_own_rows(space_world):
    """``gather_rows`` joins the 2, 2 and 1 rows into the whole tensor on
    every rank; the gradient of a function of the whole tensor comes back
    to each rank as its own rows' (not a sum over the group)."""
    payload, ranks = space_world
    for r, (lo, hi) in zip(ranks, row_split(5, 3)):
        np.testing.assert_array_equal(r["gather"][0], payload["gather"])
        np.testing.assert_array_equal(r["gather"][1], payload["gather_w"][:, :, lo:hi])


def test_space_ranks_draw_their_rows_of_the_one_process_mask(space_world):
    """Each space rank's dropout mask (data index 1 of 2) is its rows of
    the mask one process draws for the whole world batch."""
    from em_adapt_torch.models.deeplab import dropout

    _, ranks = space_world
    g = torch.Generator().manual_seed(4)
    whole = torch.rand((4, 5, 9, 7), generator=g)[2:4] < 0.5
    want = torch.where(whole, torch.full((2, 5, 9, 7), 2.0), torch.zeros(2, 5, 9, 7)).numpy()
    np.testing.assert_array_equal(np.concatenate([r["mask"] for r in ranks], 2), want)
    assert 0.3 < (want > 0).mean() < 0.7


# --- the model axis ------------------------------------------------------

SMALL = dict(num_classes=4, input_size=(17, 17), fc6_channels=8, width_multiplier=0.125,
             init_scheme="he")


def _model_pass(model, x, masks, dtype):
    """(logits, {leaf: grad}) of one forward and backward of ``model``."""
    model.zero_grad()
    y = model(torch.from_numpy(x), train=True, masks=masks)
    (y * torch.linspace(-1, 1, y.numel()).reshape(y.shape)).sum().backward()
    return y.detach().numpy(), {k: p.grad.clone() for k, p in model.named_parameters()}


def _model_world(world, p):
    """The DeepLab forward and backward under model = 2 (f32 and bf16), with
    relu6's mask sliced to this rank's fc6 channels; the gathered
    gradients; the masks this rank draws."""
    from em_adapt_torch.models.deeplab import DeepLabLargeFOV, dropout
    from em_adapt_torch.parallel.mesh import make_plan
    from em_adapt_torch.parallel.tensor import gather_params

    plan = make_plan(MeshConfig(axes=(("data", 1), ("space", 1), ("model", 2))), world)
    lo, hi = plan.model_index * 4, plan.model_index * 4 + 4
    out = {}
    for dtype in ("float32", "bfloat16"):
        cfg = ModelConfig(**SMALL, compute_dtype=dtype)
        model = DeepLabLargeFOV(cfg, plan=plan).load_params(p["params"])
        masks = (torch.from_numpy(p["masks"][0][:, lo:hi]), torch.from_numpy(p["masks"][1]))
        y, grads = _model_pass(model, p["x"], masks, dtype)
        out[dtype] = (y, {k: v.numpy() for k, v in gather_params(grads, plan).items()},
                      float(model.weight_l2().detach()))
    g = torch.Generator().manual_seed(5)
    out["mask"] = dropout(torch.ones(2, 4, 3, 3), 0.5, generator=g, shard=(0, 1),
                          channels=(lo, hi, 8)).numpy()
    import torch.distributed as dist

    from em_adapt_torch.config import ExperimentConfig, TrainConfig
    from em_adapt_torch.train.trainer import Trainer, to_device, train_step

    cfg = ExperimentConfig(model=ModelConfig(**SMALL), train=TrainConfig(batch_size=2),
                           mesh=MeshConfig(axes=(("data", 1), ("space", 1), ("model", 2))))
    state = Trainer(cfg, world=world).init_state()
    label = np.zeros((2, 17, 17, 1), np.float32)
    train_step(state, to_device({"image": p["x"], "label": label}, torch.device("cpu")), cfg)
    out["ddp"] = (dist.get_world_size(state.ddp.process_group),
                  state.model.layers["fc6"].weight.detach().numpy())
    return out


@pytest.fixture(scope="module")
def model_world(tmp_path_factory):
    from em_adapt_torch.models.deeplab import init_params

    cfg = ModelConfig(**SMALL)
    params = {k: {n: t.numpy() for n, t in v.items()}
              for k, v in init_params(torch.Generator().manual_seed(3), cfg).items()}
    g = np.random.default_rng(7)
    payload = {"params": params, "x": (g.normal(size=(2, 17, 17, 3)) * 40).astype(np.float32),
               "masks": tuple(g.uniform(size=(2, 8, 3, 3)) < 0.5 for _ in range(2))}
    ranks = run_world(MODULE, "_model_world", 2, payload, tmp_path_factory.mktemp("model"))
    return payload, ranks


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fc6_fc7_tensor_parallel_equals_whole_pair(model_world, dtype):
    """model = 2: fc6 column-parallel and fc7 row-parallel (``f`` on fc6's
    input, ``g`` on fc7's partial sums before its bias) give one process's
    logits, weight L2 and every gradient, gathered (float32 within 1e-5 of
    the scale; bf16, whose fc7 partial sums are rounded before the sum,
    within 2e-2); both ranks hold the same logits."""
    from em_adapt_torch.models.deeplab import DeepLabLargeFOV

    payload, ranks = model_world
    cfg = ModelConfig(**SMALL, compute_dtype=dtype)
    model = DeepLabLargeFOV(cfg).load_params(payload["params"])
    masks = tuple(torch.from_numpy(m) for m in payload["masks"])
    y, grads = _model_pass(model, payload["x"], masks, dtype)
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    (y0, g0, l2_0), (y1, _, l2_1) = ranks[0][dtype], ranks[1][dtype]
    np.testing.assert_array_equal(y0, y1)
    np.testing.assert_allclose(y0, y, rtol=tol, atol=tol * np.abs(y).max())
    assert l2_0 == l2_1 == pytest.approx(float(model.weight_l2().detach()), rel=1e-6)
    for k, want in grads.items():
        want = want.numpy()
        assert g0[k].shape == want.shape, k
        np.testing.assert_allclose(g0[k], want, rtol=tol, atol=tol * np.abs(want).max(),
                                   err_msg=k)


def test_model_only_world_wraps_ddp_over_one_rank(model_world):
    """A world of (data 1, space 1, model 2) wraps each rank's model in DDP
    over its data x space group, this rank alone, so DDP's broadcast at
    construction leaves each rank's fc6 shard its own: after a step (in an
    accumulation window) each rank holds its half of the seed's fc6, not
    rank 0's copied."""
    from em_adapt_torch.models.deeplab import init_params

    _, ranks = model_world
    assert [r["ddp"][0] for r in ranks] == [1, 1]
    whole = init_params(torch.Generator().manual_seed(0), ModelConfig(**SMALL))["fc6"]["w"]
    for m, r in enumerate(ranks):
        want = whole[..., 4 * m:4 * m + 4].permute(3, 2, 0, 1).numpy()
        np.testing.assert_array_equal(r["ddp"][1], want)


def test_model_ranks_draw_their_channels_of_the_one_process_mask(model_world):
    """Each model rank's relu6 mask is its fc6 channels of one process's."""
    from em_adapt_torch.models.deeplab import dropout

    _, ranks = model_world
    g = torch.Generator().manual_seed(5)
    want = dropout(torch.ones(2, 8, 3, 3), 0.5, generator=g).numpy()
    np.testing.assert_array_equal(np.concatenate([r["mask"] for r in ranks], 1), want)


def test_tp_rules_match_jax_and_shard_gather_round_trip():
    """``TP_RULES`` is the JAX package's; ``shard_params`` slices fc6's
    output channels and bias and fc7's input channels as JAX's
    ``MeshPlan.param_sharding`` names them, in both layouts, and the
    slices put together are the whole tree."""
    from em_adapt_torch.models.convert import from_jax_params
    from em_adapt_torch.models.deeplab import init_params
    from em_adapt_torch.parallel.mesh import TP_RULES
    from em_adapt_torch.parallel.tensor import shard_dims, shard_params
    from em_adapt_tpu.parallel.mesh import TP_RULES as JAX_RULES

    assert TP_RULES == JAX_RULES
    params = init_params(torch.Generator().manual_seed(0), ModelConfig(**SMALL))
    parts = [shard_params(params, i, 2) for i in range(2)]
    assert parts[0]["fc6"]["w"].shape == (4, 4, 64, 4) and parts[0]["fc6"]["b"].shape == (4,)
    assert parts[0]["fc7"]["w"].shape == (1, 1, 4, 8) and parts[0]["fc7"]["b"].shape == (8,)
    for (layer, leaf), dim in TP_RULES.items():
        torch.testing.assert_close(torch.cat([p[layer][leaf] for p in parts], dim),
                                   params[layer][leaf], rtol=0, atol=0)
    state = from_jax_params(params)
    dims = shard_dims(state)
    assert dims == {"layers.fc6.weight": 0, "layers.fc6.bias": 0, "layers.fc7.weight": 1}
    sparts = [shard_params(state, i, 2) for i in range(2)]
    for key, dim in dims.items():
        torch.testing.assert_close(torch.cat([p[key] for p in sparts], dim), state[key],
                                   rtol=0, atol=0)
    np_parts = shard_params({k: {n: t.numpy() for n, t in v.items()} for k, v in params.items()},
                            1, 2)
    np.testing.assert_array_equal(np_parts["fc6"]["w"], parts[1]["fc6"]["w"].numpy())
    with pytest.raises(ValueError, match="does not divide"):
        shard_params(params, 0, 3)
