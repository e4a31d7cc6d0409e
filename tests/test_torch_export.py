"""PyTorch port: the exported predict program and the init.npy interchange
(``em_adapt_torch/eval/export.py``) against the JAX package's
(``em_adapt_tpu/eval/export.py``, ``tests/test_export.py``), and K2 as the
registered operator ``em_adapt::block1_fwd`` inside an exported graph. On
the CPU the operator runs K2's plain version."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from em_adapt_torch import config as pcfg  # noqa: E402
from em_adapt_torch.eval.export import (  # noqa: E402
    BLOCK1_OP,
    export_params_npy,
    export_predict_fn,
    export_program,
    load_predict_fn,
)
from em_adapt_torch.models.deeplab import DeepLabLargeFOV, build_model  # noqa: E402
from em_adapt_torch.ops.block1 import block1_fwd_op, block1_plain  # noqa: E402
from em_adapt_tpu import config as jcfg  # noqa: E402
from em_adapt_tpu.eval import export as jexport  # noqa: E402
from em_adapt_tpu.models import DeepLabLargeFOV as JaxDeepLab  # noqa: E402
from tests.test_model import SMALL_CFG, small_params_from_fixture  # noqa: E402

torch.set_num_threads(2)

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
# Widths of tests/fixtures/model_small.npz: VGG x 0.125, fc6 48, 5 classes.
SMALL = dict(num_classes=5, input_size=(65, 65), fc6_channels=48, width_multiplier=0.125)


def _fixture():
    z = np.load(os.path.join(FIX, "model_small.npz"))
    params = small_params_from_fixture(z)
    return z, params, jax.tree.map(np.asarray, params)


def _port(np_params, **model_kw):
    cfg = pcfg.ExperimentConfig(model=pcfg.ModelConfig(**SMALL, **model_kw),
                                eval=pcfg.EvalConfig(batch_size=2))
    return cfg, DeepLabLargeFOV(cfg.model).load_params(np_params)


def test_export_matches_jax_artifact_and_live_predict():
    """The fixture's weights, f32: the port's exported program gives the
    labels of the JAX package's exported artifact and of the port's live
    predict, its probabilities within 1e-4 of the live ones and 2e-4 of
    JAX's. The fixture's logits reach 790, and the two packages' f32 sums
    put them 1.2e-3 apart (JAX's 8.9e-4 from an f64 forward, the port's
    6.1e-4), which moves 14 of the 42,250 probabilities by up to 1.8e-4."""
    z, params, np_params = _fixture()
    jc = jcfg.ExperimentConfig(model=SMALL_CFG, eval=jcfg.EvalConfig(batch_size=2))
    jfn = jexport.load_predict_fn(jexport.export_predict_fn(jc, JaxDeepLab(SMALL_CFG), params))
    jprobs, jpred = (np.asarray(a) for a in jfn(jnp.asarray(z["x"])))

    cfg, model = _port(np_params)
    blob = export_predict_fn(cfg, model)
    assert isinstance(blob, bytes) and len(blob) > 1000
    probs, pred = load_predict_fn(blob)(torch.from_numpy(z["x"]))
    with torch.no_grad():
        live_up, live_pred = model.eval().predict(torch.from_numpy(z["x"]))
    assert probs.shape == jprobs.shape and pred.shape == jpred.shape
    np.testing.assert_array_equal(pred.numpy(), jpred)
    np.testing.assert_array_equal(pred.numpy(), live_pred.numpy())
    np.testing.assert_allclose(probs.numpy(), jprobs, atol=2e-4)
    np.testing.assert_allclose(probs.numpy(), torch.softmax(live_up, -1).numpy(), atol=1e-4)


def test_export_rejects_wrong_shape():
    _, _, np_params = _fixture()
    cfg, model = _port(np_params)
    fn = load_predict_fn(export_predict_fn(cfg, model))
    with pytest.raises(Exception):
        fn(torch.zeros(2, 10, 10, 3))
    with pytest.raises(Exception):
        fn(torch.zeros(3, 65, 65, 3))


def test_export_batch_size_overrides_eval_batch(tmp_path):
    """``batch_size`` fixes the program's batch (the CLI's --batch-size);
    the model's train mode is put back."""
    _, _, np_params = _fixture()
    cfg, model = _port(np_params)
    model.train()
    ep = export_program(cfg, model, batch_size=3)
    assert model.training
    (images,) = [n for n in ep.graph.nodes if n.op == "placeholder" and n.name == "images"]
    assert tuple(images.meta["val"].shape) == (3, 65, 65, 3)


def test_export_params_npy_roundtrips_through_both_loaders(tmp_path):
    """The port's init.npy re-enters through the JAX package's
    load_caffe_init + init_params(init_model=...) and through the port's
    model.init_model_path: every layer in the file bit for bit, and every
    layer but fc8 (re-initialized by contract) in both models."""
    from em_adapt_tpu.models.deeplab import init_params as jax_init_params
    from em_adapt_tpu.models.deeplab import load_caffe_init

    _, _, np_params = _fixture()
    _, model = _port(np_params)
    path = str(tmp_path / "trained_init")  # no suffix: none is appended
    export_params_npy(model, path)
    assert os.path.exists(path) and not os.path.exists(path + ".npy")

    loaded = load_caffe_init(path)
    assert set(loaded) == set(np_params)
    for layer, leaves in np_params.items():
        for k in ("w", "b"):
            assert loaded[layer][k].dtype == np.float32
            np.testing.assert_array_equal(loaded[layer][k], leaves[k])
    jax_cfg = jcfg.ModelConfig(num_classes=5, input_size=(65, 65), fc6_channels=48,
                               width_multiplier=0.125)
    regrafted = jax_init_params(jax.random.key(0), jax_cfg, init_model=loaded)
    port = build_model(pcfg.ModelConfig(**SMALL, init_model_path=path), 0, torch.device("cpu"))
    from em_adapt_torch.models.convert import to_jax_params

    port_params = to_jax_params(port)
    for layer in np_params:
        if layer == "fc8":
            assert not np.array_equal(port_params[layer]["w"], np_params[layer]["w"])
            continue
        for k in ("w", "b"):
            np.testing.assert_array_equal(np.asarray(regrafted[layer][k]), np_params[layer][k])
            np.testing.assert_array_equal(port_params[layer][k], np_params[layer][k])
    # A parameter tree writes the same file as the model.
    export_params_npy(np_params, str(tmp_path / "tree.npy"))
    again = load_caffe_init(str(tmp_path / "tree.npy"))
    for layer in np_params:
        np.testing.assert_array_equal(again[layer]["w"], loaded[layer]["w"])


def test_bf16_export_holds_k2_op_and_equals_live_predict():
    """bf16 with block1_impl="pallas": the exported graph holds
    em_adapt::block1_fwd (K2's plain version runs here), and the loaded
    program equals the live bf16 predict; the f32 graph holds no such
    node."""
    z, _, np_params = _fixture()
    cfg, model = _port(np_params, compute_dtype="bfloat16", block1_impl="pallas")
    ep = export_program(cfg, model)
    targets = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
    assert targets.count(BLOCK1_OP) == 1
    probs, pred = load_predict_fn(export_predict_fn(cfg, model))(torch.from_numpy(z["x"]))
    with torch.no_grad():
        live_up, live_pred = model.eval().predict(torch.from_numpy(z["x"]))
    np.testing.assert_array_equal(pred.numpy(), live_pred.numpy())
    np.testing.assert_array_equal(probs.numpy(), torch.softmax(live_up, -1).numpy())

    f32_cfg, f32_model = _port(np_params)
    f32 = export_program(f32_cfg, f32_model)
    assert BLOCK1_OP not in [str(n.target) for n in f32.graph.nodes]


def test_block1_op_is_k2_plain_on_the_cpu_and_passes_opcheck():
    """The operator's CPU result is block1_plain's; its schema, fake
    implementation and dispatch pass torch.library.opcheck."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 3, 17, 17, generator=g).to(torch.bfloat16)
    w1, b1 = torch.randn(8, 3, 3, 3, generator=g) * 0.3, torch.randn(8, generator=g) * 0.1
    w2, b2 = torch.randn(8, 8, 3, 3, generator=g) * 0.1, torch.randn(8, generator=g) * 0.1
    out = block1_fwd_op(x, w1, b1, w2, b2)
    assert out.shape == (2, 8, 9, 9) and out.dtype == torch.bfloat16
    assert torch.equal(out, block1_plain(x, w1, b1, w2, b2))
    assert torch.equal(torch.ops.em_adapt.block1_fwd(x, w1, b1, w2, b2), out)
    torch.library.opcheck(block1_fwd_op, (x, w1, b1, w2, b2),
                          test_utils=("test_schema", "test_faketensor"))


def test_int8_program_loads_in_a_fresh_process(tmp_path):
    """The int8 program of the fixture's weights (``eval/quantize.py``)
    loads in a fresh process that imports only ``eval/export.py``, as the
    f32 and bf16 programs do, and labels as the live quantized model."""
    import subprocess
    import sys

    from em_adapt_torch.eval.quantize import quantize_model

    z, _, np_params = _fixture()
    cfg, model = _port(np_params)
    x = z["x"]
    qmodel = quantize_model(cfg.model, model, [x])
    path = tmp_path / "int8.pt2"
    path.write_bytes(export_predict_fn(cfg, qmodel))
    with torch.no_grad():
        live = qmodel.predict(torch.from_numpy(x))[1].numpy()
    np.save(tmp_path / "x.npy", x)
    fresh = ("import sys, numpy as np, torch\n"
             "from em_adapt_torch.eval import export\n"
             "fn = export.load_predict_fn(open(sys.argv[1], 'rb').read())\n"
             "np.save(sys.argv[3], fn(torch.from_numpy(np.load(sys.argv[2])))[1].numpy())\n"
             "assert 'em_adapt_torch.eval.quantize' not in sys.modules\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", fresh, str(path), str(tmp_path / "x.npy"),
                    str(tmp_path / "labels.npy")], check=True, cwd=repo, timeout=120,
                   env={**os.environ, "PYTHONPATH": repo})
    np.testing.assert_array_equal(np.load(tmp_path / "labels.npy"), live)
