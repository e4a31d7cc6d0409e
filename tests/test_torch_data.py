"""PyTorch port: the VOC reader, the convert tool and the device
prefetcher on the CPU. The palette, split lists and converted masks equal
the JAX package's; ``VOCSegmentation`` + ``batch_iterator`` give its
batches bit for bit on a VOC tree written here, for training (two epochs,
resumed mid-stream) and evaluation (padded tail), in both wire formats;
``DevicePrefetcher`` on ``device="cpu"`` keeps the JAX prefetcher's
contracts and pulls no more than its ``limit``."""

import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("PIL")

from em_adapt_torch import config as pcfg  # noqa: E402
from em_adapt_torch.data import pipeline as ppipe  # noqa: E402
from em_adapt_torch.data import voc as pvoc  # noqa: E402
from em_adapt_tpu import config as jcfg  # noqa: E402
from em_adapt_tpu.data import pipeline as jpipe  # noqa: E402
from em_adapt_tpu.data import voc as jvoc  # noqa: E402

VOID = (224, 224, 192)  # VOC's object boundary color: no class


def write_voc_tree(root, sizes=(("train", 8), ("val", 3)), hw=(60, 120), quality=75, seed=0):
    """A VOC2012-layout tree under ``root``: RGB JPEGs, RGB-coded masks of
    two classes with a void border row in ``SegmentationClass``, and the
    split lists in ``root/txt``. Returns (main_path, list_dir)."""
    from PIL import Image

    main = root / "VOCdevkit" / "VOC2012"
    (main / "JPEGImages").mkdir(parents=True)
    (main / "SegmentationClass").mkdir(parents=True)
    (root / "txt").mkdir()
    g = np.random.default_rng(seed)
    for split, n in sizes:
        ids = []
        for i in range(n):
            img_id = f"2012_{split}{i:03d}"
            ids.append(img_id)
            h, w = (int(v) for v in g.integers(*hw, size=2))
            img = g.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
            Image.fromarray(img).save(main / "JPEGImages" / f"{img_id}.jpg", quality=quality)
            mask = np.zeros((h, w, 3), np.uint8)
            c1, c2 = g.integers(1, 21, size=2)
            mask[: h // 2] = pvoc.VOC_PALETTE[int(c1)]
            mask[h // 2:, : w // 2] = pvoc.VOC_PALETTE[int(c2)]
            mask[0, :] = VOID
            Image.fromarray(mask).save(main / "SegmentationClass" / f"{img_id}.png")
        (root / "txt" / f"{split}.txt").write_text("\n".join(ids) + "\n")
    return main, root / "txt"


@pytest.fixture(scope="module")
def voc_tree(tmp_path_factory):
    """The tree, its masks converted by the port into SegmentationClassAug."""
    root = tmp_path_factory.mktemp("pascal")
    main, txt = write_voc_tree(root)
    pvoc.convert_dataset(str(main / "SegmentationClass"), None,
                         str(main / "SegmentationClassAug"), log=lambda *a: None)
    return main, txt


def _pngs(path):
    from PIL import Image

    return {name: np.asarray(Image.open(path / name)) for name in sorted(os.listdir(path))}


def test_palette_and_names_are_the_jax_packages():
    assert pvoc.VOC_PALETTE == jvoc.VOC_PALETTE
    assert pvoc.VOC_CLASS_NAMES == jvoc.VOC_CLASS_NAMES
    assert pvoc.IGNORE_LABEL == jvoc.IGNORE_LABEL == 255
    from em_adapt_torch.eval import miou

    assert miou.VOC_CLASS_NAMES is pvoc.VOC_CLASS_NAMES


def test_palette_roundtrip():
    label = np.arange(21, dtype=np.uint8).reshape(3, 7)
    rgb = pvoc.index_to_rgb(label)
    np.testing.assert_array_equal(rgb, jvoc.index_to_rgb(label))
    np.testing.assert_array_equal(pvoc.rgb_mask_to_index(rgb), label)
    void = np.full((2, 2, 3), VOID, np.uint8)
    assert (pvoc.rgb_mask_to_index(void) == 255).all()
    g = np.random.default_rng(1)  # palette colors, void and off-palette colors mixed
    mixed = np.asarray(pvoc.VOC_PALETTE + (VOID, (1, 2, 3)), np.uint8)[g.integers(0, 23, (9, 11))]
    np.testing.assert_array_equal(pvoc.rgb_mask_to_index(mixed), jvoc.rgb_mask_to_index(mixed))


@pytest.mark.parametrize("length", [None, 1, 5])
def test_read_split(tmp_path, length):
    (tmp_path / "txt").mkdir()
    (tmp_path / "txt" / "train.txt").write_text("2007_000738\n2007_000739\n\n  2007_000740 \n")
    got = pvoc.read_split(str(tmp_path / "txt"), "train", "root", length=length)
    assert got == jvoc.read_split(str(tmp_path / "txt"), "train", "root", length=length)
    ids, imgs, labels = got
    assert ids == ["2007_000738", "2007_000739", "2007_000740"][:length]
    assert imgs[0].endswith(os.path.join("JPEGImages", "2007_000738.jpg"))
    assert labels[-1].endswith(os.path.join("SegmentationClassAug", f"{ids[-1]}.png"))


def test_convert_dataset(tmp_path):
    """A VOC RGB mask (class 3 square, void row) and an SBD .mat become
    index PNGs, and both packages write the same arrays."""
    from PIL import Image
    from scipy import io as scipy_io

    voc, sbd = tmp_path / "SegmentationClass", tmp_path / "cls"
    voc.mkdir()
    sbd.mkdir()
    rgb = np.zeros((10, 10, 3), np.uint8)
    rgb[2:6, 2:6] = pvoc.VOC_PALETTE[3]
    rgb[0, :] = VOID
    Image.fromarray(rgb).save(voc / "2007_000001.png")
    Image.fromarray(np.full((4, 5), 7, np.uint8)).save(voc / "2007_000003.png")  # indexed
    seg = np.zeros((8, 8), np.uint8)
    seg[1:4, 1:4] = 7
    scipy_io.savemat(sbd / "2008_000002.mat", {"GTcls": {"Segmentation": seg}})

    logs = []
    assert pvoc.convert_dataset(str(voc), str(sbd), str(tmp_path / "port"), log=logs.append) == 3
    assert logs[-1].startswith("convert finished: 3 masks")
    jvoc.convert_dataset(str(voc), str(sbd), str(tmp_path / "jax"), log=lambda *a: None)
    got, want = _pngs(tmp_path / "port"), _pngs(tmp_path / "jax")
    assert list(got) == list(want) == ["2007_000001.png", "2007_000003.png", "2008_000002.png"]
    for name in got:
        np.testing.assert_array_equal(got[name], want[name])
    a = got["2007_000001.png"]
    assert a[3, 3] == 3 and a[0, 0] == 255 and a[9, 9] == 0
    assert (got["2007_000003.png"] == 7).all()
    np.testing.assert_array_equal(got["2008_000002.png"], seg)


def test_convert_dataset_names_unsupported_mask_mode(tmp_path):
    """A gray + alpha mask fails with an error naming the file and mode."""
    from PIL import Image

    voc = tmp_path / "SegmentationClass"
    voc.mkdir()
    Image.fromarray(np.zeros((6, 6, 2), np.uint8), mode="LA").save(voc / "2007_000009.png")
    with pytest.raises(ValueError, match="2007_000009.*mode 'LA'"):
        pvoc.convert_dataset(str(voc), None, str(tmp_path / "out"), log=lambda *a: None)


def test_voc_strong_list(tmp_path):
    (tmp_path / "txt").mkdir()
    (tmp_path / "txt" / "train.txt").write_text("a\nb\nc\n")
    (tmp_path / "strong.txt").write_text("b\n")
    ds = ppipe.VOCSegmentation(pcfg.DataConfig(list_dir=str(tmp_path / "txt"), main_path="root"),
                               "train", strong_list=str(tmp_path / "strong.txt"))
    assert ds.is_strong.tolist() == [False, True, False]
    assert len(ds) == 3 and ds.ids == ["a", "b", "c"]


def test_convert_matches_jax_on_a_voc_tree(voc_tree, tmp_path):
    main, _ = voc_tree
    jvoc.convert_dataset(str(main / "SegmentationClass"), None, str(tmp_path / "jax"),
                         log=lambda *a: None)
    got, want = _pngs(main / "SegmentationClassAug"), _pngs(tmp_path / "jax")
    assert list(got) == list(want) and len(got) == 11
    for name in got:
        np.testing.assert_array_equal(got[name], want[name])
        assert got[name].dtype == np.uint8 and got[name].ndim == 2
        assert set(np.unique(got[name])) <= set(range(21)) | {255}


def _configs(main, txt, wire, length=None):
    kw = dict(main_path=str(main), list_dir=str(txt), input_size=(33, 33), num_workers=2,
              wire_dtype=wire, length=length)
    return pcfg.DataConfig(**kw), jcfg.DataConfig(**kw)


@pytest.mark.parametrize("wire", ["float32", "uint8"])
@pytest.mark.parametrize("masks", ["converted", "rgb-coded"])
def test_voc_dataset_matches_jax(voc_tree, tmp_path, wire, masks):
    """load_raw of both packages gives the same arrays; an RGB-coded mask
    is mapped through the palette on reading."""
    main, txt = voc_tree
    if masks == "rgb-coded":
        os.symlink(main / "JPEGImages", tmp_path / "JPEGImages")
        os.symlink(main / "SegmentationClass", tmp_path / "SegmentationClassAug")
        main = tmp_path
    pc, jc = _configs(main, txt, wire)
    port, ref = ppipe.VOCSegmentation(pc, "train"), jpipe.VOCSegmentation(jc, "train")
    assert len(port) == len(ref) == 8 and port.ids == ref.ids
    for i in range(len(port)):
        (img, lab), (jimg, jlab) = port.load_raw(i), ref.load_raw(i)
        assert img.dtype == np.uint8 and img.ndim == 3 and lab.ndim == 2
        np.testing.assert_array_equal(img, jimg)
        np.testing.assert_array_equal(lab, jlab)
        assert lab[0].tolist() == [255] * lab.shape[1]


def _assert_same_batches(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) == ["id", "image", "label"]
        assert g["id"] == w["id"]
        for k in ("image", "label"):
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape
            np.testing.assert_array_equal(g[k], w[k])


@pytest.mark.parametrize("wire", ["float32", "uint8"])
@pytest.mark.parametrize("start_step", [0, 3])
def test_voc_train_batches_match_jax(voc_tree, wire, start_step):
    """Two epochs of batch 3 (two batches an epoch, the tail dropped),
    from the start or resumed at step 3 (mid second epoch)."""
    main, txt = voc_tree
    pc, jc = _configs(main, txt, wire)
    got = list(ppipe.batch_iterator(ppipe.VOCSegmentation(pc, "train"), pc, batch_size=3,
                                    seed=7, epochs=2, start_step=start_step))
    want = list(jpipe.batch_iterator(jpipe.VOCSegmentation(jc, "train"), jc, batch_size=3,
                                     seed=7, epochs=2, start_step=start_step))
    _assert_same_batches(got, want)
    assert len(got) == 4 - start_step
    dt = np.uint8 if wire == "uint8" else np.float32
    assert got[0]["image"].shape == (3, 33, 33, 3) and got[0]["image"].dtype == dt


@pytest.mark.parametrize("wire", ["float32", "uint8"])
@pytest.mark.parametrize("length", [None, 2])
def test_voc_eval_batches_match_jax(voc_tree, wire, length):
    """The val split (3 images, or the first 2 with data.length) at eval
    batch 2: the last batch is padded with a zero image, an all-void label
    and the id "__pad__"."""
    main, txt = voc_tree
    pc, jc = _configs(main, txt, wire, length)
    got = list(ppipe.batch_iterator(ppipe.VOCSegmentation(pc, "val"), pc, batch_size=2,
                                    epochs=1, train=False))
    want = list(jpipe.batch_iterator(jpipe.VOCSegmentation(jc, "val"), jc, batch_size=2,
                                     epochs=1, train=False, drop_remainder=False,
                                     pad_remainder=True))
    _assert_same_batches(got, want)
    if length is None:
        assert got[-1]["id"][1] == "__pad__" and (got[-1]["label"][1] == 255).all()
        assert not got[-1]["image"][1].any()
    else:
        assert [b["id"] for b in got] == [["2012_val000", "2012_val001"]]


def _host_batches(n=16):
    ds = ppipe.SyntheticVOC(n=n, seed=3)
    cfg = pcfg.DataConfig(input_size=(33, 33), num_workers=2)
    return ds, cfg


def test_device_prefetcher_roundtrip_and_close():
    """Batches equal the host batches as CPU tensors with ids passed
    through; close() on an endless stream leaves no live thread."""
    ds, cfg = _host_batches()
    host = list(ppipe.batch_iterator(ds, cfg, batch_size=8, seed=5, epochs=1))
    pf = ppipe.DevicePrefetcher(iter(host), "cpu", depth=2)
    dev = list(pf)
    assert len(dev) == len(host) == 2
    for h, d in zip(host, dev):
        for k in ("image", "label"):
            assert isinstance(d[k], torch.Tensor) and d[k].device.type == "cpu"
            np.testing.assert_array_equal(d[k].numpy(), h[k])
            assert not np.shares_memory(d[k].numpy(), h[k])
        assert d["id"] == h["id"]
    with pytest.raises(StopIteration):
        next(pf)
    pf.close()

    endless = ppipe.batch_iterator(ds, cfg, batch_size=8, seed=5)
    pf2 = ppipe.DevicePrefetcher(endless, "cpu", depth=2)
    next(pf2)
    pf2.close(timeout=30)
    assert not pf2._thread.is_alive()
    endless.close()  # no thread is left inside the generator


def test_device_prefetcher_propagates_source_errors():
    """An error in the source fails the consumer, with that error as the
    cause, after the batches that came before it; it never looks like the
    end of the data."""
    ds, cfg = _host_batches()
    good = list(ppipe.batch_iterator(ds, cfg, batch_size=8, seed=5, epochs=1))

    def broken():
        yield good[0]
        raise OSError("truncated JPEG")

    pf = ppipe.DevicePrefetcher(broken(), "cpu", depth=2)
    got = [next(pf)]
    with pytest.raises(RuntimeError, match="fill thread died") as ei:
        while True:
            got.append(next(pf))
    assert isinstance(ei.value.__cause__, OSError)
    assert len(got) == 1
    pf.close()


@pytest.mark.parametrize("limit", [0, 1, 3, None])
def test_device_prefetcher_pulls_no_more_than_its_limit(limit):
    """Even when the consumer stops early, the thread pulls at most
    ``limit`` batches from an endless source; all it pulled are yielded."""
    pulled = []

    def source():
        i = 0
        while True:
            pulled.append(i)
            yield {"image": np.full((1, 2), i, np.float32), "id": [str(i)]}
            i += 1

    pf = ppipe.DevicePrefetcher(source(), "cpu", depth=2, limit=limit)
    if limit is None:
        got = [next(pf) for _ in range(5)]
    else:
        got = list(pf)
        assert len(got) == len(pulled) == limit
    assert [b["id"] for b in got] == [[str(i)] for i in range(len(got))]
    assert [float(b["image"][0, 0]) for b in got] == list(range(len(got)))
    pf.close()
    assert not pf._thread.is_alive()
    if limit is None:
        assert 5 <= len(pulled) <= 5 + 2 + 1  # the queue's depth and the batch in hand


def test_device_prefetcher_thread_is_named_and_daemon():
    pf = ppipe.DevicePrefetcher(iter([]), "cpu")
    assert pf._thread.daemon and pf._thread.name == "DevicePrefetcher"
    assert list(pf) == []
    pf.close()
    assert pf._thread not in threading.enumerate()


def test_data_overrides_reach_the_new_fields():
    cfg = pcfg.apply_overrides(pcfg.ExperimentConfig(), [
        "data.main_path=/x/VOC2012", "data.list_dir=/x/txt", "data.length=5", "data.prefetch=0"])
    assert (cfg.data.main_path, cfg.data.list_dir, cfg.data.length, cfg.data.prefetch) == (
        "/x/VOC2012", "/x/txt", 5, 0)
    d, j = pcfg.DataConfig(), jcfg.DataConfig()
    assert (d.main_path, d.list_dir, d.length, d.prefetch) == (
        j.main_path, j.list_dir, j.length, j.prefetch)
    assert pcfg.apply_overrides(pcfg.ExperimentConfig(), ["data.length=none"]).data.length is None
