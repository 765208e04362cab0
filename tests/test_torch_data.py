"""The port's data path from disk against the JAX package on the CPU.

The dataset parsers on fixture trees of every layout, the PIL transforms and
random erasing, the port's own build of the native loader against the JAX
package's (bitwise) and against PIL, the JPEG writer that chip_smoke.py uses
where no PIL is installed, make_dataloader's samplers, batches and decoded
caches in both packages on one tree, one f32 train step fed by the host pipe
against JAX's build_train_step, do_train over pipes with both
TPU.DATA_CACHE values and its metrics log, the metrics log itself, and the
pretrained-backbone converters.
"""

import json
import sys
import threading
import types

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
from demo2_tpu.config import get_cfg_defaults as j_get_cfg
from demo2_tpu.config.presets import apply_flagship as j_apply_flagship
from demo2_tpu.config.presets import apply_tiny as j_apply_tiny
from demo2_tpu.data import datasets as jds
from demo2_tpu.data import device_cache as jdc
from demo2_tpu.data import loader as jloader
from demo2_tpu.data import native as jnative
from demo2_tpu.data import transforms as jtf
from demo2_tpu.engine.train import build_train_step as j_build_train_step
from demo2_tpu.models import make_model as j_make_model
from demo2_tpu.utils import converters as jconv
from demo2_tpu.utils import metrics_log as jml
from demo2_tpu_torch.config import get_cfg_defaults
from demo2_tpu_torch.config.presets import apply_flagship, apply_tiny
from demo2_tpu_torch.data import datasets as tds
from demo2_tpu_torch.data import device_cache as tdc
from demo2_tpu_torch.data import loader as tloader
from demo2_tpu_torch.data import native as tnative
from demo2_tpu_torch.data import transforms as ttf
from demo2_tpu_torch.engine.state import create_train_state
from demo2_tpu_torch.engine.train import build_host_train_step, do_train
from demo2_tpu_torch.models import make_model
from demo2_tpu_torch.utils import converters as tconv
from demo2_tpu_torch.utils import metrics_log as tml
from demo2_tpu_torch.utils.converters import convert_flax_variables
from tools.make_synthetic_jpegs import generate
from torch_port_helpers import CPU, generator, jax_state_from, load_port, n, random_variables, t

# ---------------------------------------------------------------------------
# Fixture trees (the layouts of tests/test_dataset_parsers.py)
# ---------------------------------------------------------------------------


def _save(path, shape=(64, 32), seed=0):
    path.parent.mkdir(parents=True, exist_ok=True)
    arr = np.random.default_rng(seed).integers(0, 255, (*shape, 3), np.uint8)
    Image.fromarray(arr).save(path, quality=90)


def _rgbnt100(root):
    for split in ("bounding_box_train", "query", "bounding_box_test"):
        for i, name in enumerate(["0001_c1_0.jpg", "0001_c2_0.jpg", "0002_c3_0.jpg",
                                  "0777_c4_0.jpg"]):
            _save(root / "RGBNT100" / "rgbir" / split / name, shape=(128, 768), seed=i)


def _msvr310(root):
    entries = [("0001", "0001_s001_v2_0.jpg"), ("0001", "0001_s002_v3_1.jpg"),
               ("0002", "0002_s001_v5_0.jpg")]
    for split in ("train", "query3", "gallery3"):
        for vid, name in entries:
            for mod in ("vis", "ni", "th"):
                _save(root / "MSVR310" / split / vid / mod / name)


def _market(root, name="market1501"):
    names = ["0001_c1s1_000151_00.jpg", "0001_c2s1_000176_00.jpg", "0007_c3s1_000201_00.jpg",
             "-1_c1s1_000000_00.jpg"]
    for split in ("bounding_box_train", "query", "bounding_box_test"):
        for nm in names:
            _save(root / name / split / nm)


def _duke(root):
    for split in ("bounding_box_train", "query", "bounding_box_test"):
        for nm in ("0001_c1_f0000151.jpg", "0001_c8_f0000176.jpg", "0042_c2_f0000201.jpg"):
            _save(root / "dukemtmcreid" / split / nm)


def _msmt17(root):
    base = root / "MSMT17"
    rels = ["0000/0000_013_01_0303morning_0015.jpg", "0000/0000_026_05_0303morning_0033.jpg",
            "0001/0001_004_12_0303afternoon_0110.jpg"]
    for sub in ("train", "test"):
        for r in rels:
            _save(base / sub / r)
    for lst in ("list_train", "list_val", "list_query", "list_gallery"):
        with open(base / f"{lst}.txt", "w") as fh:
            for r in rels:
                fh.write(f"{r} {int(r[:4])}\n")


def _wild(root):
    for split in ("train", "query", "test"):
        for mod in ("vis", "ni", "th"):
            for nm in ("000001_cam1_0.jpg", "000001_cam3_1.jpg", "000005_cam2_0.jpg"):
                _save(root / "MSVWild863" / split / mod / nm)


def _rgbnt201(root):
    generate(str(root), num_pids=4, imgs_per_pid=3, test_pids=3, test_imgs_per_pid=2,
             num_cams=3, src_size=(72, 36))


TREES = {"RGBNT201": _rgbnt201, "RGBNT100": _rgbnt100, "MSVR310": _msvr310,
         "market1501": _market, "dukemtmc": _duke, "msmt17": _msmt17, "MSVWild863": _wild}


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("trees")
    for build in TREES.values():
        build(root)
    return str(root)


@pytest.fixture(autouse=True)
def _decode_cache_dirs(tmp_path, monkeypatch):
    """Both packages keep their decodes under this test's directory."""
    monkeypatch.setattr(jdc, "DECODE_CACHE_DIR", str(tmp_path / "jax_decoded"))
    monkeypatch.setattr(tdc, "DECODE_CACHE_DIR", str(tmp_path / "port_decoded"))


def _summary(ds):
    return (ds.train, ds.query, ds.gallery, ds.num_train_pids, ds.num_train_imgs,
            ds.num_train_cams, ds.num_train_vids, ds.num_query_pids, ds.num_gallery_imgs)


@pytest.mark.parametrize("name", sorted(set(TREES) | {"Synthetic", "SyntheticHard",
                                                      "SyntheticHardBig"}))
def test_parsers_match_jax(name, trees):
    assert set(tds.DATASET_REGISTRY) == set(jds.DATASET_REGISTRY)
    port = tds.DATASET_REGISTRY[name](root=trees)
    jax_ds = jds.DATASET_REGISTRY[name](root=trees)
    assert _summary(port) == _summary(jax_ds)
    assert port.train and port.query and port.gallery
    if name.startswith("Synthetic"):
        np.testing.assert_array_equal(port.render_all(port.train[:2]),
                                      np.stack([np.stack(jax_ds.render(s[0]))
                                                for s in jax_ds.train[:2]]))


# ---------------------------------------------------------------------------
# Transforms
# ---------------------------------------------------------------------------


def _pil(seed, shape=(90, 50)):
    return Image.fromarray(np.random.default_rng(seed).integers(0, 256, (*shape, 3), np.uint8))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_transforms_are_bitwise_jax(seed):
    img = _pil(seed)
    kw = dict(size=(64, 32), re_prob=1.0 if seed % 2 else 0.5)
    want = jtf.TrainTransform(**kw)(img, np.random.default_rng(seed))
    got = ttf.TrainTransform(**kw)(img, np.random.default_rng(seed))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ttf.EvalTransform(size=(64, 32))(img),
                                  jtf.EvalTransform(size=(64, 32))(img))
    arr = np.random.default_rng(seed).standard_normal((64, 32, 3)).astype(np.float32)
    np.testing.assert_array_equal(ttf.random_erasing(arr.copy(), np.random.default_rng(seed), 1.0),
                                  jtf.random_erasing(arr.copy(), np.random.default_rng(seed), 1.0))


# ---------------------------------------------------------------------------
# The native loader: the port's own build against the JAX package's
# ---------------------------------------------------------------------------

# PIL against the native loader at eval (tests/test_data.py:119-120), in u8
# levels: JPEG decoders and resize rounding differ by a few levels.
PIL_MAX_U8, PIL_MEAN_U8 = chip_smoke.PIL_NATIVE_MAX_U8, chip_smoke.PIL_NATIVE_MEAN_U8


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    d = tmp_path_factory.mktemp("jpegs")
    paths = []
    for i in range(6):
        p = d / f"{i}.jpg"
        _pil(10 + i, (96 + 5 * i, 48 + 3 * i)).save(p, quality=95)
        paths.append(str(p))
    wide = d / "wide.jpg"
    _pil(20, (128, 768)).save(wide, quality=95)
    return paths, str(wide)


def test_native_library_is_built_from_the_repo():
    nl = tnative.native_library()
    assert nl.lib is not None, nl.error
    assert nl.decoder == "libjpeg" and nl.path.parent.parent == tnative.BUILD_DIR
    assert nl.path.name == "libd2tloader.so" and "native" not in nl.path.parts[-3:]


@pytest.mark.parametrize("case", ["train", "eval", "wide_train", "wide_eval"])
def test_load_batch_native_is_bitwise_jax(case, jpegs):
    paths, wide = jpegs
    if case.startswith("wide"):
        paths = [wide] * 3
        strips = list(tloader.STRIPS)
    else:
        strips = [None] * len(paths)
    params = []
    for mod in (tnative, jnative):
        if case.endswith("train"):
            params.append([mod.sample_train_params(np.random.default_rng((5, i)), (64, 32),
                                                   re_prob=1.0 if i % 2 else 0.5, strip=s)
                           for i, s in enumerate(strips)])
        else:
            params.append([mod.eval_params(s) for s in strips])
    kw = dict(out_h=64, out_w=32, mean=(0.5,) * 3, std=(0.5,) * 3, num_threads=3)
    got = tnative.load_batch_native(paths, params[0], **kw)
    want = jnative.load_batch_native(paths, params[1], **kw)
    np.testing.assert_array_equal(got, want)
    if case == "eval":  # against PIL, within tests/test_data.py's bounds
        pil = np.stack([jtf.EvalTransform(size=(64, 32))(Image.open(p).convert("RGB"))
                        for p in paths])
        d = np.abs(got - pil) * 255 * 0.5  # std 0.5: one u8 level is 2/255
        assert d.max() <= PIL_MAX_U8 and d.mean() <= PIL_MEAN_U8, (d.max(), d.mean())


def test_native_strip_crop_outside_the_image_is_zero(tmp_path):
    """A single-modal 64x32 image read as the wide strip (market1501's
    samples, bases.py:28-43): PIL's crop pads with zeros, and so does the
    port's native loader (the JAX package's copy reads past the image).  Its
    strips match the PIL path within the eval bounds."""
    path = tmp_path / "small.jpg"
    _pil(7, (64, 32)).save(path, quality=95)
    samples = [(str(path), 0, 0, 0)]
    tf = ttf.EvalTransform(size=(64, 32))
    native = tloader.TriModalDataPipe(samples, None, tf, 1, use_native=True)
    pil = tloader.TriModalDataPipe(samples, None, tf, 1, use_native=False)
    got, want = (next(p.iter_batches(np.arange(1))).images for p in (native, pil))
    d = np.abs(got - want) * 255 * 0.5
    assert d.max() <= PIL_MAX_U8 and d.mean() <= PIL_MEAN_U8, (d.max(), d.mean())
    np.testing.assert_array_equal(got[0, 1:], np.full_like(got[0, 1:], -1.0))  # zero pixels


def _jpeg_tree_error(tmp_path, shift: int):
    """u8 error of phase 27's check on a few of its images: the port's JPEG
    writer at quality 95, decoded and resized by the native loader, against
    the source arrays (shifted by `shift` pixels) resized by F.interpolate
    with antialiasing.  {filter: (max, mean)}."""
    ds = tds.SyntheticTriModal(num_pids=4, num_cams=3, imgs_per_pid=2, image_size=(288, 144),
                               hard=True)
    src = ds.render_all(ds.train)
    paths = []
    for i, imgs in enumerate(src):
        for m, img in enumerate(imgs):
            paths.append(str(tmp_path / f"{i}_{m}.jpg"))
            tnative.write_jpeg(paths[-1], img, quality=95)
    out = {}
    for interp, mode in ((tnative.INTERP_CUBIC, "bicubic"), (tnative.INTERP_BILINEAR, "bilinear")):
        flat = tnative.load_batch_native(paths, [tnative.eval_params(None, interp)] * len(paths),
                                         256, 128, (0.0,) * 3, (1.0,) * 3)
        got = torch.from_numpy(np.clip(np.round(flat * 255.0), 0, 255))
        want = chip_smoke.resized_reference(torch.from_numpy(np.roll(src, shift, axis=3)),
                                            (256, 128), mode)
        d = (got - want.reshape(got.shape)).abs()
        out[mode] = (d.max().item(), d.mean().item())
    return out


def test_jpeg_writer_round_trip_within_phase_27_bounds(tmp_path):
    """chip_smoke.py phase 27's bounds are PIL-against-native's plus the
    error of a quality-95 JPEG of its images: the writer's files decode back
    within them, and the source shifted by one pixel fails them."""
    for mode, (mx, mean) in _jpeg_tree_error(tmp_path, 0).items():
        assert mx <= chip_smoke.JPEG_Q95_MAX_U8 and mean <= chip_smoke.JPEG_Q95_MEAN_U8, (
            mode, mx, mean)
    for mode, (mx, mean) in _jpeg_tree_error(tmp_path, 1).items():
        assert mean > chip_smoke.DECODE_MEAN_U8, (mode, mean)
    img = np.random.default_rng(0).integers(0, 256, (40, 24, 3), np.uint8)
    tnative.write_jpeg(str(tmp_path / "x.jpg"), img, quality=100)
    back = np.asarray(Image.open(tmp_path / "x.jpg").convert("RGB")).astype(int)
    assert back.shape == img.shape and np.abs(back - img).mean() < 2.0  # PIL reads it


# ---------------------------------------------------------------------------
# make_dataloader in both packages on one tree
# ---------------------------------------------------------------------------


def _cfgs(root, name="RGBNT201", **kw):
    cfgs = []
    for get in (j_get_cfg, get_cfg_defaults):
        cfg = get()
        cfg.DATASETS.NAMES = name
        cfg.DATASETS.ROOT_DIR = root
        cfg.INPUT.SIZE_TRAIN = cfg.INPUT.SIZE_TEST = (32, 16)
        cfg.SOLVER.IMS_PER_BATCH = 4
        cfg.DATALOADER.NUM_INSTANCE = 2
        cfg.TEST.IMS_PER_BATCH = 5
        cfg.DATALOADER.NUM_WORKERS = 2
        for key, value in kw.items():
            section, k = key.split("__")
            setattr(getattr(cfg, section), k, value)
        cfgs.append(cfg)
    return cfgs


def _batch_fields(b):
    return b.images, b.pids, b.camids, b.viewids, b.valid, [str(p) for p in b.paths]


# market1501 / dukemtmc / msmt17 samples are single 64x32 images read as the
# wide strip (bases.py:28-43): PIL zero-pads the crop, JAX's native loader
# reads past the image (test_native_strip_crop_outside_the_image_is_zero).
@pytest.mark.parametrize("name,native", [("RGBNT201", "on"), ("RGBNT201", "off"),
                                         ("RGBNT100", "on"), ("RGBNT100", "off"),
                                         ("Synthetic", "auto"), ("SyntheticHard", "auto"),
                                         ("SyntheticHardBig", "auto"), ("MSVR310", "auto"),
                                         ("market1501", "off"), ("dukemtmc", "off"),
                                         ("msmt17", "off"), ("MSVWild863", "auto")])
def test_make_dataloader_batches_match_jax(name, native, trees):
    sampler_mode = "softmax" if name == "msmt17" else "softmax_triplet"
    jcfg, cfg = _cfgs(trees, name, DATALOADER__NATIVE_DECODE=native,
                      DATALOADER__SAMPLER=sampler_mode)
    jout, out = jloader.make_dataloader(jcfg), tloader.make_dataloader(cfg)
    assert out[3:] == jout[3:]
    assert out[0].use_native == jout[0].use_native == (native == "on" or (
        native == "auto" and not name.startswith("Synthetic")))
    assert len(out[1]) >= cfg.SOLVER.IMS_PER_BATCH
    assert type(out[1]).__name__ == type(jout[1]).__name__
    for epoch in (0, 1):
        np.testing.assert_array_equal(out[1].epoch_indices(epoch), jout[1].epoch_indices(epoch))
    order = out[1].epoch_indices(1)
    got = next(out[0].iter_batches(order, seed=1))
    want = next(jout[0].iter_batches(order, seed=1))
    for g, w in zip(_batch_fields(got), _batch_fields(want)):
        np.testing.assert_array_equal(g, w)
    val_order = np.arange(len(out[2].samples))
    got = list(out[2].iter_batches(val_order, drop_last=False, pad_last=True))
    want = list(jout[2].iter_batches(val_order, drop_last=False, pad_last=True))
    assert len(got) == len(want) == -(-len(val_order) // 5)
    for gb, wb in zip(got, want):
        for g, w in zip(_batch_fields(gb), _batch_fields(wb)):
            np.testing.assert_array_equal(g, w)
    assert got[-1].images.shape[0] == 5 and got[-1].valid == len(val_order) - 5 * (len(got) - 1)


def test_leaving_a_pipe_early_stops_its_producer(trees):
    """The JAX package's producer thread blocks for ever on its full queue
    when the consumer stops early (tools/train.py slices its sample batch
    for that reason); the port's stops."""
    _, cfg = _cfgs(trees, "RGBNT201", DATALOADER__NATIVE_DECODE="off")
    train, sampler, *_ = tloader.make_dataloader(cfg)
    order = np.concatenate([sampler.epoch_indices(e) for e in range(1, 5)])
    batches = train.iter_batches(order, seed=1, prefetch=1)
    next(batches)
    batches.close()
    assert not [th for th in threading.enumerate() if th.name == "demo2-data-pipe"]


@pytest.mark.parametrize("native", ["on", "off"])
def test_decode_all_matches_jax_and_is_kept(native, trees, monkeypatch):
    """The decoded arrays equal JAX's, a second call reads the kept decode
    back, and the native branch needs no PIL (JAX's imports it there too,
    device_cache.py:311)."""
    jcfg, cfg = _cfgs(trees, "RGBNT201", DATALOADER__NATIVE_DECODE=native)
    jtrain, _, jval, *_ = jloader.make_dataloader(jcfg)
    train, _, val, *_ = tloader.make_dataloader(cfg)
    for jp, p, is_train in ((jtrain, train, True), (jval, val, False)):
        want = jdc._decode_all(jp, is_train)
        np.testing.assert_array_equal(tdc._decode_all(p, is_train), want)
        first = tdc._decode_all_cached(p, is_train)
        second = tdc._decode_all_cached(p, is_train)
        assert not isinstance(first, np.memmap) and isinstance(second, np.memmap)
        np.testing.assert_array_equal(second, want)
    cache = tdc.build_device_cache(val, CPU)
    assert not cache.train and cache.decode_seconds >= 0.0
    np.testing.assert_array_equal(cache.images.numpy(), jdc._decode_all(jval, False))
    assert cache.pids.tolist() == [s[1] for s in val.samples]
    if native == "on":
        monkeypatch.setitem(sys.modules, "PIL", None)
        np.testing.assert_array_equal(tdc._decode_all(val, False), cache.images.numpy())


def test_native_forced_or_missing_decoders_raise_clearly(trees, monkeypatch):
    _, cfg = _cfgs(trees, "Synthetic", DATALOADER__NATIVE_DECODE="on")
    with pytest.raises(ValueError, match="on-disk JPEG"):
        tloader.make_dataloader(cfg)
    _, cfg = _cfgs(trees, "RGBNT201", DATALOADER__NATIVE_DECODE="garbage")
    with pytest.raises(ValueError, match="auto\\|on\\|off"):
        tloader.make_dataloader(cfg)
    # Neither decoder: the native build fails and PIL does not import.
    monkeypatch.setattr(tnative, "native_library", lambda: tnative.NativeLibrary(
        None, None, None, "libjpeg's header jpeglib.h is not on g++'s include path"))
    monkeypatch.setitem(sys.modules, "PIL", None)
    _, cfg = _cfgs(trees, "RGBNT201")
    with pytest.raises(RuntimeError, match="PIL does not import.*jpeglib.h"):
        tloader.make_dataloader(cfg)


# ---------------------------------------------------------------------------
# Training from the host pipe
# ---------------------------------------------------------------------------


@pytest.fixture
def no_flax_dropout(monkeypatch):
    """Dropout off on the JAX side (its draws are not the port's)."""
    monkeypatch.setattr(flax.linen.Dropout, "__call__",
                        lambda self, x, deterministic=None, rng=None: x)


def _flagship_cfgs(root, **kw):
    cfgs = []
    for get, flagship, tiny in ((j_get_cfg, j_apply_flagship, j_apply_tiny),
                                (get_cfg_defaults, apply_flagship, apply_tiny)):
        cfg = get()
        flagship(cfg, on_tpu=False)
        tiny(cfg)
        cfg.TPU.USE_FLASH_ATTENTION = True
        cfg.TPU.DATA_CACHE = "host"
        cfg.DATASETS.ROOT_DIR = root
        cfg.SOLVER.IMS_PER_BATCH = 8
        cfg.TEST.IMS_PER_BATCH = 8
        cfg.DATALOADER.NUM_WORKERS = 2
        for key, value in kw.items():
            section, k = key.split("__")
            setattr(getattr(cfg, section), k, value)
        cfgs.append(cfg.freeze())
    return cfgs


def test_one_host_fed_train_step_matches_jax(trees, no_flax_dropout):
    """The first batch of the train pipe (the same in both packages), one
    f32 step of the tiny flagship on it from the same weights: the loss and
    the weights after Adam within tests/test_torch_train.py's whole-step
    tolerance."""
    jcfg, cfg = _flagship_cfgs(trees, SOLVER__BASE_LR=3.5e-4)
    jtrain, jsampler, _, _, nc, cams, views = jloader.make_dataloader(jcfg)
    train, sampler, *_ = tloader.make_dataloader(cfg)
    order = sampler.epoch_indices(1)[: cfg.SOLVER.IMS_PER_BATCH]
    jb = next(jtrain.iter_batches(order, seed=1))
    jmodel = j_make_model(jcfg, nc, cams)
    variables = random_variables(jmodel, jb.images[:2], jb.camids[:2], train=False, seed=3)
    jstate, tx, ctx, _ = jax_state_from(jcfg, jmodel, variables, jb)
    jstate = jstate.replace(params=variables["params"], batch_stats=variables["batch_stats"],
                            opt_state=tx.init(variables["params"]))
    new_jstate, metrics = j_build_train_step(jcfg, jmodel, tx, ctx, donate=False)(
        jstate, jnp.asarray(jb.images), jnp.asarray(jb.pids), jnp.asarray(jb.camids),
        jnp.asarray(jb.viewids), jax.random.PRNGKey(1))

    port = load_port(make_model(cfg, nc, cams, device=CPU, generator=generator()), variables)
    for mlp in port.sdtps.modal_weight_mlp:
        mlp.dropout = 0.0
    state = create_train_state(cfg, port, 4)
    step = build_host_train_step(cfg, port, state, CPU)
    (b, *batch), = list(tloader.device_batches(train, order, CPU, seed=1))
    np.testing.assert_array_equal(b.images, jb.images)
    m = step(*batch)
    np.testing.assert_allclose(n(m["loss"]), float(metrics["loss"]), rtol=1e-5)
    np.testing.assert_allclose(n(m["acc"]), float(metrics["acc"]))
    want = convert_flax_variables({"params": new_jstate.params,
                                   "batch_stats": new_jstate.batch_stats}, port)
    # As test_one_train_step_matches_jax holds them: every element within
    # 2 lr, at most 0.1% of a tensor's beyond 1e-6.  The key bias (the middle
    # third of an in_proj_bias) has a gradient of exactly 0 (the softmax does
    # not see it), so Adam's first step turns its summation noise into a step
    # of up to lr either way: it is held to 2 lr only.
    lr = state.schedule(0)
    for k, v in port.state_dict().items():
        d = np.abs(n(v) - n(want[k]))
        assert d.max() <= 2 * lr + 1e-6, k
        if k.endswith("in_proj_bias"):
            c = d.shape[0] // 3
            d = np.concatenate([d[:c], d[2 * c:]])
        assert (d > 1e-6).mean() <= 1e-3, (k, d.max())


@pytest.mark.parametrize("native", ["on", "off"])
def test_run_eval_over_a_pipe_matches_jax(native, trees, tmp_path):
    """run_eval's host loop (padded last batch, `valid`) under MSVR310's
    scene protocol with its rank list, over the same pipe batches and
    weights as JAX's run_eval: the same CMC, mAP and rank list file."""
    from demo2_tpu.engine.eval import build_eval_step, run_eval as j_run_eval
    from demo2_tpu_torch.engine.eval import run_eval

    jcfg, cfg = _flagship_cfgs(trees, DATASETS__NAMES="MSVR310", TEST__IMS_PER_BATCH=4,
                               DATALOADER__NATIVE_DECODE=native)
    _, _, jval, nq, nc, cams, views = jloader.make_dataloader(jcfg)
    _, _, val, *_ = tloader.make_dataloader(cfg)
    assert len(val.samples) % 4  # a padded last batch
    b = next(jval.iter_batches(np.arange(2), drop_last=False))
    cams = 6  # the fixture's camera ids are 2, 3 and 5, of 3 train cameras
    jmodel = j_make_model(jcfg, nc, cams, views)
    variables = random_variables(jmodel, b.images, b.camids, train=False, seed=6)
    state = types.SimpleNamespace(params=variables["params"],
                                  batch_stats=variables["batch_stats"])
    jcmc, jmap = j_run_eval(jcfg, build_eval_step(jcfg, jmodel), state, jval, nq,
                            rank_list_path=str(tmp_path / "jax.txt"))
    port = load_port(make_model(cfg, nc, cams, views, device=CPU, generator=generator()),
                     variables)
    cmc, m_ap = run_eval(cfg, port, val, nq, rank_list_path=str(tmp_path / "port.txt"))
    np.testing.assert_allclose(cmc, jcmc, rtol=1e-6)
    np.testing.assert_allclose(m_ap, jmap, rtol=1e-5)
    assert (tmp_path / "port.txt").read_text() == (tmp_path / "jax.txt").read_text()


TAGS = {"Train/Loss", "Train/Acc", "Train/LR", "Val/mAP", "Val/Rank-1", "Val_Best/mAP"}


@pytest.mark.parametrize("data_cache", ["host", "device"])
def test_do_train_over_pipes_logs_the_jax_tags(data_cache, trees, tmp_path):
    _, cfg = _flagship_cfgs(trees, TPU__DATA_CACHE=data_cache, SOLVER__MAX_EPOCHS=2,
                            SOLVER__EVAL_PERIOD=1, SOLVER__LOG_PERIOD=1,
                            SOLVER__CHECKPOINT_PERIOD=1)
    train, sampler, val, nq, nc, cams, views = tloader.make_dataloader(cfg)
    model = make_model(cfg, nc, cams, views, device=CPU, generator=generator())
    state = create_train_state(cfg, model, len(sampler) // cfg.SOLVER.IMS_PER_BATCH)
    path = str(tmp_path / "m.jsonl")
    writer = tml.TeeWriter(tml.MetricsLogger(path))
    state, best = do_train(cfg, state, train, sampler, val, nq,
                           checkpoint_dir=str(tmp_path / "ckpt"), writer=writer)
    writer.close()
    steps = len(sampler) // cfg.SOLVER.IMS_PER_BATCH
    assert [e["epoch"] for e in state.history] == [1, 2] and state.step == 2 * steps
    assert all(np.isfinite(e["loss"]) and 0.0 < e["mAP"] <= 1.0 for e in state.history)
    rows = tml.load_metrics(path)
    assert {r["tag"] for r in rows} == TAGS
    val_map = [(r["step"], r["value"]) for r in rows if r["tag"] == "Val/mAP"]
    assert val_map == [(e["epoch"], pytest.approx(e["mAP"])) for e in state.history]
    assert [r["step"] for r in rows if r["tag"] == "Train/Loss"] == list(range(1, 2 * steps + 1))
    assert tml.summarize_run(path)["Val_Best/mAP"]["final"] == pytest.approx(best["mAP"])
    assert (tmp_path / "ckpt_best").is_dir()


# ---------------------------------------------------------------------------
# The metrics log
# ---------------------------------------------------------------------------


def test_metrics_log_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setattr("time.time", lambda: 1234.5)
    scalars = [("Train/Loss", 2.5, 1), ("Val/mAP", 0.25, 1), ("Train/Loss", 1.5, 2),
               ("Val/mAP", 0.5, 2), ("Val/Rank-1", np.float32(0.75), 2)]
    for mod, name in ((jml, "jax"), (tml, "port")):
        a, b = mod.MetricsLogger(str(tmp_path / name / "a.jsonl")), mod.MetricsLogger(None)
        tee = mod.TeeWriter(a, b, None)
        for tag, value, step in scalars:
            tee.add_scalar(tag, value, step)
        tee.close()
    lines = [(tmp_path / name / "a.jsonl").read_text() for name in ("jax", "port")]
    assert lines[0] == lines[1] and len(lines[1].splitlines()) == len(scalars)
    assert json.loads(lines[1].splitlines()[0]) == {"t": 1234.5, "tag": "Train/Loss",
                                                    "value": 2.5, "step": 1}
    path = str(tmp_path / "port" / "a.jsonl")
    assert tml.summarize_run(path) == jml.summarize_run(path)
    assert tml.summarize_run(path)["Val/mAP"] == {"final": 0.5, "best": 0.5, "steps": 2}
    runs = {"a": path, "gone": str(tmp_path / "none.jsonl")}
    texts = [open(mod.write_markdown_report(runs, str(tmp_path / f"{i}.md"))).read()
             for i, mod in enumerate((jml, tml))]
    assert texts[0] == texts[1] and "| a | 50.0% | 75.0% | 1.500 | 2 |" in texts[1]


# ---------------------------------------------------------------------------
# Pretrained backbones
# ---------------------------------------------------------------------------


def _random_sd(shapes, seed):
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy((0.05 * rng.standard_normal(s)).astype(np.float32))
            for k, s in shapes.items()}


def _clip_sd(width=64, layers=2, side=3, out_dim=512, seed=0):
    shapes = {"visual.conv1.weight": (width, 3, 16, 16), "visual.class_embedding": (width,),
              "visual.positional_embedding": (side * side + 1, width),
              "visual.ln_pre.weight": (width,), "visual.ln_pre.bias": (width,),
              "visual.ln_post.weight": (width,), "visual.ln_post.bias": (width,),
              "visual.proj": (width, out_dim), "token_embedding.weight": (10, width)}
    for i in range(layers):
        b = f"visual.transformer.resblocks.{i}."
        shapes.update({b + "attn.in_proj_weight": (3 * width, width),
                       b + "attn.in_proj_bias": (3 * width,),
                       b + "attn.out_proj.weight": (width, width),
                       b + "attn.out_proj.bias": (width,), b + "ln_1.weight": (width,),
                       b + "ln_1.bias": (width,), b + "ln_2.weight": (width,),
                       b + "ln_2.bias": (width,), b + "mlp.c_fc.weight": (4 * width, width),
                       b + "mlp.c_fc.bias": (4 * width,),
                       b + "mlp.c_proj.weight": (width, 4 * width),
                       b + "mlp.c_proj.bias": (width,)})
    return _random_sd(shapes, seed)


def _timm_sd(width=768, layers=1, side=3, seed=0):
    shapes = {"patch_embed.proj.weight": (width, 3, 16, 16), "patch_embed.proj.bias": (width,),
              "cls_token": (1, 1, width), "pos_embed": (1, side * side + 1, width),
              "norm.weight": (width,), "norm.bias": (width,), "head.weight": (5, width)}
    for i in range(layers):
        b = f"blocks.{i}."
        shapes.update({b + "norm1.weight": (width,), b + "norm1.bias": (width,),
                       b + "norm2.weight": (width,), b + "norm2.bias": (width,),
                       b + "attn.qkv.weight": (3 * width, width), b + "attn.qkv.bias": (3 * width,),
                       b + "attn.proj.weight": (width, width), b + "attn.proj.bias": (width,),
                       b + "mlp.fc1.weight": (4 * width, width), b + "mlp.fc1.bias": (4 * width,),
                       b + "mlp.fc2.weight": (width, 4 * width), b + "mlp.fc2.bias": (width,)})
    return _random_sd(shapes, seed)


@pytest.mark.parametrize("backbone", ["ViT-B-16", "vit_base_patch16_224"])
def test_pretrained_backbone_matches_jax_convert_and_merge(backbone, tmp_path):
    """A random CLIP visual (two blocks of width 64, with a text-tower key
    beside it) or timm ViT (one block of 768), saved with torch.save, loaded by the port
    as tools/train.py loads MODEL.PRETRAIN_PATH_T; the same weights through
    JAX's convert + merge: the same f32 embedding."""
    jcfg, cfg = _flagship_cfgs("", MODEL__TRANSFORMER_TYPE=backbone)
    if backbone != "ViT-B-16":
        for c in (jcfg, cfg):
            c.defrost()
            c.TPU.BACKBONE_WIDTH = c.TPU.BACKBONE_HEADS = -1
            c.TPU.BACKBONE_DEPTH = 1
            c.freeze()
    sd = _clip_sd() if backbone == "ViT-B-16" else _timm_sd()
    path = str(tmp_path / "pretrained.pth")
    torch.save(sd, path)
    h, w = cfg.INPUT.SIZE_TRAIN
    rng = np.random.default_rng(4)
    images = rng.standard_normal((2, 3, h, w, 3)).astype(np.float32)
    cams = np.array([0, 2], np.int32)
    jmodel = j_make_model(jcfg, 6, 4)
    variables = random_variables(jmodel, images, cams, train=False, seed=5)
    gh, gw = h // 16, w // 16
    np_sd = jconv.load_torch_state_dict(path)
    convert = jconv.convert_clip_visual if backbone == "ViT-B-16" else jconv.convert_imagenet_vit
    params = jconv.merge_pretrained_backbone(variables["params"], convert(np_sd, gh, gw))
    want = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]},
                        jnp.asarray(images), jnp.asarray(cams), train=False)["embedding"]

    port = load_port(make_model(cfg, 6, 4, device=CPU, generator=generator()), variables)
    loaded = tconv.load_pretrained_backbone(cfg, port, path)
    assert "head.weight" not in loaded and "token_embedding.weight" not in loaded
    got = port(t(images), t(cams).long())["embedding"]
    # f32 on both sides, summed in other orders: 1e-5 of the embedding's scale.
    want = np.asarray(want)
    np.testing.assert_allclose(n(got), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    bad = dict(sd)
    key = next(k for k in bad if k.endswith("ln_pre.weight") or k == "norm.weight")
    bad[key] = bad[key][:10]
    torch.save(bad, path)
    with pytest.raises(ValueError, match="no place"):
        tconv.load_pretrained_backbone(cfg, port, path)
