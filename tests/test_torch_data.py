"""The port's data edge against the JAX package's, on the CPU: the host JPEG
library (``data/native.py``, the libjpeg build of ``csrc/fastloader.cpp``
plus the port's encoder), ``ImageSource`` with its fallbacks and decode
cache, the synthetic generators, the loader's background prefetch, and
``cli train`` straight from JPEG files.

Everything here is exact: both packages run the same libjpeg decoder and the
same numpy, so the bytes, arrays, CSVs and JSON are held equal. The one
comparison across libraries is the port's q90 encoder against
``cv2.imwrite`` (cv2 bundles its own libjpeg-turbo): equal decoded pixels.
"""

import contextlib
import json
import logging
import os
import subprocess
import threading
import time

import cv2
import numpy as np
import pytest
from PIL import Image

from image_classification_tpu.data import native as jax_native
from image_classification_tpu.data import synthetic as jax_synthetic
from image_classification_tpu.data import synthetic_hard as jax_hard
from image_classification_tpu.data.source import ImageSource as JaxImageSource
from image_classification_tpu_torch import cli
from image_classification_tpu_torch.core.config import Config
from image_classification_tpu_torch.data import (
    DataLoader,
    ImageSource,
    Manifest,
    SequentialSampler,
    ShuffleSampler,
    native,
    synthetic,
    synthetic_hard,
)
from image_classification_tpu_torch.data.source import decode_cache_key, load_decode_cache
from image_classification_tpu_torch.train import kfold
from test_torch_loop import overrides
from test_torch_ops import one_torch_thread  # noqa: F401  (autouse, module scope)

NATIVE = (60, 80)
FIXTURE = os.path.join(os.path.dirname(native.__file__), "fixtures", "jpeg")


@contextlib.contextmanager
def warnings_of(name: str):
    """The WARNING messages logged to logger ``name`` inside the block."""
    msgs: list[str] = []
    handler = logging.Handler(logging.WARNING)
    handler.emit = lambda r: msgs.append(r.getMessage())
    logger = logging.getLogger(name)
    logger.addHandler(handler)
    try:
        yield msgs
    finally:
        logger.removeHandler(handler)


def write_bgr(path, rgb, *params):
    cv2.imwrite(str(path), cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR), list(params))


@pytest.fixture(scope="module")
def jpeg_dir(tmp_path_factory):
    """``tests/test_native_loader.py``'s cases: 8 random 60x80 JPEGs, one
    30x40 (resized on decode), one corrupt file; plus a CMYK JPEG (PIL)."""
    d = tmp_path_factory.mktemp("jpgs")
    rng = np.random.default_rng(0)
    for i in range(8):
        cv2.imwrite(str(d / f"img{i}.jpg"), rng.integers(0, 256, (60, 80, 3), dtype=np.uint8))
    cv2.imwrite(str(d / "odd.jpg"), rng.integers(0, 256, (30, 40, 3), dtype=np.uint8))
    (d / "bad.jpg").write_bytes(b"not a jpeg")
    Image.fromarray(rng.integers(0, 256, (60, 80, 4), dtype=np.uint8), "CMYK").save(
        d / "cmyk.jpg", quality=90)
    return str(d)


IDS = [f"img{i}" for i in range(8)] + ["odd", "bad", "missing"]


# libjpeg's raw planes (raw_data_out) finished by the nvJPEG build's
# jpeg_color.h, against libjpeg's own RGB decode of the same file: prints
# "<path> max <max |diff|>" a file.
COLOR_HARNESS = r"""
#include <algorithm>
#include <cstdio>
#include <cstdlib>
#include <vector>
#include <jpeglib.h>
#include "jpeg_color.h"

static void decode_rgb(const char* path, std::vector<uint8_t>* rgb, int* w, int* h) {
  FILE* f = std::fopen(path, "rb");
  jpeg_decompress_struct ci;
  jpeg_error_mgr jerr;
  ci.err = jpeg_std_error(&jerr);
  jpeg_create_decompress(&ci);
  jpeg_stdio_src(&ci, f);
  jpeg_read_header(&ci, TRUE);
  ci.out_color_space = JCS_RGB;
  jpeg_start_decompress(&ci);
  *w = ci.output_width;
  *h = ci.output_height;
  rgb->resize((size_t)*w * *h * 3);
  while (ci.output_scanline < ci.output_height) {
    JSAMPROW row = rgb->data() + (size_t)ci.output_scanline * *w * 3;
    jpeg_read_scanlines(&ci, &row, 1);
  }
  jpeg_finish_decompress(&ci);
  jpeg_destroy_decompress(&ci);
  std::fclose(f);
}

static void decode_planes(const char* path, std::vector<uint8_t>* rgb) {
  FILE* f = std::fopen(path, "rb");
  jpeg_decompress_struct ci;
  jpeg_error_mgr jerr;
  ci.err = jpeg_std_error(&jerr);
  jpeg_create_decompress(&ci);
  jpeg_stdio_src(&ci, f);
  jpeg_read_header(&ci, TRUE);
  ci.raw_data_out = TRUE;
  jpeg_start_decompress(&ci);
  const int nc = ci.num_components, w = ci.output_width, h = ci.output_height;
  const int step = ci.max_v_samp_factor * DCTSIZE;
  std::vector<std::vector<uint8_t>> planes(nc);
  std::vector<std::vector<std::vector<uint8_t>>> bufs(nc);
  std::vector<std::vector<JSAMPROW>> rows(nc);
  std::vector<JSAMPARRAY> arrs(nc);
  for (int c = 0; c < nc; ++c) {
    jpeg_component_info* cp = &ci.comp_info[c];
    planes[c].resize((size_t)cp->downsampled_width * cp->downsampled_height);
    bufs[c].assign(cp->v_samp_factor * DCTSIZE,
                   std::vector<uint8_t>(cp->width_in_blocks * DCTSIZE));
    for (auto& b : bufs[c]) rows[c].push_back(b.data());
    arrs[c] = rows[c].data();
  }
  for (int done = 0; ci.output_scanline < ci.output_height; done += step) {
    jpeg_read_raw_data(&ci, arrs.data(), step);
    for (int c = 0; c < nc; ++c) {
      jpeg_component_info* cp = &ci.comp_info[c];
      const int n = cp->v_samp_factor * DCTSIZE, base = done / step * n;
      for (int r = 0; r < n && base + r < (int)cp->downsampled_height; ++r)
        std::copy(bufs[c][r].begin(), bufs[c][r].begin() + cp->downsampled_width,
                  planes[c].begin() + (size_t)(base + r) * cp->downsampled_width);
    }
  }
  const int cw = nc > 1 ? ci.comp_info[1].downsampled_width : 0;
  const int ch = nc > 1 ? ci.comp_info[1].downsampled_height : 0;
  const int fx = nc > 1 ? ci.max_h_samp_factor / ci.comp_info[1].h_samp_factor : 1;
  const int fy = nc > 1 ? ci.max_v_samp_factor / ci.comp_info[1].v_samp_factor : 1;
  jpeg_finish_decompress(&ci);
  jpeg_destroy_decompress(&ci);
  std::fclose(f);
  rgb->resize((size_t)w * h * 3);
  std::vector<int> scratch;
  ic_planes_to_rgb(planes[0].data(), nc > 1 ? planes[1].data() : nullptr,
                   nc > 1 ? planes[2].data() : nullptr, w, h, cw, ch, fx, fy,
                   rgb->data(), &scratch);
}

int main(int argc, char** argv) {
  for (int a = 1; a < argc; ++a) {
    std::vector<uint8_t> ref, got;
    int w, h, mx = 0;
    decode_rgb(argv[a], &ref, &w, &h);
    decode_planes(argv[a], &got);
    for (size_t i = 0; i < ref.size(); ++i) mx = std::max(mx, std::abs(ref[i] - got[i]));
    std::printf("%s max %d\n", argv[a], mx);
  }
}
"""


def test_nvjpeg_builds_colour_conversion_is_libjpegs(tmp_path):
    """The nvJPEG build finishes nvJPEG's planes with ``jpeg_color.h``.
    Fed the planes libjpeg itself decodes, it must give libjpeg's RGB bytes
    for 4:4:4, 4:2:2, 4:2:0 and grey JPEGs at even, odd and tiny sizes."""
    (tmp_path / "h.cpp").write_text(COLOR_HARNESS)
    subprocess.run([native.CXX, "-O2", "-std=c++17", "-I", str(native.CSRC), "-o",
                    str(tmp_path / "h"), str(tmp_path / "h.cpp"), "-ljpeg"], check=True)
    rng = np.random.default_rng(6)
    paths = []
    for h, w in ((60, 80), (61, 83), (7, 5), (3, 2)):
        yy, xx = np.mgrid[0:h, 0:w]
        img = np.clip(np.stack([127 + 100 * np.sin(xx / 3 + yy / 5 + c)
                                + rng.normal(0, 20, (h, w)) for c in range(3)], -1),
                      0, 255).astype(np.uint8)
        for sub in (0, 1, 2):
            paths.append(str(tmp_path / f"{h}x{w}_{sub}.jpg"))
            Image.fromarray(img).save(paths[-1], quality=90, subsampling=sub)
        paths.append(str(tmp_path / f"{h}x{w}_grey.jpg"))
        Image.fromarray(img[..., 0]).save(paths[-1], quality=90)
    out = subprocess.run([str(tmp_path / "h"), *paths], check=True, capture_output=True,
                         text=True).stdout.splitlines()
    assert out == [f"{p} max 0" for p in paths]


def test_host_library_is_libjpeg():
    assert native.recipe().name == "libjpeg"
    assert "libjpeg-turbo" in native.lib_version()


@pytest.mark.parametrize("threads", [1, 4])
def test_decode_batch_matches_jax(jpeg_dir, threads):
    paths = [os.path.join(jpeg_dir, f"{i}.jpg") if i != "missing" else None for i in IDS]
    ours = np.full((len(paths), *NATIVE, 3), 7, np.uint8)
    theirs = np.full_like(ours, 9)
    ok = native.decode_batch(paths, ours, num_threads=threads)
    ok_jax = jax_native.decode_batch(paths, theirs, num_threads=threads)
    assert ok.tolist() == ok_jax.tolist() == [True] * 9 + [False, False]
    np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("fallback", ["black", "random"])
def test_image_source_matches_jax(jpeg_dir, fallback):
    """Good, odd-sized, corrupt and missing files, in memory: the same
    arrays and the same missing/unreadable count (one thread, so JAX's
    random fallback draws in index order too)."""
    with warnings_of("ic_tpu_torch") as ours_log, warnings_of("ic_tpu") as jax_log:
        ours = ImageSource(jpeg_dir, IDS, NATIVE, fallback=fallback, num_threads=1)
        theirs = JaxImageSource(jpeg_dir, np.array(IDS, object), NATIVE, fallback=fallback,
                                num_threads=1)
    np.testing.assert_array_equal(ours.get_batch(np.arange(len(IDS))),
                                  theirs.get_batch(np.arange(len(IDS))))
    assert [m for m in ours_log if "missing/unreadable" in m] == jax_log
    assert jax_log == ["ImageSource: 1/11 images missing/unreadable"]
    assert any("rejected 1/11" in m and "bad.jpg" in m for m in ours_log)
    assert ours._cache_key() == theirs._cache_key()


def test_cmyk_jpeg_takes_the_fallback(jpeg_dir):
    """A departure: fastloader rejects a 4-component JPEG and the port has
    no cv2 to retry with, so it gets the fallback where JAX decodes it."""
    ours = ImageSource(jpeg_dir, ["cmyk"], NATIVE).get_batch(np.arange(1))
    theirs = JaxImageSource(jpeg_dir, np.array(["cmyk"], object), NATIVE).get_batch(np.arange(1))
    assert (ours == 0).all() and theirs.std() > 10


def test_png_raises(tmp_path):
    rgb = np.random.default_rng(1).integers(0, 256, (*NATIVE, 3), dtype=np.uint8)
    write_bgr(tmp_path / "a.png", rgb)
    write_bgr(tmp_path / "b.jpg", rgb)
    with pytest.raises(NotImplementedError, match="a.png"):
        ImageSource(str(tmp_path), ["b", "a"], NATIVE)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_decode_cache_is_shared(jpeg_dir, tmp_path, writer):
    """A cache written by either package is read by the other: the same
    files, then the same bytes without decoding."""
    cache = str(tmp_path / "cache")
    ids = np.array(IDS, object)
    first = (JaxImageSource(jpeg_dir, ids, NATIVE, cache_dir=cache) if writer == "jax"
             else ImageSource(jpeg_dir, ids, NATIVE, cache_dir=cache))
    key = decode_cache_key(jpeg_dir, ids, NATIVE)
    with open(os.path.join(cache, f"imgs_{key}.json")) as f:
        assert json.load(f) == {"shape": [len(ids), *NATIVE, 3], "complete": True}
    os.rename(jpeg_dir, jpeg_dir + ".away")    # the reader must not decode
    try:
        second = (ImageSource(jpeg_dir, ids, NATIVE, cache_dir=cache) if writer == "jax"
                  else JaxImageSource(jpeg_dir, ids, NATIVE, cache_dir=cache))
        loaded = load_decode_cache(jpeg_dir, ids, NATIVE, cache)
    finally:
        os.rename(jpeg_dir + ".away", jpeg_dir)
    everything = np.arange(len(ids))
    np.testing.assert_array_equal(second.get_batch(everything), first.get_batch(everything))
    np.testing.assert_array_equal(loaded.get_batch(everything), first.get_batch(everything))
    assert (first.get_batch(everything)[:9].std(axis=(1, 2, 3)) > 1).all()


@pytest.mark.parametrize("quality", [75, 90, 95])
def test_encoder_matches_cv2(tmp_path, quality):
    """The port's encoder decodes to the pixels of ``cv2.imwrite``'s file
    at the same quality (the hard set's q90, cv2's default 95)."""
    imgs = jax_hard.hard_synthetic_images(np.arange(4), jax_hard.HardTaskSpec(), NATIVE, seed=2)
    imgs = np.concatenate([imgs, np.random.default_rng(3).integers(0, 256, (1, *NATIVE, 3),
                                                                   dtype=np.uint8)])
    paths = []
    for i, img in enumerate(imgs):
        native.encode_rgb(str(tmp_path / f"p{i}.jpg"), img, quality)
        write_bgr(tmp_path / f"c{i}.jpg", img, cv2.IMWRITE_JPEG_QUALITY, quality)
        paths += [str(tmp_path / f"p{i}.jpg"), str(tmp_path / f"c{i}.jpg")]
    out = np.zeros((len(paths), *NATIVE, 3), np.uint8)
    assert native.decode_batch(paths, out).all()
    np.testing.assert_array_equal(out[0::2], out[1::2])
    ref = cv2.cvtColor(cv2.imread(paths[1]), cv2.COLOR_BGR2RGB)
    np.testing.assert_array_equal(out[0], ref)


@pytest.mark.parametrize("name", ["hard_synthetic_images", "build_prototypes",
                                  "apply_label_noise", "longtail_labels",
                                  "synthetic_images"])
def test_generators_match_jax(name):
    spec = synthetic_hard.HardTaskSpec(label_noise=0.2)
    labels = np.random.default_rng(4).integers(0, 44, size=40)
    calls = {
        "hard_synthetic_images": lambda m: m.hard_synthetic_images(
            labels, m.HardTaskSpec(), (30, 40), seed=5, proto_seed=6, chunk=16),
        "build_prototypes": lambda m: m.build_prototypes(m.HardTaskSpec(group_size=3), seed=8),
        "apply_label_noise": lambda m: m.apply_label_noise(
            labels, m.HardTaskSpec(**{k: getattr(spec, k) for k in ("label_noise",)}), seed=9),
        "longtail_labels": lambda m: m.longtail_labels(300, 44, seed=10, imbalance=20.0),
        "synthetic_images": lambda m: m.synthetic_images(labels, (24, 32), seed=11),
    }
    port_mod = synthetic if name in ("longtail_labels", "synthetic_images") else synthetic_hard
    jax_mod = jax_synthetic if port_mod is synthetic else jax_hard
    ours, theirs = calls[name](port_mod), calls[name](jax_mod)
    if isinstance(theirs, dict):
        assert ours.keys() == theirs.keys()
        for k in theirs:
            np.testing.assert_array_equal(ours[k], theirs[k])
    else:
        assert ours.dtype == theirs.dtype
        np.testing.assert_array_equal(ours, theirs)


def _decoded(d: str) -> dict[str, np.ndarray]:
    names = sorted(os.listdir(d))
    out = np.zeros((len(names), *NATIVE, 3), np.uint8)
    assert jax_native.decode_batch([os.path.join(d, n) for n in names], out).all()
    return dict(zip(names, out))


@pytest.mark.parametrize("kind", ["hard", "easy"])
def test_make_dataset_matches_jax(tmp_path, kind):
    """Byte-equal CSVs and ``task_spec.json``, the same file names, and
    JPEGs that decode to the JAX package's pixels."""
    kw = dict(n_train=50, n_test=12, native_size=NATIVE, seed=3)
    if kind == "hard":
        ours = synthetic_hard.make_hard_synthetic_dataset(str(tmp_path / "p"), **kw)
        theirs = jax_hard.make_hard_synthetic_dataset(str(tmp_path / "j"), **kw)
        np.testing.assert_array_equal(ours["train_labels_clean"], theirs["train_labels_clean"])
    else:
        ours = synthetic.make_synthetic_dataset(str(tmp_path / "p"), **kw)
        theirs = jax_synthetic.make_synthetic_dataset(str(tmp_path / "j"), **kw)
    np.testing.assert_array_equal(ours["train_labels"], theirs["train_labels"])
    files = sorted(os.listdir(tmp_path / "j"))
    assert sorted(os.listdir(tmp_path / "p")) == files
    for name in files:
        p, j = tmp_path / "p" / name, tmp_path / "j" / name
        if p.is_dir():
            ours_px, theirs_px = _decoded(str(p)), _decoded(str(j))
            assert ours_px.keys() == theirs_px.keys()
            for k in theirs_px:
                np.testing.assert_array_equal(ours_px[k], theirs_px[k])
        else:
            assert p.read_bytes() == j.read_bytes(), name


def test_committed_fixture_matches_jax():
    """The JPEG fixture that the card's decode is held against: the JAX
    package's ``ImageSource`` gives its committed bytes, and so does the
    port; its PNG raises."""
    expected = np.load(os.path.join(FIXTURE, "expected.npz"))
    ids = [str(i) for i in expected["ids"]]
    theirs = JaxImageSource(FIXTURE, np.array(ids, object), NATIVE, num_threads=1)
    everything = np.arange(len(ids))
    np.testing.assert_array_equal(theirs.get_batch(everything), expected["images"])
    np.testing.assert_array_equal(ImageSource(FIXTURE, ids, NATIVE).get_batch(everything),
                                  expected["images"])
    assert (expected["images"][ids.index("odd")] > 0).any()
    assert (expected["images"][ids.index("corrupt")] == 0).all()
    with pytest.raises(NotImplementedError, match="pic.png"):
        ImageSource(FIXTURE, [*ids, "pic"], NATIVE)
    size = sum(os.path.getsize(os.path.join(FIXTURE, f)) for f in os.listdir(FIXTURE))
    assert size <= 100_000


class _Source:
    """An ArraySource whose ``get_batch`` raises at its ``fail_at``-th call."""

    def __init__(self, n: int, fail_at: int | None = None):
        self.images = np.random.default_rng(5).integers(0, 256, (n, 4, 6, 3), dtype=np.uint8)
        self.fail_at, self.calls = fail_at, 0

    def get_batch(self, idx):
        self.calls += 1
        if self.calls == self.fail_at:
            raise KeyError(f"batch {self.calls} is unreadable")
        return self.images[idx]


@pytest.mark.parametrize("drop_last", [False, True])
def test_loader_prefetch_gives_the_same_batches(drop_last):
    manifest = Manifest(np.array([str(i) for i in range(23)], object), np.arange(23) % 5)
    source = _Source(23)
    got = {}
    for depth in (0, 2):
        loader = DataLoader(source, manifest, batch_size=4, drop_last=drop_last,
                            sampler=ShuffleSampler(23, seed=3), device="cpu",
                            prefetch_depth=depth)
        loader.set_epoch(2)
        got[depth] = list(loader)
    assert len(got[0]) == len(got[2]) == (5 if drop_last else 6)
    for a, b in zip(got[0], got[2]):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


@pytest.mark.parametrize("depth", [0, 2])
def test_loader_raises_the_source_error(depth):
    manifest = Manifest(np.array([str(i) for i in range(12)], object), np.zeros(12))
    loader = DataLoader(_Source(12, fail_at=2), manifest, batch_size=4, device="cpu",
                        sampler=SequentialSampler(12), prefetch_depth=depth)
    it = iter(loader)
    assert next(it)["image"].shape == (4, 4, 6, 3)
    with pytest.raises(KeyError, match="batch 2 is unreadable"):
        next(it)


def test_loader_prefetch_thread_stops_when_closed():
    """A consumer that stops early (a fold that raises) leaves no prefetch
    thread behind: closing the iterator stops it at its next batch."""
    manifest = Manifest(np.array([str(i) for i in range(40)], object), np.zeros(40))
    loader = DataLoader(_Source(40), manifest, batch_size=4, device="cpu",
                        sampler=SequentialSampler(40), prefetch_depth=2)
    it = iter(loader)
    next(it)
    it.close()
    deadline = time.monotonic() + 5
    while any(t.name == "DataLoader-prefetch" for t in threading.enumerate()):
        assert time.monotonic() < deadline, "the prefetch thread is still alive"
        time.sleep(0.01)


def test_build_source_decodes_in_memory_without_the_cache(tmp_path, jpeg_dir):
    manifest = Manifest(np.array(IDS, object), np.zeros(len(IDS)))
    on = kfold.build_source(Config(cache_dir=str(tmp_path / "c"), native_size=NATIVE),
                            manifest, jpeg_dir)
    off = kfold.build_source(Config(cache_dir=str(tmp_path / "d"), native_size=NATIVE,
                                    use_decode_cache=False), manifest, jpeg_dir)
    assert isinstance(on.images, np.memmap) and not isinstance(off.images, np.memmap)
    assert not os.path.exists(tmp_path / "d")
    np.testing.assert_array_equal(on.images, off.images)


def test_cli_train_from_jpegs_equals_the_run_from_a_cache(tmp_path):
    """``cli train --device cpu`` straight from JPEG files
    (``use_decode_cache=false``) writes the metrics of the same run through
    a decode cache it builds, and the same submission."""
    root = str(tmp_path)
    synthetic_hard.make_hard_synthetic_dataset(root, n_train=48, n_test=8, native_size=(24, 32),
                                               spec=synthetic_hard.HardTaskSpec(num_classes=6,
                                                                                group_size=2),
                                               seed=1)
    records = {}
    for tag, cached in (("mem", False), ("cache", True)):
        kw = dict(model_name="convnext_atto", num_classes=6, image_size=(32, 32),
                  native_size=(24, 32), use_deep_supervision=False, aug_enabled=False,
                  compute_dtype="float32", batch_size=8, epochs=1, split_mode="holdout",
                  val_fraction=0.5, save_state_every=0, use_decode_cache=cached,
                  train_csv=f"{root}/train.csv", train_dir=f"{root}/train",
                  test_csv=f"{root}/sample_submission.csv", test_dir=f"{root}/test",
                  cache_dir=f"{root}/{tag}/cache", model_save_path=f"{root}/{tag}/models",
                  output_dir=f"{root}/{tag}/out", submission_path=f"{root}/{tag}/sub.csv")
        cli.main(["train", "--device", "cpu", *overrides(kw)])
        with open(f"{root}/{tag}/out/metrics.jsonl") as f:
            records[tag] = [json.loads(line) for line in f]
        assert os.path.isdir(f"{root}/{tag}/cache") == cached
    keys = ("train_loss", "train_acc", "val_loss", "val_acc", "steps")
    assert [[r[k] for k in keys] for r in records["mem"]] == \
        [[r[k] for k in keys] for r in records["cache"]]
    with open(f"{root}/mem/sub.csv") as a, open(f"{root}/cache/sub.csv") as b:
        assert a.read() == b.read()
