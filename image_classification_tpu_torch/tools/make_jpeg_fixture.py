"""Write the JPEG fixture that the card's decode is held against.

    PYTHONPATH=. python image_classification_tpu_torch/tools/make_jpeg_fixture.py

Writes ``image_classification_tpu_torch/data/fixtures/jpeg/``: five smooth
60x80 images and one 30x40 image (decoded with a resize to 60x80) as JPEGs
through ``data/native.py:encode_rgb`` (q90, and q75 for one), a corrupt
``.jpg``, a small PNG, and ``expected.npz``: the fixture's ids in
``ids`` (``missing`` has no file) and in ``images`` what
``data/source.py:ImageSource`` decodes for the ids other than the PNG, at
60x80 with the black fallback. Run it on a host whose JPEG library is
libjpeg (``native.recipe().name``): ``tests/test_torch_data.py`` holds the
committed bytes to the JAX package's ``ImageSource``.
"""
from __future__ import annotations

import os
import shutil
import struct
import zlib

import numpy as np

from image_classification_tpu_torch.data import native
from image_classification_tpu_torch.data.source import ImageSource

FIXTURE_DIR = os.path.join(os.path.dirname(native.__file__), "fixtures", "jpeg")
NATIVE = (60, 80)
# id -> (height, width, quality); every one a smooth image
JPEGS = {"good0": (60, 80, 90), "good1": (60, 80, 90), "good2": (60, 80, 90),
         "good3": (60, 80, 90), "good4": (60, 80, 75), "odd": (30, 40, 90)}
DECODED_IDS = (*JPEGS, "corrupt", "missing")
PNG_ID = "pic"


def smooth_image(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """A sum of two random plane waves a channel: smooth, so it compresses."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    chans = []
    for _ in range(3):
        f = rng.uniform(0.5, 2.5, size=(2, 2))
        ph = rng.uniform(0, 2 * np.pi, size=2)
        chans.append(127 + 60 * np.sin(2 * np.pi * (f[0, 0] * xx / w + f[0, 1] * yy / h) + ph[0])
                     + 40 * np.cos(2 * np.pi * (f[1, 0] * xx / w - f[1, 1] * yy / h) + ph[1]))
    return np.clip(np.stack(chans, -1), 0, 255).astype(np.uint8)


def png_bytes(rgb: np.ndarray) -> bytes:
    """A minimal 8-bit RGB PNG of ``rgb``."""
    h, w, _ = rgb.shape

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 9)) + chunk(b"IEND", b""))


def main() -> None:
    if native.recipe().name != "libjpeg":
        raise SystemExit("the fixture's expected bytes are libjpeg's; this host "
                         f"builds on {native.recipe().name}")
    shutil.rmtree(FIXTURE_DIR, ignore_errors=True)
    os.makedirs(FIXTURE_DIR)
    rng = np.random.default_rng(2026)
    for id_, (h, w, q) in JPEGS.items():
        native.encode_rgb(os.path.join(FIXTURE_DIR, f"{id_}.jpg"), smooth_image(rng, h, w), q)
    with open(os.path.join(FIXTURE_DIR, "corrupt.jpg"), "wb") as f:
        f.write(b"\xff\xd8\xff\xe0 not a jpeg after its first marker")
    with open(os.path.join(FIXTURE_DIR, f"{PNG_ID}.png"), "wb") as f:
        f.write(png_bytes(smooth_image(rng, 8, 8)))
    images = ImageSource(FIXTURE_DIR, list(DECODED_IDS), NATIVE).images
    np.savez_compressed(os.path.join(FIXTURE_DIR, "expected.npz"),
                        ids=np.array(DECODED_IDS), images=images)
    total = sum(os.path.getsize(os.path.join(FIXTURE_DIR, p)) for p in os.listdir(FIXTURE_DIR))
    print(f"{FIXTURE_DIR}: {len(os.listdir(FIXTURE_DIR))} files, {total} bytes")


if __name__ == "__main__":
    main()
