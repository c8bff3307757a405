"""Hard synthetic benchmark task with a controllable Bayes error, port of
``image_classification_tpu/data/synthetic_hard.py``.

Confusable classes (groups sharing a family texture, told apart by a weaker
class signature), per-image similarity transforms, illumination, occlusion,
pixel noise, peer mixing and group-confined label noise; see the JAX
module's docstring for the design and ``RESULTS.md`` for its calibration.
The rendering is the JAX package's numpy, draw for draw, so the images equal
its arrays before encoding. The JPEGs are written at ``spec.jpeg_quality``
through ``data/native.py:encode_rgb`` (cv2.imwrite's settings where the host
library is libjpeg) and the CSVs through ``data/manifest.py:write_csv``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np

from image_classification_tpu_torch.data.manifest import write_csv
from image_classification_tpu_torch.data.synthetic import longtail_labels, write_jpegs


@dataclasses.dataclass(frozen=True)
class HardTaskSpec:
    """Difficulty knobs. Defaults are the calibrated "reference-hard" point
    (tuned so the V4 recipe lands ~90-92% fold-val accuracy, see
    RESULTS.md)."""

    num_classes: int = 44
    group_size: int = 4
    k_family: int = 6  # sinusoids in the shared (easy) family texture
    k_class: int = 8  # sinusoids in the per-class (hard) signature
    family_amp: float = 40.0  # family texture amplitude (pixel units)
    signal: float = 0.45  # class signature amplitude relative to family
    mix_max: float = 0.5  # peer-signature blend upper bound, m~U(0,mix_max)
    noise_sigma: float = 14.0  # additive Gaussian pixel noise
    label_noise: float = 0.05  # flip-to-group-peer rate (val ceiling ~1-rho)
    rot_deg: float = 25.0  # rotation jitter, degrees
    scale_jitter: float = 0.25  # log-uniform scale in [1-s, 1+s]
    trans_frac: float = 0.15  # translation as fraction of image size
    gain_jitter: float = 0.3  # multiplicative illumination in [1-g, 1+g]
    bias_jitter: float = 20.0  # additive illumination offset
    occl_prob: float = 0.5  # probability of one occluding noise patch
    occl_frac: tuple[float, float] = (0.1, 0.3)  # patch area fraction range
    jpeg_quality: int = 90

    def bayes_ceiling(self) -> float:
        """Upper bound on accuracy vs recorded labels from label noise alone
        (signal ambiguity from ``mix_max`` lowers the real ceiling further).
        """
        return 1.0 - self.label_noise

    @property
    def n_groups(self) -> int:
        return (self.num_classes + self.group_size - 1) // self.group_size

    def group_of(self, cls: np.ndarray) -> np.ndarray:
        return np.asarray(cls) // self.group_size


def _draw_bank(
    rng: np.random.Generator, k: int, fmin: float, fmax: float
) -> np.ndarray:
    """K random 2-D sinusoids: columns (u, v, phase, amp), frequencies in
    cycles-per-unit-image, random orientation."""
    freq = rng.uniform(fmin, fmax, size=k)
    theta = rng.uniform(0, 2 * np.pi, size=k)
    u = freq * np.cos(theta)
    v = freq * np.sin(theta)
    phase = rng.uniform(0, 2 * np.pi, size=k)
    amp = rng.uniform(0.6, 1.4, size=k)
    amp = amp / np.sqrt(np.sum(amp**2) / k)  # normalize bank RMS
    return np.stack([u, v, phase, amp], axis=1)  # (K, 4)


def build_prototypes(spec: HardTaskSpec, seed: int = 0) -> dict:
    """Per-group family banks, per-class signature banks, per-group colors."""
    rng = np.random.default_rng(seed)
    fam = np.stack(
        [_draw_bank(rng, spec.k_family, 0.5, 4.0) for _ in range(spec.n_groups)]
    )
    sig = np.stack(
        [_draw_bank(rng, spec.k_class, 6.0, 14.0) for _ in range(spec.num_classes)]
    )
    # Group color mix: per-channel coefficients in [0.5, 1.0] with random
    # sign structure; identical within a group so color never separates
    # classes inside a group.
    colors = rng.uniform(0.5, 1.0, size=(spec.n_groups, 3)) * rng.choice(
        [-1.0, 1.0], size=(spec.n_groups, 3)
    )
    return {"family": fam, "signature": sig, "colors": colors}


def _render_fields(
    banks: np.ndarray,  # (N, K, 4) per-image sinusoid banks (u, v, phase, amp)
    transforms: np.ndarray,  # (N, 6) affine rows [r00, r01, tx, r10, r11, ty]
    h: int,
    w: int,
) -> np.ndarray:
    """Evaluate the per-image sum of sinusoids at affine-transformed
    coordinates, separably. For a sinusoid a*sin(2pi(u x' + v y') + p) with
    (x', y') affine in (x, y):  u x' + v y' = u' x + v' y + d, so the
    transformed pattern is a sinusoid with rotated/scaled frequency and
    shifted phase — no warping or per-pixel transcendentals needed."""
    n, k, _ = banks.shape
    u, v, phase, amp = banks[..., 0], banks[..., 1], banks[..., 2], banks[..., 3]
    r00, r01, tx = transforms[:, 0:1], transforms[:, 1:2], transforms[:, 2:3]
    r10, r11, ty = transforms[:, 3:4], transforms[:, 4:5], transforms[:, 5:6]
    up = u * r00 + v * r10  # (N, K) cycles per unit-x
    vp = u * r01 + v * r11
    pp = phase + 2 * np.pi * (u * tx + v * ty)
    # normalized coordinates in [0, 1)
    x = (np.arange(w, dtype=np.float64) + 0.5) / w
    y = (np.arange(h, dtype=np.float64) + 0.5) / h
    ax = 2 * np.pi * up[..., None] * x  # (N, K, W)
    by = 2 * np.pi * vp[..., None] * y + pp[..., None]  # (N, K, H)
    # sin(ax + by + p) = sin(ax)cos(by+p) + cos(ax)sin(by+p)
    out = np.einsum(
        "nkh,nkw->nhw", amp[..., None] * np.cos(by), np.sin(ax), optimize=True
    )
    out += np.einsum(
        "nkh,nkw->nhw", amp[..., None] * np.sin(by), np.cos(ax), optimize=True
    )
    return out.astype(np.float32)


def _sample_transforms(
    rng: np.random.Generator, n: int, spec: HardTaskSpec
) -> np.ndarray:
    ang = np.deg2rad(rng.uniform(-spec.rot_deg, spec.rot_deg, size=n))
    scale = np.exp(
        rng.uniform(
            np.log(1 - spec.scale_jitter), np.log(1 + spec.scale_jitter), size=n
        )
    )
    c, s = np.cos(ang) * scale, np.sin(ang) * scale
    tx = rng.uniform(-spec.trans_frac, spec.trans_frac, size=n)
    ty = rng.uniform(-spec.trans_frac, spec.trans_frac, size=n)
    return np.stack([c, -s, tx, s, c, ty], axis=1)


def hard_synthetic_images(
    labels: np.ndarray,
    spec: HardTaskSpec,
    native_size: tuple[int, int] = (60, 80),
    seed: int = 0,
    proto_seed: int = 0,
    chunk: int = 512,
) -> np.ndarray:
    """Render uint8 RGB images for generative classes ``labels``.

    ``proto_seed`` fixes the class prototypes (shared between train and
    test splits); ``seed`` drives everything per-image.
    """
    h, w = native_size
    spec_groups = spec.group_of(labels)
    protos = build_prototypes(spec, proto_seed)
    rng = np.random.default_rng(seed)
    n = len(labels)
    labels = np.asarray(labels)

    # Per-image nuisance draws (all up front, so chunking cannot change
    # the stream for a given seed).
    transforms = _sample_transforms(rng, n, spec)
    peer_off = rng.integers(1, spec.group_size, size=n)
    peers = spec_groups * spec.group_size + (
        (labels - spec_groups * spec.group_size + peer_off) % spec.group_size
    )
    peers = np.minimum(peers, spec.num_classes - 1)
    mix = rng.uniform(0.0, spec.mix_max, size=n)
    gain = rng.uniform(1 - spec.gain_jitter, 1 + spec.gain_jitter, size=n)
    bias = rng.uniform(-spec.bias_jitter, spec.bias_jitter, size=n)
    occl_on = rng.random(n) < spec.occl_prob
    occl_fr = rng.uniform(*spec.occl_frac, size=n)
    occl_cx = rng.random(n)
    occl_cy = rng.random(n)
    noise_seeds = rng.integers(0, 2**63 - 1, size=n)

    sig_amp = spec.family_amp * spec.signal
    images = np.empty((n, h, w, 3), dtype=np.uint8)
    for lo in range(0, n, chunk):
        sl = slice(lo, min(lo + chunk, n))
        m = mix[sl][:, None, None]
        fam = protos["family"][spec_groups[sl]]  # (c, Kf, 4)
        own = protos["signature"][labels[sl]].copy()  # (c, Kc, 4)
        peer = protos["signature"][peers[sl]].copy()
        own[..., 3] *= (sig_amp / spec.family_amp) * (1 - m[..., 0])
        peer[..., 3] *= (sig_amp / spec.family_amp) * m[..., 0]
        banks = np.concatenate([fam, own, peer], axis=1)
        field = _render_fields(banks, transforms[sl], h, w)  # (c, H, W)
        field *= spec.family_amp * gain[sl][:, None, None]
        field += bias[sl][:, None, None]
        col = protos["colors"][spec_groups[sl]]  # (c, 3)
        img = 127.0 + field[..., None] * col[:, None, None, :]
        for j in range(img.shape[0]):
            i = lo + j
            r = np.random.default_rng(noise_seeds[i])
            if occl_on[i]:
                ph = max(2, int(h * np.sqrt(occl_fr[i])))
                pw = max(2, int(w * np.sqrt(occl_fr[i])))
                y0 = int(occl_cy[i] * max(1, h - ph))
                x0 = int(occl_cx[i] * max(1, w - pw))
                img[j, y0 : y0 + ph, x0 : x0 + pw, :] = r.uniform(
                    40, 215, size=(ph, pw, 3)
                )
            img[j] += r.normal(0, spec.noise_sigma, size=(h, w, 3))
        images[sl] = np.clip(img, 0, 255).astype(np.uint8)
    return images


def apply_label_noise(
    labels: np.ndarray, spec: HardTaskSpec, seed: int = 0
) -> np.ndarray:
    """Flip a ``label_noise`` fraction of labels to a uniform same-group
    peer (never out of group, never identity). Returns the noisy labels."""
    rng = np.random.default_rng(seed)
    labels = np.asarray(labels).copy()
    flip = rng.random(len(labels)) < spec.label_noise
    groups = spec.group_of(labels)
    off = rng.integers(1, spec.group_size, size=len(labels))
    peers = groups * spec.group_size + (
        (labels - groups * spec.group_size + off) % spec.group_size
    )
    peers = np.minimum(peers, spec.num_classes - 1)
    # guard degenerate tail group of size 1
    flip &= peers != labels
    labels[flip] = peers[flip]
    return labels


def make_hard_synthetic_dataset(root: str, n_train: int = 2000, n_test: int = 500,
                                spec: HardTaskSpec | None = None,
                                native_size: tuple[int, int] = (60, 80), seed: int = 0,
                                imbalance: float = 50.0, write_images: bool = True) -> dict:
    """Create the hard benchmark on disk in the reference's layout.

    train.csv carries the NOISY labels (what the K-fold validates against,
    so fold-val accuracy is ceilinged at ~1-label_noise); the clean
    generative labels are returned and written to ``train_clean.csv`` /
    ``test_labels.csv``. Besides the JAX package's keys, the result has
    ``seconds``: the wall time spent rendering and encoding."""
    spec = spec or HardTaskSpec()
    os.makedirs(root, exist_ok=True)
    train_dir = os.path.join(root, "train")
    test_dir = os.path.join(root, "test")
    clean_labels = longtail_labels(n_train, spec.num_classes, seed, imbalance)
    rng = np.random.default_rng(seed + 7)
    rng.shuffle(clean_labels)  # decorrelate class from file order
    test_labels = longtail_labels(n_test, spec.num_classes, seed + 1, imbalance)
    noisy_labels = apply_label_noise(clean_labels, spec, seed + 2)
    train_ids = [f"tr{i:05d}" for i in range(n_train)]
    test_ids = [f"te{i:05d}" for i in range(n_test)]
    seconds = {"render": 0.0, "encode": 0.0}
    if write_images:
        for ids, labs, d, s in ((train_ids, clean_labels, train_dir, seed + 10),
                                (test_ids, test_labels, test_dir, seed + 11)):
            t0 = time.perf_counter()
            imgs = hard_synthetic_images(labs, spec, native_size, seed=s, proto_seed=seed)
            t1 = time.perf_counter()
            write_jpegs(d, ids, imgs, spec.jpeg_quality)
            seconds["render"] += t1 - t0
            seconds["encode"] += time.perf_counter() - t1
    train_csv = os.path.join(root, "train.csv")
    test_csv = os.path.join(root, "sample_submission.csv")
    write_csv(train_csv, {"id": train_ids, "target": noisy_labels.tolist()})
    write_csv(os.path.join(root, "train_clean.csv"),
              {"id": train_ids, "target": clean_labels.tolist()})
    write_csv(test_csv, {"id": test_ids, "predict": [0] * n_test})
    write_csv(os.path.join(root, "test_labels.csv"),
              {"id": test_ids, "target": test_labels.tolist()})
    with open(os.path.join(root, "task_spec.json"), "w") as f:
        json.dump({**dataclasses.asdict(spec), "seed": seed, "imbalance": imbalance,
                   "n_train": n_train, "n_test": n_test,
                   "bayes_ceiling": spec.bayes_ceiling()}, f, indent=1)
    return {"train_dir": train_dir, "test_dir": test_dir, "train_csv": train_csv,
            "test_csv": test_csv, "train_labels": noisy_labels,
            "train_labels_clean": clean_labels, "test_labels": test_labels,
            "spec": spec, "seconds": seconds}
