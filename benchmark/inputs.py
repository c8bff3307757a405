"""What the benchmark makes from ``--seed`` and hands to both the program
and the reference: the images and labels, the weights, and the seeds of
each draw. Both sides get the same tensors; neither makes its own.

The images are the port's synthetic set (``data/synthetic.py``: a
per-class sinusoid pattern plus N(0, 10) noise, clipped to uint8, with a
long-tailed label draw), made in bulk on the device instead of its
per-image loop. The weights are made on the device in one draw: each
conv or linear weight N(0, 1/fan_in) clipped at two deviations, biases and
LayerNorm shifts N(0, 0.02^2), LayerNorm scales 1 + N(0, 0.1^2), and the
layer scale 0.5 + N(0, 0.1^2) clipped to [0.3, 0.7], so that every block
adds to its residual stream (the recipe's 1e-6 layer scale would leave the
blocks out of every number compared); BatchNorm's scales and shifts as
LayerNorm's, its running statistics as initialised."""

from __future__ import annotations

import numpy as np
import torch


def derive_seed(*words: int | str) -> int:
    """A 63-bit seed from integers and strings, through numpy's
    SeedSequence (a string counts as the integer of its UTF-8 bytes)."""
    ints = [w if isinstance(w, int) else int.from_bytes(w.encode(), "little")
            for w in words]
    return int(np.random.SeedSequence(ints).generate_state(1, np.uint64)[0] >> 1)


def longtail_labels(n: int, num_classes: int, seed: int,
                    imbalance: float = 50.0) -> np.ndarray:
    """Every class once, then the rest drawn with p ~ exp(-log(imbalance)
    * k / (K - 1)): the most common class ~50x the rarest."""
    rng = np.random.default_rng(seed)
    w = np.exp(-np.log(imbalance) * np.arange(num_classes) / (num_classes - 1))
    rest = rng.choice(num_classes, size=max(n - num_classes, 0), p=w / w.sum())
    return np.concatenate([np.arange(num_classes), rest])[:n].astype(np.int64)


def class_patterns(num_classes: int, hw: tuple[int, int]) -> np.ndarray:
    """(K, h, w, 3) f32: each class' noiseless image."""
    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = np.empty((num_classes, h, w, 3), np.float32)
    for c in range(num_classes):
        phase = 2 * np.pi * c / 44.0
        fx, fy = 1 + c % 7, 1 + c % 5
        base = (127 + 60 * np.sin(2 * np.pi * fx * xx / w + phase)
                + 60 * np.cos(2 * np.pi * fy * yy / h + phase))
        out[c] = np.stack([base, np.roll(base, c % h, axis=0),
                           np.roll(base, c % w, axis=1)], axis=-1)
    return out


def synthetic_images(labels: np.ndarray, hw: tuple[int, int], num_classes: int,
                     seed: int, device: torch.device, chunk: int = 4096) -> np.ndarray:
    """uint8 (N, h, w, 3) host images for ``labels``, made on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    base = torch.from_numpy(class_patterns(num_classes, hw)).to(device)
    lab = torch.from_numpy(labels).to(device)
    out = torch.empty((len(labels), *hw, 3), dtype=torch.uint8)
    for s in range(0, len(labels), chunk):
        rows = lab[s:s + chunk]
        noise = torch.randn((len(rows), *hw, 3), generator=gen, device=device)
        img = (base[rows] + 10.0 * noise).clamp_(0.0, 255.0).to(torch.uint8)
        out[s:s + len(rows)] = img.cpu()
    return out.numpy()


def dataset(traffic: dict, cfg: dict, seed: int, device: torch.device) -> dict:
    """The train and test sets of a cell: uint8 images and labels."""
    hw = tuple(cfg["native_size"])
    k = cfg["num_classes"]
    out = {}
    for split in ("train", "test"):
        n = traffic[f"n_{split}"]
        labels = longtail_labels(n, k, derive_seed(seed, split, "labels"))
        out[split] = {"labels": labels,
                      "images": synthetic_images(labels, hw, k,
                                                 derive_seed(seed, split, "images"), device)}
    return out


def make_weights(spec, seed: int, device: torch.device) -> dict[str, torch.Tensor]:
    """f32 tensors by name for ``spec`` (a reference model's ``param_spec``),
    from one normal draw on ``device``."""
    total = sum(int(np.prod(shape)) for _, shape, _, _ in spec)
    gen = torch.Generator(device=device).manual_seed(seed)
    z = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape, kind, fan_in in spec:
        n = int(np.prod(shape))
        v = z[at:at + n].view(shape)
        at += n
        if kind == "matrix":
            t = v.clamp(-2.0, 2.0) * (1.0 / np.sqrt(fan_in))
        elif kind == "ln_w":
            t = 1.0 + 0.1 * v
        elif kind == "gamma":
            t = 0.5 + 0.1 * v.clamp(-2.0, 2.0)
        elif kind == "zeros":     # BatchNorm's running mean, as initialised
            t = torch.zeros_like(v)
        elif kind == "ones":      # and its running variance
            t = torch.ones_like(v)
        else:   # bias, ln_b
            t = 0.02 * v
        out[name] = t
    return out
