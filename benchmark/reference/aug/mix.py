# Frozen copy of image_classification_tpu_torch/aug/mix.py for the benchmark's
# reference: the reference may not import the program it judges.
"""In-batch MixUp / CutMix with soft labels, port of
``image_classification_tpu/aug/mix.py``.

Per sample: a Bernoulli(prob) gate (unmixed samples keep one-hot labels), a
50/50 choice of mixup or cutmix, a partner from one permutation of the
batch; mixup lerps pixels and labels by lambda ~ Beta(a, a); cutmix pastes
the partner's centred box of relative size sqrt(1 - lambda), clipped to the
image, and re-derives lambda from the exact pasted area. Mixing after
Normalize equals mixing before it (both ops commute with an affine map).

Under data parallelism the partner permutation is one of the global batch
(``jax.random.permutation(k_perm, B)`` over the sharded batch): each rank
holds its rows' draws, whose partners index the global batch, and gathers
the images and one-hot labels of every rank to take them.

Beta: ``torch.distributions.Beta`` and ``torch._standard_gamma`` take no
generator, so :func:`sample_beta` draws on the caller's ``torch.Generator``
with Marsaglia and Tsang's gamma sampler, written without a data-dependent
loop: 16 candidates per draw, the first accepted one kept. Each candidate is
accepted with probability above 0.95 (shape >= 1), so all 16 fail with
probability below 1e-20; then the sampler returns the shape's mean-like
value ``d`` of the method. Shapes below 1 use Gamma(a) = Gamma(a + 1) *
U^(1/a), and the Beta is formed in log space, as ``jax.random.beta`` does, so
Beta(0.2, 0.2)'s tiny gammas do not underflow to 0/0.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from benchmark.reference.aug.draws import bernoulli, randint, uniform
from benchmark.reference.aug.warp import all_gather_rows

_GAMMA_CANDIDATES = 16


class MixCfg(NamedTuple):
    mixup_alpha: float = 0.2
    cutmix_alpha: float = 1.0
    prob: float = 0.5
    num_classes: int = 44


def one_hot_labels(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """f32 one-hot rows (compared against an arange: no check that reads the
    labels back from the card)."""
    classes = torch.arange(num_classes, device=labels.device)
    return (labels.reshape(-1, 1) == classes).to(torch.float32)


def _log_gamma_sample(gen, alpha: float, n: int) -> torch.Tensor:
    """log of n draws of Gamma(alpha, 1)."""
    a = alpha + 1.0 if alpha < 1.0 else alpha
    d = a - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    x = torch.randn((n, _GAMMA_CANDIDATES), generator=gen, device=gen.device)
    u = 1.0 - uniform(gen, (n, _GAMMA_CANDIDATES))
    v = (1.0 + c * x) ** 3
    log_v = torch.log(torch.clamp(v, min=1e-30))
    ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v + d * log_v)
    first = ok.to(torch.int32).argmax(dim=1, keepdim=True)
    log_g = torch.where(ok.any(dim=1), math.log(d) + torch.gather(log_v, 1, first)[:, 0],
                        math.log(d))
    if alpha < 1.0:
        boost = 1.0 - uniform(gen, (n,))
        log_g = log_g + torch.log(boost) / alpha
    return log_g


def sample_beta(gen, alpha: float, n: int) -> torch.Tensor:
    """n draws of Beta(alpha, alpha) on ``gen``'s device, f32; ones when
    ``alpha <= 0`` (the JAX module's convention)."""
    if alpha <= 0:
        return torch.ones(n, device=gen.device)
    lx = _log_gamma_sample(gen, alpha, n)
    ly = _log_gamma_sample(gen, alpha, n)
    return torch.exp(lx - torch.logaddexp(lx, ly))


class MixDraws(NamedTuple):
    partner: torch.Tensor     # (B,) a permutation of the batch
    do_mix: torch.Tensor      # (B,) bool
    use_mixup: torch.Tensor   # (B,) bool, Bernoulli(0.5); cutmix where False
    lam_mixup: torch.Tensor   # (B,) Beta(mixup_alpha)
    lam_cutmix: torch.Tensor  # (B,) Beta(cutmix_alpha)
    cx: torch.Tensor          # (B,) box centre column in [0, W)
    cy: torch.Tensor          # (B,) box centre row in [0, H)


def draw_mix(gen, shape, cfg: MixCfg) -> MixDraws:
    """Draws for images of ``shape`` (B, H, W, C)."""
    B, H, W = shape[:3]
    return MixDraws(
        uniform(gen, (B,)).argsort(),
        bernoulli(gen, cfg.prob, B),
        bernoulli(gen, 0.5, B),
        sample_beta(gen, cfg.mixup_alpha, B),
        sample_beta(gen, cfg.cutmix_alpha, B),
        randint(gen, 0, W, (B,)),
        randint(gen, 0, H, (B,)))


def mixup_cutmix_batch(images: torch.Tensor, labels: torch.Tensor, d: MixDraws,
                       cfg: MixCfg, group=None) -> tuple[torch.Tensor, torch.Tensor]:
    """images (B, H, W, C) float, labels (B,) int -> (mixed images, f32 soft
    labels (B, num_classes)). With a data-parallel ``group`` these are this
    rank's rows and ``d`` their draws; ``d.partner`` indexes the global
    batch, the rows of every rank of ``group`` in rank order."""
    B, H, W, _ = images.shape
    onehot = one_hot_labels(labels, cfg.num_classes)
    images2 = all_gather_rows(images, group)[d.partner]
    onehot2 = all_gather_rows(onehot, group)[d.partner]
    use_mixup = d.use_mixup & (cfg.mixup_alpha > 0)

    lam_m = d.lam_mixup[:, None]
    lam_img = d.lam_mixup.to(images.dtype)[:, None, None, None]
    mixed_img = images * lam_img + images2 * (1.0 - lam_img)
    mixed_lab = onehot * lam_m + onehot2 * (1.0 - lam_m)

    cut_rat = torch.sqrt(1.0 - d.lam_cutmix)
    cut_w = (W * cut_rat).to(torch.int32)      # truncates toward zero
    cut_h = (H * cut_rat).to(torch.int32)
    x1 = torch.clamp(d.cx - cut_w // 2, 0, W)
    y1 = torch.clamp(d.cy - cut_h // 2, 0, H)
    x2 = torch.clamp(d.cx + cut_w // 2, 0, W)
    y2 = torch.clamp(d.cy + cut_h // 2, 0, H)
    xs = torch.arange(W, device=images.device)[None, None, :]
    ys = torch.arange(H, device=images.device)[None, :, None]
    in_box = ((xs >= x1[:, None, None]) & (xs < x2[:, None, None])
              & (ys >= y1[:, None, None]) & (ys < y2[:, None, None]))
    cut_img = torch.where(in_box[..., None], images2, images)
    # exact-area lambda correction
    lam_exact = 1.0 - ((x2 - x1) * (y2 - y1)).to(torch.float32) / float(W * H)
    cut_lab = onehot * lam_exact[:, None] + onehot2 * (1.0 - lam_exact[:, None])

    sel_img = torch.where(use_mixup[:, None, None, None], mixed_img, cut_img)
    sel_lab = torch.where(use_mixup[:, None], mixed_lab, cut_lab)
    out_img = torch.where(d.do_mix[:, None, None, None], sel_img, images)
    out_lab = torch.where(d.do_mix[:, None], sel_lab, onehot)
    return out_img, out_lab
