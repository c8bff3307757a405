"""How far EfficientNet's bf16 step on the card is from the f32 step on
the host, beside what small input noise does to the f32 step.

    PYTHONPATH=. python image_classification_tpu_torch/tools/effnet_precision.py

For ``configs/v1_effb0.json`` (B0 at 60x80) and ``configs/v3_1.json``
(V2-S at 224), on ``chip_smoke.py``'s inputs (4 uint8 60x80 images, the aug
and mix run once on the host in f32, the drop masks drawn once) and seeded
weights, the gradient half of a train step (``accumulate_grads``: train
mode, batch statistics) in these variants, each against the host in f32:
the card in f32; the card in bf16; the card in bf16 with every conv and
matmul taking f32 inputs (the weights and activations are cast up at the
op, the BatchNorm and silu stay bf16-rounded); and the host in f32 with the
inputs times ``1 + eps N(0, 1)``, eps 1e-3 and 1e-2. It prints one JSON
line a config: the loss's relative difference, the rel. L2 of the running
statistics' change over the step and of the gradients, per variant. Needs
one CUDA card.
"""
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, REPO)


def main() -> int:
    import torch

    import chip_smoke as cs
    from image_classification_tpu_torch.core.config import load_config
    from image_classification_tpu_torch.models import layers
    from image_classification_tpu_torch.models.layers import drop_sites
    from image_classification_tpu_torch.train.loss import build_criterion
    from image_classification_tpu_torch.train.step import (
        accumulate_grads,
        draw_train_step,
        make_batch_augment,
    )
    from image_classification_tpu_torch.aug.draws import draws_to

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    conv_bf16 = layers.conv_nhwc

    def conv_f32_inputs(x, weight, stride=1, groups=1):
        return conv_bf16(x.float(), weight.float(), stride, groups).to(x.dtype)

    for config, over in (("v1_effb0.json", []), ("v3_1.json", cs.V31_OVERRIDES)):
        cfg = load_config(os.path.join(REPO, "configs", config), over).replace(
            batch_size=cs.REF_BATCH)
        cfg32 = cfg.replace(compute_dtype="float32")
        images, labels = cs.train_inputs(cfg, cs.REF_BATCH, seed=13)
        probe = cs.train_model(cfg32, "cpu").module
        draws = draw_train_step(torch.Generator().manual_seed(14), tuple(images.shape),
                                cfg, drop_sites(probe))
        x, targets = make_batch_augment(cfg32)({"image": images, "label": labels},
                                               draws=draws)

        def run(c, device, inputs, f32_convs=False):
            model = cs.train_model(c, device).module
            stats0 = {k: v.clone() for k, v in model.named_buffers()}
            layers.conv_nhwc = conv_f32_inputs if f32_convs else conv_bf16
            try:
                grads, m = accumulate_grads(model, c, build_criterion(c), inputs.to(device),
                                            targets.to(device), labels.to(device),
                                            drop=draws_to(draws.drop, device))
            finally:
                layers.conv_nhwc = conv_bf16
            return {"loss": float(m["loss"]),
                    "stats": [(v - stats0[k]).cpu() for k, v in model.named_buffers()],
                    "grads": [g.float().cpu() for g in grads]}

        host = run(cfg32, "cpu", x)
        gen = torch.Generator().manual_seed(15)
        variants = {
            "card_f32": run(cfg32, "cuda", x),
            "card_bf16": run(cfg, "cuda", x),
            "card_bf16_f32_convs": run(cfg, "cuda", x, f32_convs=True),
            **{f"host_f32_input_noise_{eps:g}": run(cfg32, "cpu", x * (1 + eps * torch.randn(
                x.shape, generator=gen))) for eps in (1e-3, 1e-2)},
        }
        out = {"config": config, "model": cfg.model_name, "device": cs.nvidia_smi()}
        for name, v in variants.items():
            out[name] = {"loss_rel": abs(v["loss"] - host["loss"]) / abs(host["loss"]),
                         "stats_rel_l2": cs.rel_l2(v["stats"], host["stats"]),
                         "grad_rel_l2": cs.rel_l2(v["grads"], host["grads"])}
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
