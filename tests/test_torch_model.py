"""The port's ConvNeXt + deep supervision against the JAX model on the same
weights, moved by the weight carrier, in f32 on the CPU.

The JAX side runs the configuration the port mirrors: the fused block-tail
Pallas kernel (interpret mode) in the stages with C <= 512, the Pallas GELU
(interpret mode) in the last stage, whose width 640 exceeds the cutoff as
ConvNeXt-B's 1024 does."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from image_classification_tpu.models.convnext import ConvNeXt as JaxConvNeXt
from image_classification_tpu.models.deep_supervision import (
    DeepSupervisionModel as JaxDeepSupervision,
)
from image_classification_tpu.models.pretrained import export_convnext
from image_classification_tpu_torch.models import ConvNeXt, DeepSupervisionModel
from image_classification_tpu_torch.models.pretrained import (
    convnext_state_dict_from_jax,
)
from test_torch_ops import one_torch_thread  # noqa: F401  (autouse, module scope)

DEPTHS = (1, 1, 2, 1)
DIMS = (32, 64, 128, 640)
NUM_CLASSES = 7
# f32 on both sides, sums in another order through ~10 layers: measured
# max |d| 1.7e-6 over logits and aux logits of size <= 3.4; 1e-4 leaves room.
TOL = 1e-4


def jax_model(impl="pallas"):
    backbone = JaxConvNeXt(
        num_classes=NUM_CLASSES, depths=DEPTHS, dims=DIMS, dtype=jnp.float32,
        block_mlp_impl=impl, dwconv_impl="pallas", gelu_impl=impl,
    )
    return JaxDeepSupervision(backbone=backbone, num_classes=NUM_CLASSES)


def randomized_params(size):
    """flax init, then every bias, LN affine and gamma redrawn from a numpy
    seed (gamma from U(0.5, 1.5), not its 1e-6 init). The XLA-path model has
    the same parameter tree and initialises faster than interpret mode."""
    init = jax.jit(jax_model("xla").init)
    variables = init(jax.random.key(0), jnp.zeros((1, size, size, 3)))
    rng = np.random.default_rng(1)

    def redraw(path, leaf):
        name = jax.tree_util.keystr(path)
        shape = np.shape(leaf)
        if "gamma" in name:
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if "scale" in name:
            return (1 + 0.1 * rng.normal(size=shape)).astype(np.float32)
        if "bias" in name:
            return (0.1 * rng.normal(size=shape)).astype(np.float32)
        return np.asarray(leaf)

    return jax.tree_util.tree_map_with_path(redraw, variables["params"])


def port_model(params):
    model = DeepSupervisionModel(
        ConvNeXt(NUM_CLASSES, DEPTHS, DIMS, dtype=torch.float32), NUM_CLASSES)
    model.load_state_dict(convnext_state_dict_from_jax(params), strict=True)
    return model.eval()


@pytest.fixture(autouse=True)
def _interpret_kernels(monkeypatch):
    monkeypatch.setenv("IC_TPU_BLOCKMLP_INTERPRET", "1")
    monkeypatch.setenv("IC_TPU_GELU_INTERPRET", "1")


def test_weight_carrier_matches_export_and_loads_strict():
    params = randomized_params(32)
    sd = convnext_state_dict_from_jax(params)
    exported = export_convnext(params["backbone"], DEPTHS, DIMS)
    backbone = {k[len("backbone."):]: v for k, v in sd.items()
                if k.startswith("backbone.")}
    assert set(backbone) == set(exported)
    for k, v in exported.items():
        np.testing.assert_array_equal(backbone[k].numpy(), v, err_msg=k)
    for i, dim in enumerate(DIMS[1:]):
        kernel = np.asarray(params[f"aux_head{i}"]["kernel"])
        np.testing.assert_array_equal(sd[f"aux_head{i}.weight"].numpy(), kernel.T)
        assert sd[f"aux_head{i}.weight"].shape == (NUM_CLASSES, dim)
    assert len(sd) == len(backbone) + 2 * (len(DIMS) - 1)
    # flat (no deep supervision) trees carry over too
    flat = convnext_state_dict_from_jax(params["backbone"])
    ConvNeXt(NUM_CLASSES, DEPTHS, DIMS).load_state_dict(flat, strict=True)
    port_model(params)  # strict=True, aux heads included


@pytest.mark.parametrize("size", [32, 44], ids=["32px", "44px_odd_stages"])
def test_deep_supervision_logits_match_jax(size):
    """44 px gives odd stage sizes 11 -> 6 -> 3 -> 2 (downsamples pad the
    bottom/right, flax SAME)."""
    params = randomized_params(size)
    x = np.random.default_rng(size).normal(size=(2, size, size, 3)).astype(np.float32)
    ref = jax.jit(lambda p, v: jax_model().apply({"params": p}, v))(params, x)
    with torch.no_grad():
        ours = port_model(params)(torch.from_numpy(x))
    assert len(ours) == len(ref) == 4
    for name, a, b in zip(("logits", "aux0", "aux1", "aux2"), ours, ref):
        b = np.asarray(b)
        assert a.shape == b.shape == (2, NUM_CLASSES)
        np.testing.assert_allclose(a.numpy(), b, rtol=TOL, atol=TOL, err_msg=name)
