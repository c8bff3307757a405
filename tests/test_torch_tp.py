"""Tensor parallelism (``parallel/shardings.py``) against the JAX package's
``mesh_model=2``: the split of every parameter against JAX's ``param_spec``
by path, then one train step and one eval step on 2 gloo ranks of a (data
1, model 2) mesh against JAX's step on the same mesh of 2 virtual CPU
devices, for ``test_torch_train``'s ConvNeXt (deep-supervised) and a
2-block ViT of ``test_torch_vit``'s size, from the same weights, moments
and batch (aug off, accumulation 2, clip on). The port's state is gathered
whole from the shards before it is compared. The ConvNeXt's ranks run the
step under each ``block_remat`` mode in turn, from the same state: ``dots``
and ``full`` against JAX's step with the backbone in the same mode, and
against the port's ``none`` to the bit; each mode's kernel entries
against ``tools/parallel_check.py:model_launches``, and the model group's
sums it runs (``dots`` none in its recompute, ``full`` one more a block).

Tolerances: ``test_torch_ddp.py``'s (the loss to 1e-5 relative; parameters
and EMA to 1e-3 of lr, as Adam's m / sqrt(v) magnifies f32 rounding where v
is small; eval sums to 1e-5, counts exactly).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from image_classification_tpu.models.factory import ModelBundle as JaxBundle
from image_classification_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from image_classification_tpu.parallel.mesh import build_mesh as jax_build_mesh
from image_classification_tpu.parallel.shardings import param_spec as jax_param_spec
from image_classification_tpu.train import loss as jax_loss
from image_classification_tpu.train.fused import _rebuild_opt_state
from image_classification_tpu.train.optim import build_optimizer as jax_build_opt
from image_classification_tpu.train.step import make_eval_step as jax_make_eval
from image_classification_tpu.train.step import make_train_step as jax_make_train
from image_classification_tpu.train.train_state import create_train_state as jax_create
from image_classification_tpu_torch.models.convnext import CONVNEXT_CONFIGS
from image_classification_tpu_torch.models.factory import ModelBundle
from image_classification_tpu_torch.models.pretrained import (
    state_dict_from_jax,
    train_state_from_jax,
)
from image_classification_tpu_torch.parallel.shardings import param_spec
from image_classification_tpu_torch.tools.parallel_check import expected_launches

import test_torch_train as tt
import test_torch_vit as tv
from test_torch_ddp import as_port, check_eval, on_mesh, run_port
from test_torch_ops import one_torch_thread  # noqa: F401  (autouse, module scope)
from torch_spawn import load_ranks, remat_worker, run_ranks

B = 8
MODES = ("none", "dots", "full")


def jax_code(spec) -> int:
    """0: replicated; 1: split on the output dim (column-parallel kernel or
    its bias); 2: split on the input dim (row-parallel kernel)."""
    return {(): 0, (None, "model"): 1, ("model",): 1, ("model", None): 2}[tuple(spec)]


def port_code(dim) -> int:
    return 0 if dim is None else (2 if dim == 1 else 1)


def vit_params():
    return tv.init(tv.jax_vit(2), tv.inputs())["params"]


@pytest.fixture(scope="module")
def both_params():
    return {"convnext": tt.randomized_params(tt.SIZE), "vit": vit_params()}


@pytest.mark.parametrize("model", ["convnext", "vit"])
@pytest.mark.parametrize("size", [2, 3, 4])
def test_param_spec_matches_jax_by_path(both_params, model, size):
    """Each parameter splits where JAX's spec splits its leaf (filled with
    the spec's code and carried to the port's names), and nowhere else."""
    params = both_params[model]
    codes = jax.tree_util.tree_map_with_path(
        lambda path, leaf: np.full(np.shape(leaf), jax_code(jax_param_spec(path, leaf, size)),
                                   np.float32), jax.tree.map(np.asarray, params))
    sd = state_dict_from_jax(codes)
    split = 0
    for name, t in sd.items():
        want = port_code(param_spec(name, tuple(t.shape), size))
        assert bool((t == want).all()), (name, want, t.flatten()[:3])
        split += want > 0
    assert (split > 0) == (size != 3)   # 3 divides no MLP width here


def vit_start(jcfg, count=30):
    """The 2-block ViT with randomized weights, an EMA off them and random
    Adam moments (``nu >= mu^2``), as ``test_torch_train.start_states``."""
    params = vit_params()
    rng = np.random.default_rng(0)
    ema = jax.tree.map(lambda p, n: np.asarray(p) + n, params, tt._tree(rng, params, 0.01))
    mu = tt._tree(rng, params, 1e-3)
    nu = jax.tree.map(lambda m, n: m * m + n, mu, tt._tree(rng, params, 1e-6, positive=True))
    tx = jax_build_opt(jcfg, jcfg.lr)
    jstate = jax_create({"params": params}, tx, use_ema=True)
    jstate = jstate.replace(
        step=jnp.asarray(count, jnp.int32), ema_params=ema,
        opt_state=_rebuild_opt_state(jstate.opt_state, jnp.asarray(count, jnp.int32), mu, nu))
    state = train_state_from_jax(tv.port_vit(2), params, ema, mu, nu, count, count)
    return tx, jstate, state


def tp_inputs(hw):
    rng = np.random.default_rng(41)
    batch = {"image": rng.normal(size=(B, *hw, 3)).astype(np.float32),
             "label": rng.integers(0, tt.NUM_CLASSES, B).astype(np.int32)}
    evals = [{"image": rng.integers(0, 256, (B, *hw, 3), dtype=np.uint8),
              "label": rng.integers(0, tt.NUM_CLASSES, B).astype(np.int32),
              "mask": np.arange(B) < B - 1}]
    return batch, evals


def jax_mesh_step(jbundle, jcfg, tx_j, jstate, batch, evals):
    """JAX's train step and eval step on the (data 1, model 2) mesh of 2
    virtual CPU devices."""
    mesh = jax_build_mesh(JaxMeshSpec(data=1, model=2), jax.devices()[:2])
    s_shard, js, (jb, je) = on_mesh(mesh, jstate, [batch, evals[0]])
    jstep = jax.jit(jax_make_train(jbundle, jcfg, tx_j, jax_loss.build_criterion(jcfg)),
                    out_shardings=(s_shard, None))
    js, jm = jstep(js, jb, jax.random.key(0))
    jeval = jax.jit(jax_make_eval(jbundle, jcfg))(js, je)
    return {"jm": jm, "js": js, "jeval": jeval}


@pytest.fixture(scope="module")
def convnext_tp(tmp_path_factory):
    """The ConvNeXt on 2 ranks under each mode of MODES (one spawn, the
    modes in turn from copies of the same state), and JAX's step under
    each, its backbone cloned to the mode."""
    jcfg, cfg = tt.both_cfgs()
    tx_j, jstate, state = tt.start_states(jcfg)
    batch, evals = tp_inputs((tt.SIZE, tt.SIZE))
    jax_by_mode = {}
    for mode in MODES:
        module = tt.jax_model("xla")
        module = module.clone(backbone=module.backbone.clone(block_remat=mode))
        jbundle = JaxBundle(name="tiny", module=module, deep_supervised=True,
                            has_batch_stats=False, input_size=(tt.SIZE, tt.SIZE))
        jax_by_mode[mode] = jax_mesh_step(jbundle, jcfg, tx_j, jstate, batch, evals)
    bundle = ModelBundle("tiny", state.model, True, (tt.SIZE, tt.SIZE))
    args = (state, cfg, tt.STEPS_PER_EPOCH, None, [as_port(batch)], [None],
            [as_port(b) for b in evals], [], (1, 2))
    out = str(tmp_path_factory.mktemp("tp_convnext"))
    run_ranks(remat_worker, 2, out, out, MODES, bundle, *args)
    ranks = [{mode: {**load_ranks(f"{out}/{mode}", 2)[r],
                     **torch.load(f"{out}/{mode}/calls{r}.pt")} for mode in MODES}
             for r in range(2)]
    return {"cfg": cfg, "jax": jax_by_mode, "ranks": ranks}


@pytest.fixture(scope="module", params=["convnext", "vit"])
def tp_case(request, tmp_path_factory):
    if request.param == "convnext":
        c = request.getfixturevalue("convnext_tp")
        return {"cfg": c["cfg"], **c["jax"]["none"],
                "ranks": [r["none"] for r in c["ranks"]]}
    jcfg, cfg = tt.both_cfgs(image_size=tv.HW, native_size=tv.HW,
                             use_deep_supervision=False, schedule="none")
    tx_j, jstate, state = vit_start(jcfg)
    jbundle = JaxBundle(name="tiny", module=tv.jax_vit(2), deep_supervised=False,
                        has_batch_stats=False, input_size=tv.HW)
    batch, evals = tp_inputs(tv.HW)
    bundle = ModelBundle("tiny", state.model, False, tv.HW)
    args = (bundle, state, cfg, 1, None, [as_port(batch)], [None],
            [as_port(b) for b in evals], [], (1, 2))
    tmp = str(tmp_path_factory.mktemp("tp_vit"))
    return {"cfg": cfg, **jax_mesh_step(jbundle, jcfg, tx_j, jstate, batch, evals),
            "ranks": run_port(tmp, 2, *args)}


def check_against_jax(c: dict, ours: dict, jax_step: dict) -> None:
    """The loss, the whole parameters and EMA after the step, Adam's count,
    the eval sums, under ``test_torch_ddp.py``'s tolerances."""
    np.testing.assert_allclose(ours["metrics"][0]["loss"], float(jax_step["jm"]["loss"]),
                               rtol=1e-5)
    assert ours["metrics"][0]["accuracy"] == float(jax_step["jm"]["accuracy"])
    atol = 1e-3 * c["cfg"].lr
    js = jax_step["js"]
    for part, tree in (("model", js.params), ("ema", js.ema_params)):
        theirs = {k: v.numpy() for k, v in state_dict_from_jax(
            jax.tree.map(np.asarray, tree)).items()}
        tt.assert_trees_close({k: v.numpy() for k, v in ours["state"][part].items()},
                              theirs, atol, part)
    assert ours["state"]["count"] == int(js.step)
    check_eval(ours["eval"][0], jax_step["jeval"])


def states_equal(a: dict, b: dict) -> bool:
    return all(torch.equal(v, b[part][k]) for part in ("model", "ema", "mu", "nu")
               for k, v in a[part].items())


def test_tensor_parallel_step_matches_jax_mesh_model_2(tp_case):
    """The step against JAX's; both model ranks gathered the same whole
    state."""
    c = tp_case
    check_against_jax(c, c["ranks"][0], c)
    assert states_equal(c["ranks"][0]["state"], c["ranks"][1]["state"])


@pytest.mark.parametrize("mode", ["dots", "full"])
def test_split_mlp_remat_matches_jax_and_none(convnext_tp, mode):
    """A split MLP under ``dots`` and ``full``: the step against JAX's step
    with the backbone in the same mode, and on each rank equal to the
    port's ``none`` to the bit (the metrics, the eval sums and every tensor
    of the state)."""
    c = convnext_tp
    check_against_jax(c, c["ranks"][0][mode], c["jax"][mode])
    for rank in c["ranks"]:
        ours, none = rank[mode], rank["none"]
        assert ours["metrics"] == none["metrics"]
        assert all(torch.equal(v, none["eval"][0][k]) for k, v in ours["eval"][0].items())
        assert states_equal(ours["state"], none["state"])


@pytest.mark.parametrize("mode", MODES)
def test_launch_prediction_on_the_model_axis(convnext_tp, mode, monkeypatch):
    """``model_launches`` on a model axis of 2, against the kernel entries
    each rank called in the step and the eval forward: every block split,
    so the composed route (no block tail kernel), GELU once a block and
    microbatch and once more for each block recomputed, the depthwise
    forward again under ``full``. The model group's sums that ran: one
    forward and one backward a block and microbatch, one a block in the
    eval forward, and under ``full`` one more a block and microbatch;
    ``dots`` keeps the forward's sum, so its recompute runs none."""
    monkeypatch.setitem(CONVNEXT_CONFIGS, "convnext_tp_test", (tt.DEPTHS, tt.DIMS))
    cfg = convnext_tp["cfg"].replace(model_name="convnext_tp_test", mesh_model=2,
                                     block_remat=mode)
    want = expected_launches(cfg, 1, 1)
    want.pop("warp")     # the aug is off
    assert want["block_mlp"] == 0 and want["gelu"] > 0
    blocks, micro = sum(tt.DEPTHS), cfg.gradient_accumulation_steps
    sums = blocks * (micro * (3 if mode == "full" else 2) + 1)
    for rank in convnext_tp["ranks"]:
        assert rank[mode]["calls"] == want
        assert rank[mode]["model_sums"] == sums
