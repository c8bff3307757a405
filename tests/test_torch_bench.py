"""The port's bench (``image_classification_tpu_torch/bench.py``) against the
root ``bench.py``: its config and step counts as ``bench.py`` writes them
(read with ``ast``, nothing of it run), each rate on the CPU at a tiny
size, the TTA ensemble against the JAX bench's on the same weights and
images, the printed line, and the ``bench`` subcommand's refusals."""

import ast
import json
import os

import numpy as np
import pytest
import torch

import jax

from image_classification_tpu.core.config import Config as JaxConfig
from image_classification_tpu.infer.predict import _cast_inference_params as jax_cast
from image_classification_tpu.infer.tta import get_tta as jax_get_tta
from image_classification_tpu.models.factory import create_model as jax_create_model
from image_classification_tpu.train.step import make_eval_views as jax_eval_views
from image_classification_tpu.train.step import make_forward_views as jax_forward_views
from image_classification_tpu.train.step import tta_num_views as jax_num_views
from image_classification_tpu_torch import bench, cli
from image_classification_tpu_torch.core.config import Config
from image_classification_tpu_torch.models.factory import create_model
from image_classification_tpu_torch.models.pretrained import convnext_state_dict_from_jax

from test_torch_ops import one_torch_thread  # noqa: F401  (autouse, module scope)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(model_name="convnext_atto", num_classes=7, native_size=(24, 32),
            image_size=(32, 32), batch_size=4)
# f32 on both sides, the same weights and views: sums in another order
# through ~12 layers, then a softmax; measured max |d| 1.0e-7.
PROB_TOL = 1e-5


def _root_bench() -> dict[str, ast.AST]:
    with open(os.path.join(REPO, "bench.py")) as f:
        tree = ast.parse(f.read())
    return {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}


def _defaults(fn: ast.FunctionDef) -> dict:
    args = fn.args.args[-len(fn.args.defaults):]
    return {a.arg: ast.literal_eval(d) for a, d in zip(args, fn.args.defaults)}


def _calls(fn: ast.FunctionDef, name: str) -> list[ast.Call]:
    return [n for n in ast.walk(fn) if isinstance(n, ast.Call)
            and isinstance(n.func, ast.Name) and n.func.id == name]


def _root_line_keys(main: ast.FunctionDef) -> tuple[list[str], list[str], dict]:
    """The keys of the dict that the root bench's main prints, those of its
    ``extra_metrics``, and its literal values."""
    outer = next(n for n in ast.walk(main) if isinstance(n, ast.Dict)
                 and any(isinstance(k, ast.Constant) and k.value == "metric"
                         for k in n.keys))
    keys = [k.value for k in outer.keys]
    inner = outer.values[keys.index("extra_metrics")]
    literals = {k: v.value for k, v in zip(keys, outer.values)
                if isinstance(v, ast.Constant)}
    return keys, [k.value for k in inner.keys], literals


def test_config_and_counts_are_the_root_bench_s():
    fns = _root_bench()
    (cfg_call,) = _calls(fns["main"], "Config")
    kwargs = {k.arg: ast.literal_eval(k.value) for k in cfg_call.keywords}
    ours = bench.bench_config()
    assert ours == Config(**kwargs).validate()
    for k, v in kwargs.items():
        assert getattr(ours, k) == v, k
    # bench_train(cfg), then bench_train(cfg.replace(accum=2), n_steps=20)
    train_calls = _calls(fns["main"], "bench_train")
    assert len(train_calls) == 2
    accum2 = {k.arg: ast.literal_eval(k.value) for k in train_calls[1].keywords}
    replace = train_calls[1].args[1]
    assert {k.arg: ast.literal_eval(k.value) for k in replace.keywords} == {
        "gradient_accumulation_steps": 2}
    assert _defaults(fns["bench_train"]) == {"n_steps": bench.TRAIN_STEPS}
    assert accum2 == {"n_steps": bench.ACCUM2_STEPS}
    assert _defaults(fns["bench_aug"]) == {"n_iters": bench.AUG_ITERS}
    assert _defaults(fns["bench_infer"]) == {"n_batches": bench.INFER_BATCHES,
                                             "n_models": bench.INFER_MODELS}
    assert (bench.TRAIN_STEPS, bench.ACCUM2_STEPS, bench.AUG_ITERS,
            bench.INFER_BATCHES, bench.INFER_MODELS) == (30, 20, 50, 20, 2)
    with open(os.path.join(REPO, "bench.py")) as f:
        assert f"REFERENCE_IMAGES_PER_SEC = {bench.REFERENCE_IMAGES_PER_SEC}" in f.read()
    # the port's functions default to the same counts
    assert bench.bench_train.__defaults__ == (bench.TRAIN_STEPS,)
    assert bench.bench_aug.__defaults__ == (bench.AUG_ITERS,)
    assert bench.bench_infer.__defaults__ == (bench.INFER_BATCHES, bench.INFER_MODELS)


def _tiny(**over) -> Config:
    return bench.bench_config().replace(**{**TINY, **over}).validate()


@pytest.mark.parametrize("rate", ["train", "train_accum2", "aug", "infer"])
def test_each_rate_is_finite_and_positive_on_cpu(rate):
    if rate == "train":
        ips = bench.bench_train(_tiny(), "cpu", n_steps=1)
    elif rate == "train_accum2":
        ips = bench.bench_train(_tiny(gradient_accumulation_steps=2), "cpu", n_steps=1)
    elif rate == "aug":
        ips = bench.bench_aug(_tiny(), "cpu", n_iters=2)
    else:
        ips = bench.bench_infer(_tiny(), "cpu", n_batches=1, n_models=2)
    assert np.isfinite(ips) and ips > 0


def _numpy_params(jbundle, seed: int):
    """The JAX model's parameter tree (its shapes from ``jax.eval_shape``,
    nothing compiled) filled from ``default_rng(seed)``: kernels at
    1/sqrt(fan-in), LN scales near 1, biases, and layer scale from U(0.5,
    1.5), not its 1e-6 init, so every block changes its input."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(jbundle.init, jax.random.key(0))["params"]

    def draw(path, leaf):
        name, shape = jax.tree_util.keystr(path), leaf.shape
        if "gamma" in name:
            v = rng.uniform(0.5, 1.5, shape)
        elif "scale" in name:
            v = 1 + 0.1 * rng.normal(size=shape)
        elif "bias" in name:
            v = 0.1 * rng.normal(size=shape)
        else:
            v = rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def test_ensemble_matches_the_jax_bench_s():
    """Two ConvNeXt-atto models (numpy seeds 10 and 11, as the JAX bench
    seeds its two) carried into the port; the JAX side as
    ``bench.py:bench_infer`` builds it: shared views, each model's forward,
    the mean over the models."""
    # the block tail through its plain XLA reference: the Pallas kernel's
    # interpret mode costs seconds a call on the CPU
    over = dict(TINY, batch_size=2, compute_dtype="float32", block_mlp_impl="xla")
    jcfg = JaxConfig(**{**bench.bench_config().to_dict(), **over}).validate()
    cfg = _tiny(batch_size=2, compute_dtype="float32")
    jbundle = jax_create_model(jcfg)
    variables = [jax_cast({"params": _numpy_params(jbundle, 10 + i)}, jcfg)
                 for i in range(2)]
    tta = jax_get_tta(jcfg)
    views_fn = jax_eval_views(jcfg, tta)
    forward = jax_forward_views(jbundle, jcfg, jax_num_views(jcfg, tta))

    b = cfg.batch_size * cfg.infer_batch_multiplier
    images = np.random.default_rng(3).integers(0, 256, (b, *cfg.native_size, 3)
                                               ).astype(np.uint8)
    # one compile of the forward serves both models (the bench jits the
    # pair as one program: the same arithmetic, twice the compile)
    xb = jax.jit(views_fn)(images)
    fwd = jax.jit(forward)
    ref = np.asarray(jax.numpy.mean(jax.numpy.stack([fwd(v, xb) for v in variables]), 0))

    models = []
    for v in variables:
        model = create_model(cfg).module
        model.load_state_dict(convnext_state_dict_from_jax(v["params"]), strict=True)
        models.append(model)
    ours = bench.make_ensemble(cfg, models)(torch.from_numpy(images)).numpy()
    assert ours.shape == ref.shape == (b, cfg.num_classes)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=PROB_TOL)


def test_main_prints_the_root_bench_s_line(monkeypatch, capsys):
    tiny = _tiny()
    monkeypatch.setattr(bench, "bench_config", lambda: tiny)
    for name in ("TRAIN_STEPS", "ACCUM2_STEPS", "AUG_ITERS", "INFER_BATCHES"):
        monkeypatch.setattr(bench, name, 1)
    returned = bench.main(device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line == returned
    keys, extra_keys, literals = _root_line_keys(_root_bench()["main"])
    assert list(line) == keys and list(line["extra_metrics"]) == extra_keys
    assert line["metric"] == literals["metric"] == bench.METRIC
    assert line["unit"] == literals["unit"]
    values = [line["value"], *line["extra_metrics"].values()]
    assert all(np.isfinite(v) and v > 0 for v in values)
    assert line["vs_baseline"] == round(line["value"] / 79, 3)


def test_cli_bench_needs_a_card_and_takes_device_only(monkeypatch):
    def no_work(*args, **kwargs):
        raise AssertionError("the bench started work without a card")

    for name in ("bench_config", "bench_train", "bench_aug", "bench_infer"):
        monkeypatch.setattr(bench, name, no_work)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["bench"])
    with pytest.raises(SystemExit) as refused:
        cli.main(["bench", "--config", "x"])
    assert refused.value.code == 2
    with pytest.raises(SystemExit):
        cli.main(["bench", "lr=0.1"])
