"""The train entry's ConvNeXt options in the port against the JAX package
(or sklearn), on the CPU: dataset channel stats (``data/stats.py``), the
holdout split (``data/splits.py:stratified_split``, ``split_mode=holdout``
in ``train/kfold.py``), ``freeze_stages`` (``train/optim.py``,
``train/fused.py``) and ``cli predict --best-fold`` with ``norm_stats=dataset``
through ``cli train``.

Tolerances: the stats are float64 sums of the same pixels in the same order
on both sides (equal to 1e-12 relative); splits are integer indices (equal);
the frozen step holds the trainable parameters and the EMA to 1e-3 of the
LR, as ``test_torch_train.py`` holds the step (f32 on both sides with sums
in another order), and the frozen ones to their bits.
"""

import json
import os

import numpy as np
import pytest
import torch
from sklearn.model_selection import train_test_split

import jax
import jax.numpy as jnp

from image_classification_tpu.core.config import Config as JaxConfig
from image_classification_tpu.data import Manifest as JaxManifest
from image_classification_tpu.data import stats as jstats
from image_classification_tpu.data.source import ArraySource as JaxArraySource
from image_classification_tpu.data.source import ImageSource as JaxImageSource
from image_classification_tpu.train import kfold as jkfold
from image_classification_tpu.train import loss as jax_loss
from image_classification_tpu.train.loop import build_lr_schedule as jax_build_lr
from image_classification_tpu.train.optim import _freeze_label_fn
from image_classification_tpu.train.optim import build_optimizer as jax_build_opt
from image_classification_tpu.train.optim import set_learning_rate as jax_set_lr
from image_classification_tpu.train.step import make_train_step as jax_make_train
from image_classification_tpu.train.train_state import create_train_state as jax_create
from image_classification_tpu_torch import cli
from image_classification_tpu_torch.core.config import Config
from image_classification_tpu_torch.data import ArraySource, Manifest, save_decode_cache
from image_classification_tpu_torch.data import stats
from image_classification_tpu_torch.data.source import load_decode_cache
from image_classification_tpu_torch.data.splits import stratified_split
from image_classification_tpu_torch.models import ConvNeXt, DeepSupervisionModel
from image_classification_tpu_torch.models.factory import ModelBundle
from image_classification_tpu_torch.models.pretrained import (
    convnext_state_dict_from_jax,
    train_state_from_jax,
)
from image_classification_tpu_torch.train import kfold, loss
from image_classification_tpu_torch.train.loop import build_lr_schedule
from image_classification_tpu_torch.train.optim import (
    build_optimizer,
    is_frozen,
    set_learning_rate,
)
from image_classification_tpu_torch.train.step import accumulate_grads, make_train_step
from image_classification_tpu_torch.utils.checkpoint import select_best_fold

import functools

from test_torch_model import DEPTHS, DIMS, NUM_CLASSES
from test_torch_model import randomized_params as _randomized_params
from test_torch_ops import one_torch_thread  # noqa: F401  (autouse, module scope)
from test_torch_train import (
    SIZE,
    _tree,
    assert_trees_close,
    both_cfgs,
    jax_as_port,
    jax_bundle,
    port_params,
)

N_IMG, HW = 40, (12, 16)


@functools.cache
def randomized_params(size):
    """The tiny model's flax parameters, initialised once for the module
    (the JAX init costs ~1.5 s); callers copy what they change."""
    return _randomized_params(size)


def images(seed, n=N_IMG, hw=HW):
    return np.random.default_rng(seed).integers(0, 256, (n, *hw, 3), dtype=np.uint8)


def long_tail(n, k, seed):
    """``n`` labels over ``k`` classes, class ``c`` ~0.7^c of the rest,
    the last ones singletons, shuffled."""
    share = 0.7 ** np.arange(k)
    counts = 1 + np.floor((n - k) * share / share.sum()).astype(int)
    counts[0] += n - counts.sum()
    return np.random.default_rng(seed).permutation(np.repeat(np.arange(k), counts))


# ------------------------------------------------------------------ stats
@pytest.mark.parametrize("batch_size", [1024, 7])
def test_compute_channel_stats_matches_jax(batch_size):
    x = images(1)
    ours = stats.compute_channel_stats(ArraySource(x), batch_size)
    theirs = jstats.compute_channel_stats(JaxArraySource(x), batch_size)
    np.testing.assert_allclose(np.array(ours), np.array(theirs), rtol=1e-12, atol=0)
    want = x.reshape(-1, 3) / 255.0
    np.testing.assert_allclose(ours[0], want.mean(0), rtol=1e-12)
    np.testing.assert_allclose(ours[1], want.std(0), rtol=1e-9)


def test_norm_stats_resolve_save_load_round_trip_matches_jax(tmp_path):
    """Both packages read one decode cache under one key; the port computes
    and caches the stats, JAX reads the port's cache and gets the same
    config, and each side's saved file loads on the other."""
    ids = np.array([f"{i:03d}" for i in range(N_IMG)], object)
    img_dir, cache = str(tmp_path / "train"), str(tmp_path / "cache")
    save_decode_cache(img_dir, list(ids), images(2), cache)
    ours_src = load_decode_cache(img_dir, list(ids), HW, cache)
    theirs_src = JaxImageSource(img_dir, ids, native_size=HW, cache_dir=cache)
    assert ours_src._cache_key() == theirs_src._cache_key()
    kw = dict(norm_stats="dataset", cache_dir=cache)
    cfg, jcfg = Config(**kw), JaxConfig(**kw)
    ours = stats.resolve_norm_stats(cfg, ours_src, save_to=str(tmp_path / "p/ns.json"))
    cached = tmp_path / "cache" / f"channel_stats_{ours_src._cache_key()}.json"
    assert cached.exists()
    theirs = jstats.resolve_norm_stats(jcfg, theirs_src, save_to=str(tmp_path / "j/ns.json"))
    assert ours.mean == theirs.mean and ours.std == theirs.std
    assert ours.mean == jstats.compute_channel_stats(theirs_src)[0]
    assert ours.mean != Config().mean
    for src, load in ((tmp_path / "j/ns.json", stats.load_saved_norm_stats),
                      (tmp_path / "p/ns.json", jstats.load_saved_norm_stats)):
        loaded = load(Config() if load is stats.load_saved_norm_stats else JaxConfig(),
                      str(src))
        assert (loaded.mean, loaded.std) == (ours.mean, ours.std)
    assert stats.load_saved_norm_stats(cfg, str(tmp_path / "none.json")) is None
    assert stats.resolve_norm_stats(Config(), ours_src) == Config()


# ------------------------------------------------------------------ holdout
SPLIT_CASES = [
    ("uniform", lambda: np.random.default_rng(3).integers(0, 5, 97), 0.1, 42),
    ("uniform_third", lambda: np.random.default_rng(4).integers(0, 7, 150), 0.33, 7),
    ("long_tail", lambda: long_tail(120, 10, 5), 0.2, 0),
    ("pairs_remainders", lambda: np.repeat(np.arange(9), 2), 0.5, 3),
    ("ties", lambda: np.repeat(np.arange(6), [5, 5, 5, 3, 3, 3]), 0.15, 11),
    ("singletons", lambda: long_tail(60, 12, 6), 0.2, 42),
    ("too_few_test", lambda: np.repeat(np.arange(8), 4), 0.1, 42),
]


@pytest.mark.parametrize("labels,fraction,seed", [c[1:] for c in SPLIT_CASES],
                         ids=[c[0] for c in SPLIT_CASES])
def test_stratified_split_matches_sklearn(labels, fraction, seed):
    """Index for index against ``train_test_split(stratify=...)``, and the
    same refusal where sklearn refuses (a singleton class, fewer test places
    than classes)."""
    y = labels()
    try:
        tr, va = train_test_split(np.arange(len(y)), test_size=fraction, stratify=y,
                                  random_state=seed)
    except ValueError:
        with pytest.raises(ValueError):
            stratified_split(y, fraction, seed)
        return
    ours = stratified_split(y, fraction, seed)
    np.testing.assert_array_equal(ours[0], np.sort(tr))
    np.testing.assert_array_equal(ours[1], np.sort(va))


def test_holdout_and_dataset_stats_in_train_k_fold_match_jax(tmp_path, monkeypatch):
    """``train_k_fold(split_mode=holdout, norm_stats=dataset)`` in both
    packages on one long-tailed set with singletons (oversampled to 2, then
    one stratified split as fold 1): the same train and val indices, the
    same stats in the config the fold trains with and in
    ``norm_stats.json``. The fold's training is replaced by a recorder."""
    labels = long_tail(N_IMG, 8, 7)
    ids = np.array([f"{i:03d}" for i in range(N_IMG)], object)
    x = images(8)
    seen = {}

    def recorder(tag):
        def loaders(cfg, source, manifest, train_idx, val_idx, **_):
            return train_idx, val_idx, manifest.labels[train_idx]

        def train_fold(cfg, train_idx, val_idx, fold=1, **_):
            seen[tag] = (fold, train_idx, val_idx, cfg.mean, cfg.std)
            return "result"
        return loaders, train_fold

    for mod, tag in ((kfold, "ours"), (jkfold, "theirs")):
        loaders, fold_fn = recorder(tag)
        monkeypatch.setattr(mod, "make_fold_loaders", loaders)
        monkeypatch.setattr(mod, "train_fold", fold_fn)
    kw = dict(split_mode="holdout", val_fraction=0.25, norm_stats="dataset",
              num_classes=8, train_dir=str(tmp_path / "train"))
    ours = kfold.train_k_fold(
        Config(**kw, model_save_path=str(tmp_path / "p")).validate(),
        manifest=Manifest(ids, labels), source=ArraySource(x), device="cpu")
    theirs = jkfold.train_k_fold(
        JaxConfig(**kw, model_save_path=str(tmp_path / "j")).validate(),
        manifest=JaxManifest(ids, labels), source=JaxArraySource(x))
    assert ours == theirs == ["result"]
    o, t = seen["ours"], seen["theirs"]
    assert o[0] == t[0] == 1
    np.testing.assert_array_equal(o[1], t[1])
    np.testing.assert_array_equal(o[2], t[2])
    assert len(o[1]) + len(o[2]) == N_IMG + int((np.bincount(labels) == 1).sum())
    assert (o[3], o[4]) == (t[3], t[4]) and o[3] != Config().mean
    for root in ("p", "j"):
        with open(tmp_path / root / "norm_stats.json") as f:
            assert tuple(json.load(f)["mean"]) == o[3]


# ------------------------------------------------------------------ freezing
@pytest.mark.parametrize("deep,freeze_stages", [(True, 1), (True, 2), (False, 1), (False, 4)])
def test_frozen_set_is_jax_labels_through_the_carrier(deep, freeze_stages):
    """JAX labels each flax leaf (``optim.py:_freeze_label_fn``); a tree of
    ones where it says frozen, zeros elsewhere, goes through the weight
    carrier, and the timm keys that come out all ones are the port's frozen
    set."""
    params = randomized_params(SIZE)
    if not deep:
        params = params["backbone"]
    label = _freeze_label_fn(freeze_stages)
    marks = jax.tree_util.tree_map_with_path(
        lambda p, leaf: np.full(np.shape(leaf), float(label(p, leaf) == "frozen"),
                                np.float32), params)
    sd = convnext_state_dict_from_jax(marks)
    theirs = {k for k, v in sd.items() if bool((v == 1).all())}
    assert all(bool((v == 0).all()) for k, v in sd.items() if k not in theirs)
    ours = {k for k in sd if is_frozen(k, freeze_stages)}
    assert ours == theirs and theirs
    assert not any(k.startswith("aux_head") or "head." in k for k in ours)


def with_moments(opt_state, count, mu, nu):
    """JAX's opt state with Adam's count, and its mu and nu taken from the
    full trees ``mu``/``nu`` at the leaves it holds (``multi_transform``
    masks the frozen ones out)."""
    def lookup(tree, path):
        for p in path:
            tree = tree[p.key]
        return tree

    def visit(node):
        if hasattr(node, "_fields"):
            if {"count", "mu", "nu"} <= set(node._fields):
                def pick(full):
                    return jax.tree_util.tree_map_with_path(
                        lambda path, _: jnp.asarray(lookup(full, path)), node.mu)
                return node._replace(count=jnp.asarray(count, jnp.int32),
                                     mu=pick(mu), nu=pick(nu))
            return type(node)(*(visit(c) for c in node))
        if isinstance(node, tuple):
            return tuple(visit(c) for c in node)
        if isinstance(node, dict):
            return {k: visit(v) for k, v in node.items()}
        return node

    return visit(opt_state)


def test_freeze_step_and_plateau_lr_match_jax():
    """Two steps with ``freeze_stages=1`` and the plateau schedule against
    JAX's generic optax step (``multi_transform`` + ``set_to_zero``), the LR
    set anew before the second on both sides; the clip (1.0) acts. Both
    start from one state with random Adam moments past warmup, as
    ``test_torch_train.start_states`` (zero where frozen). The stem and
    stage 0 keep their bits; everything else, and the EMA, within 1e-3 of
    the LR; the port's clip norm is over the trainable gradients only."""
    jcfg, cfg = both_cfgs(freeze_stages=1, schedule="plateau", lr=2e-3)
    params = randomized_params(SIZE)
    rng = np.random.default_rng(8)
    label = _freeze_label_fn(1)
    live = jax.tree_util.tree_map_with_path(lambda p, leaf: label(p, leaf) == "train",
                                            params)
    mu = jax.tree.map(lambda m, k: m * k, _tree(rng, params, 1e-3), live)
    nu = jax.tree.map(lambda m, n, k: (m * m + n) * k, mu,
                      _tree(rng, params, 1e-6, positive=True), live)
    ema = jax.tree.map(lambda p, n: np.asarray(p) + n, params, _tree(rng, params, 0.01))
    tx_j = jax_build_opt(jcfg, jax_build_lr(jcfg, 10))
    jstate = jax_create({"params": params}, tx_j, use_ema=True)
    jstate = jstate.replace(ema_params=ema,
                            opt_state=with_moments(jstate.opt_state, 30, mu, nu))
    model = DeepSupervisionModel(ConvNeXt(NUM_CLASSES, DEPTHS, DIMS, dtype=torch.float32),
                                 NUM_CLASSES)
    state = train_state_from_jax(model, params, ema, mu, nu, 30, 30)
    before = {k: v.copy() for k, v in port_params(state).items()}
    tx = build_optimizer(cfg, build_lr_schedule(cfg, 10))
    jstep = jax.jit(jax_make_train(jax_bundle(), jcfg, tx_j, jax_loss.build_criterion(jcfg)))
    bundle = ModelBundle("tiny", state.model, True, (SIZE, SIZE))
    rng = np.random.default_rng(9)
    for t, lr in enumerate((2e-3, 5e-4)):
        if t:
            jstate = jstate.replace(opt_state=jax_set_lr(jstate.opt_state, lr))
            tx = set_learning_rate(tx, lr)
        step = make_train_step(bundle, cfg, tx, loss.build_criterion(cfg))
        x = rng.normal(size=(8, SIZE, SIZE, 3)).astype(np.float32)
        y = rng.integers(0, NUM_CLASSES, 8).astype(np.int32)
        if t == 0:
            grads, _ = accumulate_grads(state.model, cfg, loss.build_criterion(cfg),
                                        torch.from_numpy(x), torch.from_numpy(y).long())
        jstate, jm = jstep(jstate, {"image": jnp.asarray(x), "label": jnp.asarray(y)},
                           jax.random.key(0))
        state, m = step(state, {"image": torch.from_numpy(x),
                                "label": torch.from_numpy(y).long()})
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
        if t == 0:
            names = state.names()
            train_norm = torch.linalg.vector_norm(torch.stack(
                [g.norm() for n, g in zip(names, grads) if not is_frozen(n, 1)]))
            all_norm = torch.linalg.vector_norm(torch.stack([g.norm() for g in grads]))
            assert float(m["grad_norm"]) == pytest.approx(float(train_norm), rel=1e-6)
            assert float(train_norm) < float(all_norm) and float(train_norm) > 1.0
    ours, theirs = port_params(state), jax_as_port(jstate.params)
    frozen = [k for k in ours if is_frozen(k, 1)]
    assert frozen and all(np.array_equal(ours[k], before[k]) for k in frozen)
    assert all(np.array_equal(theirs[k], before[k]) for k in frozen)
    assert all(not np.array_equal(ours[k], before[k]) for k in ours if k not in frozen)
    assert_trees_close(ours, theirs, 1e-3 * 2e-3, "params")
    assert_trees_close(dict(zip(state.names(), (e.numpy() for e in state.ema))),
                       jax_as_port(jstate.ema_params), 1e-3 * 2e-3, "ema")
    assert all(float(state.mu[i].abs().max()) == 0.0 for i, n in enumerate(state.names())
               if is_frozen(n, 1))


# ------------------------------------------------------------------ cli
def test_cli_best_fold_and_dataset_stats_through_train_and_predict(tmp_path):
    """``cli train`` (convnext_atto, RandAugment on, ``norm_stats=dataset``,
    2 folds of 1 epoch) -> ``cli predict --folds 1,2`` reproduces its
    submission from ``norm_stats.json``, and again without the file (the
    stats recomputed from the train set); ``--best-fold`` predicts with the
    fold ``select_best_fold`` names, as ``--folds k`` does."""
    n_train, n_test, k = 32, 8, 4
    root = str(tmp_path)
    labels = np.arange(n_train) % k
    for name, n, col, vals in (("train", n_train, "target", labels),
                               ("test", n_test, "predict", np.zeros(n_test, int))):
        with open(f"{root}/{name}.csv", "w") as f:
            f.write(f"id,{col}\n" + "".join(f"{i:03d},{v}\n" for i, v in enumerate(vals)))
        ids = Manifest.from_csv(f"{root}/{name}.csv", is_test=name == "test").ids
        save_decode_cache(f"{root}/{name}", list(ids), images(10 + n, n, (32, 32)),
                          f"{root}/cache")
    over = [f"train_csv={root}/train.csv", f"test_csv={root}/test.csv",
            f"train_dir={root}/train", f"test_dir={root}/test", f"cache_dir={root}/cache",
            f"model_save_path={root}/models", f"output_dir={root}/out",
            "model_name=convnext_atto", f"num_classes={k}", "image_size=[32,32]",
            "native_size=[32,32]", "batch_size=8", "epochs=1", "num_folds=2",
            "compute_dtype=float32", "use_deep_supervision=false", "use_ema=false",
            "use_randaugment=true", "randaugment_prob=1.0", "mixup_alpha=0",
            "cutmix_alpha=0", "norm_stats=dataset", "tta_mode=flip6", "tta_transforms=6"]
    cli.main(["train", "--device", "cpu", *over, f"submission_path={root}/train.sub"])
    with open(f"{root}/models/norm_stats.json") as f:
        saved = json.load(f)
    train_src = load_decode_cache(f"{root}/train", Manifest.from_csv(
        f"{root}/train.csv").ids, (32, 32), f"{root}/cache")
    assert tuple(saved["mean"]) == stats.compute_channel_stats(train_src)[0]

    def predict(tag, *flags):
        cli.main(["predict", "--device", "cpu", *flags, *over,
                  f"submission_path={root}/{tag}.sub"])
        with open(f"{root}/{tag}.sub") as f:
            return f.read().splitlines()

    with open(f"{root}/train.sub") as f:
        submitted = f.read().splitlines()
    both = predict("both", "--folds", "1,2")
    assert both[0] == "id,predict" and both[1:] == submitted[1:]
    best, _ = select_best_fold(f"{root}/models", [1, 2], "acc")
    assert predict("best", "--folds", "1,2", "--best-fold") == predict("one", "--folds",
                                                                       str(best))
    os.remove(f"{root}/models/norm_stats.json")
    assert predict("again", "--folds", "1,2") == both
