"""The port's mesh, start-up, multi-process loader and metrics helpers
against the JAX package's, on the CPU (``parallel/``, ``data/loader.py``,
``utils/metrics.py``). Integer results must be equal; the float metrics
are held to 1e-6 relative (f32 on both sides)."""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

from image_classification_tpu.data import DataLoader as JaxLoader
from image_classification_tpu.data import Manifest as JaxManifest
from image_classification_tpu.data.sampling import ShuffleSampler as JaxShuffle
from image_classification_tpu.data.source import ArraySource as JaxArraySource
from image_classification_tpu.parallel import distributed as jax_distributed
from image_classification_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from image_classification_tpu.parallel.mesh import build_mesh as jax_build_mesh
from image_classification_tpu.parallel.mesh import pad_to_multiple as jax_pad
from image_classification_tpu.utils import metrics as jax_metrics
from image_classification_tpu_torch.data import ArraySource, DataLoader, Manifest
from image_classification_tpu_torch.data.sampling import ShuffleSampler
from image_classification_tpu_torch.parallel import distributed
from image_classification_tpu_torch.parallel.mesh import (
    AXES,
    Mesh,
    MeshSpec,
    axis_ranks,
    build_mesh,
    check_batch_divisible,
    pad_to_multiple,
    rank_coords,
)
from image_classification_tpu_torch.utils import metrics
from test_torch_ops import one_torch_thread  # noqa: F401  (autouse, module scope)


# ------------------------------------------------------------------- mesh
@pytest.mark.parametrize("spec,n", [
    ((-1, 1, 1), 8), ((-1, 2, 1), 8), ((2, 2, 2), 8), ((-1, 1, 2), 4),
    ((4, 1, 1), 4), ((-1, 2, 2), 8), ((1, 1, 1), 1),
])
def test_mesh_spec_resolves_as_jax(spec, n):
    assert MeshSpec(*spec).resolve(n) == JaxMeshSpec(*spec).resolve(n)


@pytest.mark.parametrize("spec,n", [((-1, 3, 1), 8), ((3, 1, 1), 8), ((-1, 1, 3), 4),
                                    ((2, 2, 1), 8)])
def test_mesh_spec_raises_as_jax(spec, n):
    with pytest.raises(ValueError) as theirs:
        JaxMeshSpec(*spec).resolve(n)
    with pytest.raises(ValueError) as ours:
        MeshSpec(*spec).resolve(n)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("shape", [(2, 2, 2), (1, 4, 2), (2, 4, 1), (1, 8, 1), (4, 1, 2)])
def test_rank_layout_and_groups_match_jax_mesh(shape):
    """Rank r sits where device r sits in JAX's (fold, data, model) mesh;
    an axis' groups are the device lines along it."""
    devices = jax.devices()[:int(np.prod(shape))]
    jmesh = jax_build_mesh(JaxMeshSpec(shape[1], shape[2], fold=shape[0]), devices)
    ids = np.vectorize(lambda d: d.id)(jmesh.devices).reshape(shape)
    for rank in range(ids.size):
        assert ids[rank_coords(rank, shape)] == rank
    for a, axis in enumerate(AXES):
        lines = np.moveaxis(ids, a, -1).reshape(-1, shape[a])
        assert axis_ranks(shape, axis) == sorted(lines.tolist())


def test_single_process_mesh_has_no_groups():
    mesh = build_mesh(MeshSpec())
    assert mesh.shape == (1, 1, 1) and mesh.groups == {} and mesh.is_primary
    check_batch_divisible(6, mesh)
    with pytest.raises(ValueError, match="not divisible"):
        check_batch_divisible(6, Mesh((1, 4, 1)))
    assert [pad_to_multiple(n, 4) for n in range(9)] == [jax_pad(n, 4) for n in range(9)]


# ------------------------------------------------------------- start-up
@pytest.mark.parametrize("n", [0, 1, 5, 8, 13])
@pytest.mark.parametrize("h", [1, 2, 4])
def test_host_shard_indices_match_jax(monkeypatch, n, h):
    for k in range(h):
        monkeypatch.setattr(jax, "process_index", lambda: k)
        monkeypatch.setattr(jax, "process_count", lambda: h)
        np.testing.assert_array_equal(distributed.host_shard_indices(n, k, h),
                                      jax_distributed.host_shard_indices(n))


def test_initialize_is_a_no_op_for_one_process_and_a_live_group(monkeypatch, tmp_path):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    distributed.initialize("cpu")
    monkeypatch.setenv("WORLD_SIZE", "1")
    distributed.initialize("cpu")
    assert not dist.is_initialized()
    assert distributed.num_hosts() == 1 and distributed.is_primary()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdzv", rank=0,
                            world_size=1)
    try:
        monkeypatch.setenv("WORLD_SIZE", "2")   # would block in a second rendezvous
        distributed.initialize("cpu")
        assert dist.get_world_size() == 1
        t = [torch.ones(3), torch.arange(2.0)]
        distributed.all_reduce_sum_(t, dist.group.WORLD)
        assert t[0].tolist() == [1.0] * 3 and t[1].tolist() == [0.0, 1.0]
        assert distributed.all_gather_json({"a": 0.1}, dist.group.WORLD) == [{"a": 0.1}]
    finally:
        dist.destroy_process_group()


def test_local_device_reads_local_rank(monkeypatch):
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert distributed.local_device("cuda") == torch.device("cuda", 3)
    assert distributed.local_device("cuda:1") == torch.device("cuda", 1)
    assert distributed.local_device("cpu") == torch.device("cpu")


# ---------------------------------------------------------------- loader
N_ITEMS, HW = 45, (4, 6)


@pytest.fixture(scope="module")
def items(tmp_path_factory):
    root = tmp_path_factory.mktemp("items")
    rng = np.random.default_rng(0)
    labels = rng.integers(0, 5, N_ITEMS)
    with open(root / "train.csv", "w") as f:
        f.write("id,target\n" + "".join(f"i{i},{v}\n" for i, v in enumerate(labels)))
    images = rng.integers(0, 256, (N_ITEMS, *HW, 3), dtype=np.uint8)
    return str(root / "train.csv"), images


@pytest.mark.parametrize("h", [2, 4])
@pytest.mark.parametrize("drop_last", [False, True])
def test_loader_ranks_take_jax_multihost_rows(items, h, drop_last):
    """Each rank's batches are JAX's ``_batches_multihost`` for that
    process, the padded ragged tail included; together they are the
    single-process batches."""
    csv, images = items
    idx = np.random.default_rng(1).permutation(N_ITEMS)[:41]
    jman = JaxManifest.from_csv(csv, num_classes=5)
    man = Manifest.from_csv(csv, num_classes=5)
    whole = list(DataLoader(ArraySource(images), man, indices=idx, batch_size=8,
                            sampler=ShuffleSampler(len(idx), seed=3), drop_last=drop_last,
                            device="cpu", prefetch_depth=0))
    parts = []
    for k in range(h):
        theirs = list(JaxLoader(JaxArraySource(images), jman, indices=idx, batch_size=8,
                                sampler=JaxShuffle(len(idx), seed=3), drop_last=drop_last,
                                process_index=k, process_count=h,
                                prefetch_depth=0)._batches())
        loader = DataLoader(ArraySource(images), man, indices=idx, batch_size=8,
                            sampler=ShuffleSampler(len(idx), seed=3), drop_last=drop_last,
                            device="cpu", prefetch_depth=k % 2, process_index=k,
                            process_count=h)
        ours = list(loader)
        assert len(ours) == len(theirs) == len(loader) == len(whole)
        for a, b in zip(ours, theirs):
            assert a["image"].shape[0] == 8 // h
            for key in ("image", "label", "mask", "index"):
                np.testing.assert_array_equal(np.asarray(a[key]), b[key], err_msg=key)
        parts.append(ours)
    for i, w in enumerate(whole):
        mask = torch.cat([p[i]["mask"] for p in parts])
        n = int(w["mask"].sum())
        assert mask.tolist() == [True] * n + [False] * (8 - n)
        got = torch.cat([p[i]["image"] for p in parts])[:n]
        assert torch.equal(got, w["image"][:n])


def test_loader_multiprocess_errors_match_jax(items):
    csv, images = items
    jman, man = JaxManifest.from_csv(csv), Manifest.from_csv(csv)
    for bs, kw in ((6, {"drop_last": True}), (8, {"drop_last": False, "pad_last": False})):
        with pytest.raises(ValueError) as theirs:
            next(JaxLoader(JaxArraySource(images), jman, batch_size=bs, process_index=0,
                           process_count=4, **kw)._batches())
        with pytest.raises(ValueError) as ours:
            next(iter(DataLoader(ArraySource(images), man, batch_size=bs, device="cpu",
                                 prefetch_depth=0, process_index=0, process_count=4,
                                 **kw)))
        assert str(ours.value).split()[1:] == str(theirs.value).split()[1:]


# --------------------------------------------------------------- metrics
def test_average_meter_matches_jax():
    ours, theirs = metrics.AverageMeter(), jax_metrics.AverageMeter()
    for v, n in ((0.5, 4), (1.25, 3), (2, 1), (0.1, 7)):
        ours.update(v, n)
        theirs.update(v, n)
        assert vars(ours) == vars(theirs)
    ours.reset()
    theirs.reset()
    assert vars(ours) == vars(theirs)


@pytest.mark.parametrize("soft", [False, True])
def test_accuracy_top1_matches_jax(soft):
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(37, 6)).astype(np.float32)
    labels = rng.integers(0, 6, 37)
    if soft:
        labels = np.eye(6, dtype=np.float32)[labels] * 0.7 + 0.05
    ours = metrics.accuracy_top1(torch.from_numpy(logits), torch.from_numpy(labels))
    theirs = jax_metrics.accuracy_top1(jnp.asarray(logits), jnp.asarray(labels))
    assert float(ours) == pytest.approx(float(theirs), rel=1e-6)


def test_confusion_matrix_and_report_match_jax():
    rng = np.random.default_rng(3)
    preds, labels = rng.integers(0, 5, 200), rng.integers(0, 4, 200)
    ours = metrics.confusion_matrix(torch.from_numpy(preds), torch.from_numpy(labels), 5)
    theirs = jax_metrics.confusion_matrix(jnp.asarray(preds), jnp.asarray(labels), 5)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    assert ours.sum() == 200 and int(ours[4].sum()) == 0
    for names in (None, ["a", "b", "c", "d", "e"]):
        assert metrics.classification_report(ours, names) == \
            jax_metrics.classification_report(np.asarray(theirs), names)
    np.testing.assert_allclose(metrics.per_class_f1(ours).numpy(),
                               np.asarray(jax_metrics.per_class_f1(theirs)), rtol=1e-6)
