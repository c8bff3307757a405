"""The port's hard-ladder rungs (``tools/run_hard_rung.py:RUNGS``) against
the JAX package's stages (``tools/run_hard_ladder.py:STAGES``), read with
``ast``, so no JAX import is needed.

A JAX stage is a ``tools/train_demo_tpu.py hard=true`` argument list; the
port's rung is the same run through its ``cli train``, translated as the
rung tool's docstring says: ``config=`` becomes the rung's config file,
``folds=`` becomes ``num_folds=``, and a stage without a config trains
``model_name=convnext_base`` on ``Config()`` defaults (the demo's base).
"""

import ast
import os

import pytest

from image_classification_tpu_torch.tools import run_hard_rung

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_stages() -> dict[str, list[str]]:
    """``STAGES`` as the module's first assignment writes it (the later
    ``STAGES.update`` adds the pretrained-regime stages no rung runs)."""
    with open(os.path.join(REPO, "tools", "run_hard_ladder.py")) as f:
        tree = ast.parse(f.read())
    for node in tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and getattr(node.targets[0], "id", None) == "STAGES"):
            return ast.literal_eval(node.value)
    raise AssertionError("tools/run_hard_ladder.py has no STAGES assignment")


def translate(args: list[str]) -> tuple[str | None, list[str]]:
    """(the config file or None, the port's overrides) of a JAX stage."""
    config, out = None, []
    for a in args:
        key, value = a.split("=", 1)
        if key == "config":
            config = value
        elif key == "folds":
            out.append(f"num_folds={value}")
        else:
            out.append(a)
    return config, out if config else ["model_name=convnext_base", *out]


@pytest.mark.parametrize("rung", sorted(run_hard_rung.RUNGS))
def test_rung_is_the_jax_stage(rung):
    name, config, overrides, _, folds, epochs = run_hard_rung.RUNGS[rung]
    stage = name.split()[0]
    stages = jax_stages()
    assert stage in stages, f"{rung}: {stage!r} is not a JAX stage"
    assert translate(stages[stage]) == (config, overrides)
    assert not any(a.startswith("seed=") for a in overrides)
    values = dict(a.split("=", 1) for a in overrides)
    assert epochs == int(values["epochs"])
    holdout = values.get("split_mode") == "holdout"
    assert folds == (1 if holdout else int(values["num_folds"]))
    curve = run_hard_rung.jax_curve(rung)
    assert len(curve) == folds * epochs


def test_rungs_cover_the_ladder():
    """Every JAX stage that trains from scratch on the seed-0 set and that
    one chip call can hold has a rung; ``v4`` (one fold of 16 epochs and a
    3-epoch stub in JAX's record) and ``v4_80`` (~6,400 s) do not."""
    stages = {spec[0].split()[0] for spec in run_hard_rung.RUNGS.values()}
    assert stages == set(jax_stages()) - {"v4", "v4_80"}
