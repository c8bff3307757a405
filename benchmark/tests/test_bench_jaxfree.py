"""Nothing the harness or the reference loads is JAX or the JAX package
(top-level names compared whole: the port's name begins with the JAX
package's), and the reference loads nothing of the port."""

from __future__ import annotations

import subprocess
import sys

from benchmark.env import FORBIDDEN, loaded_forbidden
from benchmark.tests.conftest import ROOT


def test_names_are_compared_whole():
    mods = ["image_classification_tpu_torch", "image_classification_tpu_torch.ops",
            "jaxtyping", "flax_like", "numpy"]
    assert loaded_forbidden(mods) == []
    assert loaded_forbidden(mods + ["jax.numpy", "image_classification_tpu.cli"]) == \
        ["image_classification_tpu.cli", "jax.numpy"]


def _loaded_after(code: str) -> list[str]:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print('\\n'.join(sorted(sys.modules)))"],
                         cwd=ROOT, capture_output=True, text=True, check=True)
    return out.stdout.split()


def test_harness_loads_no_jax():
    mods = _loaded_after("import benchmark.run, benchmark.check, benchmark.entries.train, "
                         "benchmark.entries.predict, benchmark.entries.foldpar, "
                         "benchmark.trace, benchmark.rooflines\n"
                         "import image_classification_tpu_torch.train.step, "
                         "image_classification_tpu_torch.infer.predict, "
                         "image_classification_tpu_torch.train.kfold")
    assert [m for m in mods if m.split(".")[0] in FORBIDDEN] == []


def test_reference_loads_nothing_of_the_program():
    mods = _loaded_after("import benchmark.reference.train, benchmark.reference.quant, "
                         "benchmark.compare, benchmark.inputs, benchmark.counts")
    tops = {m.split(".")[0] for m in mods}
    assert not tops & set(FORBIDDEN)
    assert "image_classification_tpu_torch" not in tops
