"""The port's kernel ops (their plain versions, which the wrappers run on a
CPU tensor) against the JAX package's ops on the same numpy inputs, in f32.
The JAX Pallas kernels run in interpret mode, as the JAX tests run them.

Tolerances: both sides compute in f32 with sums in another order; 1e-5
absolute is ~10 f32 ulps at the magnitudes used (|y| <~ 10)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from image_classification_tpu.ops.block_mlp import block_mlp as jax_block_mlp
from image_classification_tpu.ops.dwconv import depthwise_conv7x7 as jax_dwconv
from image_classification_tpu.ops.gelu import gelu_erf_free, gelu_erf_free_pallas
from image_classification_tpu_torch.ops import (
    block_mlp,
    depthwise_conv7x7,
    gelu,
)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Each port test module runs torch on one thread, and gives the count
    back after. The suite runs in several worker processes on a few cores:
    torch's default of a thread per core in each of them oversubscribes the
    cores, and the tests' small shapes gain nothing from more threads. Other
    port test modules import this fixture, so it holds for each of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = 1e-5


def test_gelu_matches_jax_and_pallas_kernel(monkeypatch):
    monkeypatch.setenv("IC_TPU_GELU_INTERPRET", "1")
    x = (np.random.default_rng(0).normal(size=(12, 256)) * 4).astype(np.float32)
    x[0, :5] = [0.0, -0.0, 1e-8, -30.0, 30.0]
    ours = gelu(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ours, np.asarray(gelu_erf_free(jnp.asarray(x))),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(
        ours, np.asarray(gelu_erf_free_pallas(jnp.asarray(x))), rtol=TOL, atol=TOL)
    # and the A&S erf stays within its 1.5e-7 bound of the exact GELU
    exact = torch.nn.functional.gelu(torch.from_numpy(x).double()).numpy()
    np.testing.assert_allclose(ours, exact, rtol=0, atol=2e-6 * np.abs(x).max())


# the last five are the chip check's edge shapes: V2's stage 0 at 60x80
# input, maps smaller than the kernel, an odd small map, and a map wider than
# the wgrad kernel's 65-column strip
@pytest.mark.parametrize("shape", [(2, 9, 9, 12), (3, 17, 11, 20), (1, 4, 6, 7),
                                   (2, 15, 20, 128), (2, 3, 5, 40), (2, 1, 1, 40),
                                   (3, 13, 17, 40), (1, 9, 70, 40)])
def test_dwconv_matches_jax_pallas_interpret(shape):
    rng = np.random.default_rng(sum(shape))
    x = rng.normal(size=shape).astype(np.float32)
    w = (rng.normal(size=(7, 7, shape[-1])) * 0.2).astype(np.float32)
    ref = jax_dwconv(jnp.asarray(x), jnp.asarray(w), interpret=True)
    ours = depthwise_conv7x7(torch.from_numpy(x), torch.from_numpy(w))
    assert ours.shape == shape and ours.is_contiguous()
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)


def _block_inputs(m, c, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(np.float32)  # noqa: E731
    return dict(
        x=f(m, c), res=f(m, c), s=1 + f(c, scale=0.1), t=f(c, scale=0.1),
        w1=f(c, 4 * c, scale=c ** -0.5), b1=f(4 * c, scale=0.1),
        w2=f(4 * c, c, scale=(4 * c) ** -0.5), b2=f(c, scale=0.1),
        g=rng.uniform(0.5, 1.5, size=c).astype(np.float32),
    )


@pytest.mark.parametrize("m,c", [(96, 32), (50, 40)])
def test_block_mlp_matches_jax_pallas_interpret(m, c):
    a = _block_inputs(m, c, seed=m + c)
    ref = jax_block_mlp(*(jnp.asarray(a[k]) for k in
                          ("x", "res", "s", "t", "w1", "b1", "w2", "b2", "g")),
                        1e-6, 32, True)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    # the port keeps nn.Linear's (out, in) weight layout
    ours = block_mlp(t["x"], t["res"], t["s"], t["t"], t["w1"].t(), t["b1"],
                     t["w2"].t(), t["b2"], t["g"])
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)


def test_block_mlp_bf16_rounding_points():
    """In bf16 the plain version rounds where the Pallas kernel does: xhat
    before fc1 and h before fc2 (compared against the JAX kernel run in bf16
    interpret mode). Bound: one bf16 ulp of the output (measured: identical)."""
    a = _block_inputs(64, 32, seed=3)
    bf = {k: jnp.asarray(v).astype(jnp.bfloat16) if k in ("x", "res") else jnp.asarray(v)
          for k, v in a.items()}
    ref = np.asarray(jax_block_mlp(*(bf[k] for k in
                     ("x", "res", "s", "t", "w1", "b1", "w2", "b2", "g")),
                     1e-6, 32, True).astype(jnp.float32))
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    ours = block_mlp(t["x"].bfloat16(), t["res"].bfloat16(), t["s"], t["t"],
                     t["w1"].t(), t["b1"], t["w2"].t(), t["b2"], t["g"])
    assert ours.dtype == torch.bfloat16
    np.testing.assert_allclose(ours.float().numpy(), ref, rtol=2 ** -7, atol=1e-6)
