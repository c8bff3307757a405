"""PyTorch/CUDA port of ``image_classification_tpu``, for one NVIDIA H100.

It follows the JAX package's module layout and names, imports ``torch`` and
never ``jax``, and keeps activations channels-last (NHWC) from input to head.
The first slice is TTA-ensemble prediction (``cli predict``); its hot ops run
hand-written kernels on CUDA (``ops/``, ``csrc/``).
"""

__version__ = "0.1.0"
