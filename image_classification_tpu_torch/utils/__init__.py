"""The train loop's helpers: metrics, logging, the LR monitor, checkpoints,
step timing and profiling (each the counterpart of the JAX package's
``utils`` module of its name), and a lock between processes."""
