"""repro_torch — Trust<T> delegation (Ahmad et al., 2024) in PyTorch and
CUDA for one NVIDIA H100, beside the JAX reference package ``repro``.

The T trustee shards of the JAX mesh are a leading tensor dimension on one
device (``core.meshctx.StackedMesh``); the channel's all_to_all is a
(src, dst) block transpose of that dimension, and the Pallas kernels of the
main path are hand-written CUDA C++ kernels under ``csrc/``.  This package
imports torch, numpy and the standard library only — never ``jax`` and
nothing of ``repro``."""
__version__ = "0.1.0"
