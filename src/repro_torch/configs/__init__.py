# repro_torch.configs — the port's own copy of the model configurations it
# runs (values copied from the JAX package's configs; nothing of the JAX
# package is imported).
#
# base.py        ModelConfig, ShapeConfig, MeshConfig, RunConfig
# <arch>.py      CONFIG (published widths and depth) and SMOKE (test
#                widths) of each architecture of the JAX registry
# registry.py    --arch id -> config
