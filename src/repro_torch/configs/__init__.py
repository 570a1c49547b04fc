# repro_torch.configs — the port's own copy of the model configurations it
# runs (values copied from repro/configs; nothing of repro is imported).
#
# base.py        ModelConfig, ShapeConfig, MeshConfig, RunConfig
# qwen2_5_3b.py  CONFIG (published widths) and SMOKE (test widths)
# registry.py    --arch id -> config; unported ids raise naming their item
