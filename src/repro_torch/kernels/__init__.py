# repro_torch.kernels — the main path's CUDA kernels (csrc/*.cu, built by
# _build.py with nvcc at first use) and their plain PyTorch versions.
#
# ref.py               plain versions (what every kernel computes)
# delegation_pack.py   client-side pack kernel wrapper
# delegation_serve.py  gather / scatter_last / segmented_add wrappers
# pagetable_serve.py   the page table's trustee serve
# paged_attention.py   one-token decode attention over page chains
# flash_attention.py   causal GQA attention forward (the prefill)
# ops.py               impl-selecting public wrappers + launch counters
