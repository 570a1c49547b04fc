# repro_torch.models — the ported model code.
#
# layers.py     rmsnorm, RoPE
# attention.py  GQA attention init, the paged KV pool and one-token paged
#               decode attention (the paged-attention kernel's caller)
