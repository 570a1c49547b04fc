# repro_torch.models — the ported model code.
#
# layers.py       rmsnorm, RoPE, the gated MLP, embeddings, f32 logits
# attention.py    GQA attention: prefill forward (the flash-attention
#                 kernel's caller), decode over the stacked sequence-sharded
#                 KV cache, and one-token decode over the paged KV pool (the
#                 paged-attention kernel's caller)
# transformer.py  the decoder stack: init, prefill, decode_step
# model.py        the facade launch/ calls
