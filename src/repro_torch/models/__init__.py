# repro_torch.models — the ported model code.
#
# layers.py       rmsnorm, RoPE and M-RoPE, the gated MLP, embeddings,
#                 f32 logits, the delegated cross-entropy
# attention.py    GQA attention: prefill forward (the flash-attention
#                 kernel's caller), decode over the stacked sequence-sharded
#                 KV cache, and one-token decode over the paged KV pool (the
#                 paged-attention kernel's caller)
# transformer.py  the decoder stack: init, prefill, decode_step (token or
#                 embedding inputs)
# encdec.py       the encoder-decoder backbone (seamless-m4t-large-v2)
# model.py        the facade launch/ calls, and input_specs
