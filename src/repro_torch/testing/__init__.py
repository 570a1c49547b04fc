# repro_torch.testing — differential checks that the entry points run with
# check=True, and that chip_smoke.py and the tests share.
#
# pagetable.py  record a page table's op batches, replay them on the
#               sequential oracle in serve order; the stress trace
# attention.py  hold every paged-attention kernel call against the plain
#               version
# model.py      hold every flash-attention kernel call against the plain
#               version; keep the serve's decode logits at a position;
#               prefill against decode logits
# serve.py      the serve kernels' far-winner flags
# failover.py   kv_mixed waves with a trustee killed (or a wave torn) and
#               the page table's chaos run, against their oracles
# train.py      gradients leaf by leaf, the experts a MoE call fed, the
#               gradient-combine battery and its replay
# dataaxis.py   a sub-axis KV store's rounds, each data row its own
#               stream, held to a sequential oracle per data row
