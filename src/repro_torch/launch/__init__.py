# repro_torch.launch — drivers and entry points.
#
# streaming.py     StreamingDriver / AdmissionControl / WaveHandle
#                  (dispatch-ahead engine rounds)
# paged_serve.py   PagedDecodeDriver / DecodeRequest (continuous-batching
#                  decode over the delegated page table)
# paged_decode.py  run_decode — the paged-decode entry point
