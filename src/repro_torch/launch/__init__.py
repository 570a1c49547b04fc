# repro_torch.launch — drivers and entry points.
#
# streaming.py     StreamingDriver / AdmissionControl / WaveHandle
#                  (dispatch-ahead engine rounds)
# paged_serve.py   PagedDecodeDriver / DecodeRequest (continuous-batching
#                  decode over the delegated page table)
# paged_decode.py  run_decode — the paged-decode entry point
# mesh.py          make_local_mesh / make_production_mesh / mesh_config —
#                  JAX's meshes as StackedMeshes
# steps.py         train_step / prefill_step / serve_step and build_cell
#                  (the model path); value_and_grad of forward_loss
# serve.py         main — the model serve entry point (teacher-forced
#                  prompt, greedy decode over the trustee-sharded KV cache)
# train.py         main — the training entry point (the train cell, the
#                  token pipeline, the fault-tolerant TrainLoop)
# rooflines.py     the H100's peaks, the whole-step roofline terms and
#                  report, one bound function a kernel (``*_work``)
# dryrun.py        run_cell / main — every (arch x shape x mesh) cell built
#                  and counted on the meta device (nothing allocated)
