# repro_torch.core — Trust<T> delegation over stacked shards on one device.
#
# meshctx.py   StackedMesh (the JAX mesh's shards as a leading tensor dim),
#              a trustee group's shard order (group_order), default
#              device, ambient mesh + batch axes + TrustSession
# routing.py   key -> trustee routers (mod, block, page, hash) + workload
#              generators + expected_max_load
# opspec.py    Field/OpSpec/TrustSchema, typed op handles, call-time checks
# channel.py   pack/transmit/serve/respond/unpack over stacked shards;
#              delegate, delegate_async (the response half deferred to
#              DelegationFuture.wait()), delegate_drain
# trust.py     TrusteeGroup / Trust / TrustFuture
# engine.py    DelegationEngine / TrustSession — executes the rounds
# kvstore.py   DelegatedKVStore + make_kv_schema / make_kv_ops (paper §6.3)
# lockstore.py FetchRMWStore / AtomicAddStore lock baselines,
#              SequentialKVReference oracle + conflict_ranks
# pagetable.py DelegatedPageTable + make_pagetable_schema (paged KV cache)
#              + SequentialPageTable oracle + pagetable_reshard
# nested.py    launch_serve — nested delegation (the paper's launch())
from .opspec import (Combine, Field, ListField, OpSpec, SchemaError,
                     TrustSchema)
from .channel import (ChannelConfig, ChannelInfo, DelegatedOp,
                      DelegationFuture, Grouping, Packed, Received,
                      check_response_structs, collect_impl_events,
                      collect_transposes, delegate, delegate_async,
                      delegate_drain, make_grouping, pack,
                      report_impl_event, respond, serve_multiplex,
                      serve_multiplex_strided, serve_optable, transmit,
                      unpack)
from .engine import (CapacityPlanner, DelegationEngine, TrustSession,
                     check_payload_fields)
from .trust import Trust, TrusteeGroup, TrustFuture, local_trustees
from .kvstore import (DelegatedKVStore, kv_reshard, make_kv_ops,
                      make_kv_schema)
from .lockstore import (AtomicAddStore, FetchRMWStore, SequentialKVReference,
                        conflict_ranks, pad_writes)
from .pagetable import (DelegatedPageTable, SequentialPageTable,
                        initial_pagetable_state, make_pagetable_schema,
                        pagetable_reshard)
from .meshctx import (StackedMesh, batch_axes, constrain, current_mesh,
                      current_session, delegation_mode, group_coords,
                      group_order, resolve_device, set_batch_axes,
                      set_context, set_delegation_mode, set_mesh,
                      set_session, survivors_mesh, use_mesh, use_session)
from .routing import (block_router, expected_max_load, hash_router,
                      mod_router, page_router, partition_clients_trustees,
                      trustee_device_slot)
from .nested import launch_serve

__all__ = [
    "Combine", "Field", "ListField", "OpSpec", "SchemaError", "TrustSchema",
    "ChannelConfig", "ChannelInfo", "DelegatedOp", "DelegationFuture",
    "Grouping", "Packed", "Received", "check_response_structs",
    "collect_impl_events", "collect_transposes", "delegate",
    "delegate_async", "delegate_drain", "make_grouping", "pack",
    "report_impl_event", "respond", "serve_multiplex",
    "serve_multiplex_strided", "serve_optable", "transmit", "unpack",
    "CapacityPlanner", "DelegationEngine", "TrustSession",
    "check_payload_fields", "Trust", "TrusteeGroup", "TrustFuture",
    "local_trustees", "DelegatedKVStore", "kv_reshard", "make_kv_ops",
    "make_kv_schema",
    "AtomicAddStore", "FetchRMWStore", "SequentialKVReference",
    "conflict_ranks", "pad_writes",
    "DelegatedPageTable", "SequentialPageTable", "initial_pagetable_state",
    "make_pagetable_schema", "pagetable_reshard",
    "StackedMesh", "batch_axes", "constrain", "current_mesh",
    "current_session", "delegation_mode", "group_coords", "group_order",
    "resolve_device", "set_batch_axes", "set_context",
    "set_delegation_mode", "set_mesh", "set_session", "survivors_mesh",
    "use_mesh", "use_session",
    "block_router", "expected_max_load", "hash_router", "mod_router",
    "page_router", "partition_clients_trustees", "trustee_device_slot",
    "launch_serve",
]
