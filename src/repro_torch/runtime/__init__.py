# repro_torch.runtime — failure injection and the fault-tolerant loops.
from .fault_tolerance import (ElasticPlan, EngineFailureInjector,
                              FailureInjector, SimulatedFailure,
                              StragglerMonitor, TrainLoop, TrainLoopConfig,
                              TrusteeFailure, delegation_elastic_plan)
