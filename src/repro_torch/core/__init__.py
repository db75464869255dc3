"""Seer core of the port: divided rollout, context-aware scheduling,
grouped speculative decoding, open-loop serving and the cluster
simulator.  The scheduling, pool, CST/DGDS, cost model, fault, workload
(arrival processes, tenant limits, SLO admission, ``serve``) and
simulator modules are copies of ``repro.core``'s pure-Python modules."""
from repro_torch.core.context import ContextManager, GroupContext
from repro_torch.core.cst import DraftPath, GroupCST, SuffixTree
from repro_torch.core.dgds import DraftClient, DraftServer, SpeculationArgs
from repro_torch.core.faults import FaultEvent, FaultInjector
from repro_torch.core.kvpool import GlobalKVPool, PoolCosts
from repro_torch.core.mba import MBAConfig, mba_speculation
from repro_torch.core.request import (Group, ReqState, RolloutRequest,
                                      make_groups)
from repro_torch.core.rollout import RolloutResult, RolloutStats, SeerRollout
from repro_torch.core.scheduler import InstanceView, Scheduler
from repro_torch.core.sdmodel import (H800, TPU_V5E, ForwardCostModel,
                                      HardwareSpec, SDThroughputModel)
from repro_torch.core.workload import (Arrival, ArrivalFeed, ArrivalProcess,
                                       ArrivalQueue, ArrivalSpec,
                                       LengthSampler, PoissonArrivals,
                                       TenantRateLimiter, TenantSpec,
                                       TraceArrivals, latency_percentiles,
                                       serve)

__all__ = [
    "ContextManager", "GroupContext", "DraftPath", "GroupCST", "SuffixTree",
    "DraftClient", "DraftServer", "SpeculationArgs", "FaultEvent",
    "FaultInjector", "GlobalKVPool", "PoolCosts", "MBAConfig",
    "mba_speculation", "Group", "ReqState", "RolloutRequest", "make_groups",
    "RolloutResult", "RolloutStats", "SeerRollout", "InstanceView",
    "Scheduler", "H800", "TPU_V5E", "ForwardCostModel", "HardwareSpec",
    "SDThroughputModel",
    "Arrival", "ArrivalFeed", "ArrivalProcess", "ArrivalQueue",
    "ArrivalSpec", "LengthSampler", "PoissonArrivals", "TenantRateLimiter",
    "TenantSpec", "TraceArrivals", "latency_percentiles", "serve",
]
