"""Core library: the paper's contribution (A2CiD2) in PyTorch."""
from .a2cid2 import (ALGORITHM_KINDS, A2CiD2Params, Algorithm, acid_params,
                     apply_mixing, baseline_params, consensus_distance,
                     gradient_event, matched_p2p_update, mixing_coeff,
                     params_from_graph, worker_mean)
from .channel import (ByzantineEdges, ChannelModel, DelayProcess,
                      degradation_profile, has_channel_extras)
from .defense import AdaptiveDefense, DefenseTrace
from .engine import FlatGossipEngine
from .events import (BatchedSchedule, BatchedStream, CoalescedSchedule,
                     EventStream, Schedule, coalesce_schedule,
                     coalesced_stream, concat_schedules, make_schedule,
                     make_topology_schedule, stack_schedules, stack_streams)
from .flatbuf import FlatLayout, LeafSpec
from .gossip import (DelayRing, GossipMixer, WorkerAxis, bank_corruption,
                     bank_edge_rates, check_mesh_channel,
                     consensus_distance_spmd, matching_bank, phase_banks,
                     world_banks)
from .graphs import (Graph, TopologyPhase, TopologySchedule, build_graph,
                     complete_graph, exponential_graph, hypercube_graph,
                     ring_graph, star_graph, torus_graph)
from .simulator import SimState, SimTrace, Simulator
from .world import (SERVE_ARRIVE_KEY, ChurnProcess, LinkModel, PhaseSwitch,
                    RequestTrace, ServeLoad, WorkerModel, World, WorldSweep)

__all__ = [
    "ALGORITHM_KINDS", "A2CiD2Params", "Algorithm", "acid_params",
    "apply_mixing", "baseline_params",
    "consensus_distance", "gradient_event", "matched_p2p_update",
    "mixing_coeff", "params_from_graph", "worker_mean",
    "ByzantineEdges", "ChannelModel", "DelayProcess",
    "degradation_profile", "has_channel_extras",
    "AdaptiveDefense", "DefenseTrace",
    "FlatGossipEngine",
    "BatchedSchedule", "BatchedStream", "CoalescedSchedule", "EventStream",
    "Schedule", "coalesce_schedule", "coalesced_stream", "concat_schedules",
    "make_schedule", "make_topology_schedule", "stack_schedules",
    "stack_streams",
    "FlatLayout", "LeafSpec",
    "DelayRing", "GossipMixer", "WorkerAxis", "bank_corruption",
    "bank_edge_rates", "check_mesh_channel", "consensus_distance_spmd",
    "matching_bank", "phase_banks", "world_banks",
    "Graph", "TopologyPhase", "TopologySchedule", "build_graph",
    "complete_graph", "exponential_graph", "hypercube_graph", "ring_graph",
    "star_graph", "torus_graph",
    "SimState", "SimTrace", "Simulator",
    "SERVE_ARRIVE_KEY", "ChurnProcess", "LinkModel", "PhaseSwitch",
    "RequestTrace", "ServeLoad", "WorkerModel", "World", "WorldSweep",
]
