"""Unified topology-schedule event engine (port of
``gossipprotocol_tpu/events/``).

One declarative surface for everything that changes the world at chunk
boundaries: fault strikes (utils/faults.py), overlay repair
(topology/repair.py), and edge-level churn — timed ``add_edges`` /
``remove_edges`` / ``swap_neighbors`` plus a seeded synthetic churn
generator. The legacy ``--fault-plan``/``--fail-*``/``--repair`` flags
compile down to this engine; event plans add the new axis on top.

* :mod:`gossipprotocol_tpu_torch.events.plan` — the declarative data model
  (:class:`EventPlan`, :class:`ChurnSpec`), JSON parsing, churn
  generation, and edge-event application;
* :mod:`gossipprotocol_tpu_torch.events.engine` — :class:`HostEvents`, the
  chunk-boundary pipeline the drive loop executes, and the bitwise
  resume replay (:func:`replay_topology`).
"""

from gossipprotocol_tpu_torch.events.plan import (  # noqa: F401
    CHURN_MODELS,
    VALUE_FAULT_MODELS,
    ChurnSpec,
    EventPlan,
    ValueFaultSpec,
    apply_edge_events,
    as_plan,
    generate_churn,
    parse_churn_arg,
    parse_event_plan,
    parse_value_faults_arg,
    value_fault_ids,
)
from gossipprotocol_tpu_torch.events.engine import (  # noqa: F401
    HostEvents,
    replay_topology,
    replay_topology_events,
)

__all__ = [
    "CHURN_MODELS",
    "VALUE_FAULT_MODELS",
    "ChurnSpec",
    "EventPlan",
    "HostEvents",
    "ValueFaultSpec",
    "apply_edge_events",
    "as_plan",
    "generate_churn",
    "parse_churn_arg",
    "parse_event_plan",
    "parse_value_faults_arg",
    "replay_topology",
    "replay_topology_events",
    "value_fault_ids",
]
