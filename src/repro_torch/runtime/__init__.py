"""Control-plane runtime: gossip sync, membership, elasticity (PyTorch)."""

from repro_torch.runtime.gossip import (GossipNode, LocalTransport, Store,
                                        converged, sync_round)
from repro_torch.runtime.membership import (HEARTBEATS, MEMBERS, ElasticPlan,
                                            FailureDetector, beat,
                                            join_cluster, plan_from_view,
                                            register_membership)

__all__ = ["ElasticPlan", "FailureDetector", "GossipNode", "HEARTBEATS",
           "LocalTransport", "MEMBERS", "Store", "beat", "converged",
           "join_cluster", "plan_from_view",
           "register_membership", "sync_round"]
