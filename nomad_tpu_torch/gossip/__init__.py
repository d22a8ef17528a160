"""Gossip membership plane (reference: hashicorp/serf + memberlist,
consumed by nomad/serf.go).

Copied from nomad_tpu/gossip/__init__.py; only the imports differ.
"""

from .memberlist import (
    ALIVE,
    DEAD,
    EVENT_FAILED,
    EVENT_JOIN,
    EVENT_LEAVE,
    EVENT_UPDATE,
    LEFT,
    SUSPECT,
    GossipConfig,
    Member,
    Memberlist,
)

__all__ = [
    "Memberlist", "Member", "GossipConfig",
    "ALIVE", "SUSPECT", "DEAD", "LEFT",
    "EVENT_JOIN", "EVENT_LEAVE", "EVENT_FAILED", "EVENT_UPDATE",
]
