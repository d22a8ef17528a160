"""Typed HTTP API client (reference: api/).

Copied from nomad_tpu/api/__init__.py; only the imports differ.
"""

from .client import (  # noqa: F401
    APIError,
    Agent as AgentAPI,
    AllocFS,
    Allocations,
    BackpressureAPIError,
    Client,
    Evaluations,
    EventGapAPIError,
    Jobs,
    Nodes,
    QueryOptions,
    Regions,
    System,
    WriteOptions,
)
