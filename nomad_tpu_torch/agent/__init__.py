"""Agent: composes Server and/or Client with the HTTP API (reference:
command/agent/agent.go).

Copied from nomad_tpu/agent/__init__.py; only the imports differ.
"""

from .agent import Agent, AgentConfig  # noqa: F401
from .http import HTTPServer  # noqa: F401
