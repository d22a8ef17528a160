"""Command line interface (reference: command/, commands.go).

Copied from nomad_tpu/cli/__init__.py; only the imports differ.
"""

from .commands import main  # noqa: F401
