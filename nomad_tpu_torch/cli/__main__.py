"""CLI entry: python -m nomad_tpu_torch.cli <command> (reference: main.go).

Copied from nomad_tpu/cli/__main__.py; only the module name above
differs.
"""

import sys

from .commands import main

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
