"""Job spec frontend: HCL -> structs.Job (reference: jobspec/parse.go).

Copied from nomad_tpu/jobspec/__init__.py; only the imports differ.
"""

from .parse import parse_job, parse_job_file, parse_duration  # noqa: F401
from .hcl import parse as parse_hcl, HCLParseError  # noqa: F401
