"""Run one cell of the port's benchmark once and print its result's line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is a workload of BENCHMARK.json at the root of the checkout; its
configuration, traffic mix, request kind and metric readers are files
under portbench/ found by name (portbench/README.md). The run needs an
NVIDIA card: without one it exits with 2 and prints no result.
"""

import time

T_PROCESS = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench.harness import check, result, spec

    cell = spec.Cell(args.workload, spec.load_benchmark(ROOT))
    want = cell.work["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < want:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {want} CUDA card(s), this "
              f"machine has {n}; no result", file=sys.stderr)
        return 2
    try:
        import nomad_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"portbench: the program under test is missing ({e}); no "
              f"result", file=sys.stderr)
        return 2

    from portbench.harness import runner

    out = runner.execute(cell, args.seed, args.seconds, bool(args.trace),
                         "cuda", T_PROCESS)
    bad = result.forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}; no result",
              file=sys.stderr)
        return 3
    numbers = out["numbers"]
    checks = check.verdict(numbers)
    ok = check.correct(checks)
    print(result.summary(cell, args.seed, out, card_line()),
          file=sys.stderr)
    if out["replay"].worst is not None:
        print(f"portbench: widest score gap at {out['replay'].worst}",
              file=sys.stderr)
    line = result.line(cell, out, bool(args.trace), ok, checks,
                       torch.cuda.get_device_name(0), want)
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
