"""Faults planted underneath a run's timed path, to show that the check
that decides `correct` catches them, and to read the control's numbers.

    python3 portbench/faults.py --workload <cell> --seed <n> \
        --seconds <s> --fault <unchanged|half|altered>

runs the cell as `run.py` does, with the fault planted in the program
for the whole run, and prints the check's numbers. The benchmark's own
runs never plant one.

- `unchanged`: the node table's refresh (K4b) returns the card's table
  unchanged, so the rows a commit dirtied keep their old usage there;
- `half`: every committed batch of placements loses its second half
  before the state store applies it (a scheduler that leaves half of its
  batch out and still completes the evaluation);
- `altered`: answers changed where they enter the plans (c3: in every
  16th evaluation the plan build reads, the kernels' first chosen row
  moved onto the row of its second placement, a node its job already
  holds: one anti-affinity slip, few enough that the workers' chain
  rarely has to re-run what it placed behind one; system sweeps: the
  first placed node's allocation moved onto the second's in each
  commit). For c3 this is the control whose readings set the score gap's
  limit.
"""

import argparse
import itertools
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FAULTS = ("unchanged", "half", "altered")


def plant(fault: str):
    """Patch the program in this process; returns a function that undoes
    the patch."""
    from nomad_tpu_torch.scheduler import stack as stack_mod
    from nomad_tpu_torch.server import fsm as fsm_mod
    from nomad_tpu_torch.server.fsm import MessageType
    from nomad_tpu_torch.tensor import node_table

    undo = []

    def swap(obj, name, new):
        old = getattr(obj, name) if not isinstance(obj, dict) else obj[name]
        if isinstance(obj, dict):
            obj[name] = new
            undo.append(lambda: obj.__setitem__(name, old))
        else:
            setattr(obj, name, new)
            undo.append(lambda: setattr(obj, name, old))
        return old

    if fault == "unchanged":
        swap(node_table.NodeTensor, "_refresh",
             lambda self, d, chunk, size: None)
    elif fault == "half":
        def halve(handler):
            def apply(self, index, req):
                for group in req.get("Batch") or [req]:
                    sweep = group.get("Sweep")
                    if sweep is not None:
                        h = (len(sweep["RowNodeIDs"]) + 1) // 2
                        k = sum(sweep["Counts"][:h])
                        for key in ("RowNodeIDs", "Counts", "Rows",
                                    "Delta"):
                            sweep[key] = list(sweep[key])[:h]
                        for key in ("AllocIDs", "Names", "TGIdx"):
                            sweep[key] = list(sweep[key])[:k]
                    elif group.get("Alloc"):
                        allocs = list(group["Alloc"])
                        placed = [a for a in allocs
                                  if getattr(a, "DesiredStatus", "run")
                                  == "run"]
                        drop = {id(a) for a in placed[len(placed) // 2:]}
                        group["Alloc"] = [a for a in allocs
                                          if id(a) not in drop]
                return handler(self, index, req)
            return apply
        for mt in (MessageType.ApplySweepBatch, MessageType.AllocUpdate):
            swap(fsm_mod._HANDLERS, mt, halve(fsm_mod._HANDLERS[mt]))
    elif fault == "altered":
        collect = stack_mod.GenericStack.collect_build
        calls = itertools.count()

        def altered_collect(self, prep, cr, *args, **kwargs):
            ch = cr.chosen
            if (next(calls) % 16 == 0 and len(ch) > 1 and ch[0] >= 0
                    and ch[1] >= 0 and ch[0] != ch[1]):
                ch = ch.copy()
                ch[0] = ch[1]
                cr = cr._replace(chosen=ch)
            return collect(self, prep, cr, *args, **kwargs)
        swap(stack_mod.GenericStack, "collect_build", altered_collect)
        sweep_handler = fsm_mod._HANDLERS[MessageType.ApplySweepBatch]

        def altered_sweep(self, index, req):
            for group in req.get("Batch") or [req]:
                sweep = group.get("Sweep")
                if sweep is not None and sweep.get("Kind") == "system" \
                        and len(sweep["RowNodeIDs"]) > 1:
                    ids = list(sweep["RowNodeIDs"])
                    ids[0] = ids[1]
                    sweep["RowNodeIDs"] = ids
                    break
            return sweep_handler(self, index, req)
        swap(fsm_mod._HANDLERS, MessageType.ApplySweepBatch, altered_sweep)
    else:
        raise ValueError(f"unknown fault {fault!r}")

    def restore():
        for fn in reversed(undo):
            fn()
    return restore


def main(argv=None) -> int:
    t_process = time.monotonic()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--fault", choices=FAULTS, required=True)
    args = ap.parse_args(argv)

    import torch

    from portbench.harness import check, result, runner, spec

    if not torch.cuda.is_available():
        print("faults: no CUDA card", file=sys.stderr)
        return 2
    cell = spec.Cell(args.workload, spec.load_benchmark(ROOT))
    restore = plant(args.fault)
    try:
        out = runner.execute(cell, args.seed, args.seconds, False, "cuda",
                             t_process)
    finally:
        restore()
    checks = check.verdict(out["numbers"])
    print(result.summary(cell, args.seed, out, "the card"), file=sys.stderr)
    print(f"faults: widest score gap at {out['replay'].worst}",
          file=sys.stderr)
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "fault": args.fault,
                      "correct": check.correct(checks),
                      "numbers": out["numbers"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
