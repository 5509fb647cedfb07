"""Readings for the limits that decide ``correct``, many seeds in one
process (the set-up of a process is paid once).

    python3 portbench/readings.py --workload <cell> --side program \\
        --seeds 11,12,13 --seconds 3
    python3 portbench/readings.py --workload <cell> --side control \\
        --seeds 11,12,13 --seconds 3

``program`` runs the cell as ``run.py`` does (its build, window and
judgement) on each seed and prints each seed's compared numbers;
``control`` puts the reference computed in bfloat16 in the program's place
(``reference/control.py``), which has to come out not correct. One JSON
line a seed on standard output. The benchmark's own runs do not run this.
"""

import argparse
import gc
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--side", choices=("program", "control"),
                    required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)

    import torch

    from portbench import spec
    from portbench.guard import forbidden_modules
    from portbench.harness import log, run_cell

    if not torch.cuda.is_available():
        log("no CUDA device: nothing was run")
        return 3
    cell = spec.cell(args.workload)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    if args.side == "control":
        from portbench.reference.control import Control
        program = Control()
    else:
        program = None
    for seed in (int(s) for s in args.seeds.split(",")):
        result, verdict = run_cell(cell, seed, args.seconds, False, device,
                                   time.perf_counter(), program=program)
        print(json.dumps({"workload": args.workload, "side": args.side,
                          "seed": seed, "correct": verdict.correct,
                          "compared": verdict.numbers,
                          "metrics": result["metrics"]}), flush=True)
        del result, verdict
        gc.collect()
        torch.cuda.empty_cache()
    found = forbidden_modules()
    if found:
        log(f"the run loaded forbidden modules: {', '.join(found)}")
        return 4
    return 0


if __name__ == "__main__":
    sys.exit(main())
