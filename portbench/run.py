"""Runs one cell of ``BENCHMARK.json`` once on the CUDA card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. Prints progress and, as its last lines, each
number that decides ``correct`` beside its limit on standard error, and
one JSON object as the last line of standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``compared``. Exits non-zero with no result line
when there is no CUDA card, fewer than the cell asks for, or when JAX or
the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import spec
    from portbench.guard import forbidden_modules
    from portbench.harness import log, log_compared, run_cell

    cell = spec.cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        log("no CUDA device: nothing was run")
        return 3
    if torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA devices, "
            f"{torch.cuda.device_count()} visible: nothing was run")
        return 3
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result, verdict = run_cell(cell, args.seed, args.seconds,
                               bool(args.trace), device, T_START)
    found = forbidden_modules()
    if found:
        log(f"the run loaded forbidden modules: {', '.join(found)}")
        return 4
    log_compared(verdict)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
