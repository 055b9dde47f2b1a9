"""Readings that set a cell's correctness limits, for one process on the
chip (the benchmark's own runs never run this):

    python3 -m port_bench.control --workload <name> --seeds 12 \
        --control-seeds 3 --seconds 3 --out <file.jsonl>

For each of ``--seeds`` seeds it runs the cell as the benchmark does (a
``--seconds`` window at the cell's own load) and records the numbers its
check compares: their largest over the seeds is the limit's lower
reading. For ``--control-seeds`` seeds it records the same numbers for the
control (the plain reference computed in fp8, put in the program's place)
and, in training cells, for stand-ins of a broken step (the reference on
half of each batch; its forward on every row and its loss on half; the
gradient's negative handed to the optimizer): the smallest of those is
the upper reading. A state left unchanged reads 1 on the gradient and
update numbers by their definition and needs no run. Each reading is one
JSON line; a training check's worst leaves go to standard error.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

FIRST_SEED = 4100000000


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--first-seed", type=int, default=FIRST_SEED,
                    help="seeds are first-seed + 7919 i (program) and "
                         "first-seed + 104729 (i + 1) (control): move it "
                         "to read further seeds")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    from port_bench.run import cache_env, run_cell

    root = Path.cwd()
    cache_env(root)
    import torch

    from port_bench.harness import serve, train
    from port_bench.harness.spec import load_cell

    if not torch.cuda.is_available():
        print("port_bench.control: no CUDA device", file=sys.stderr)
        return 2
    cell = load_cell(args.workload, root)
    kind = cell.traffic["kind"]
    with open(args.out, "a") as out:
        def emit(row):
            row["workload"] = cell.name
            out.write(json.dumps(row) + "\n")
            out.flush()
            print(json.dumps(row), flush=True)

        for i in range(args.seeds):
            seed = args.first_seed + 7919 * i
            t = time.perf_counter()
            torch.cuda.reset_peak_memory_stats()
            run, attempted, failed, readings = run_cell(
                cell, seed, args.seconds, False, "cuda",
                t0=time.perf_counter())
            emit({"who": "program", "seed": seed, "readings": readings,
                  "attempted": attempted, "failed": failed,
                  "setup_s": run.setup_s,
                  "wall_s": time.perf_counter() - t})
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        for i in range(args.control_seeds):
            seed = args.first_seed + 104729 * (i + 1)
            t = time.perf_counter()
            if kind == "serve":
                rows = {"control_fp8": serve.control_readings(cell, seed,
                                                               "cuda")}
            else:
                rows = train.control_readings(cell, seed, "cuda")
            for who, readings in rows.items():
                emit({"who": who, "seed": seed, "readings": readings,
                      "wall_s": time.perf_counter() - t})
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
