"""Run one cell of the port's benchmark once and print its result line.

    python3 -m port_bench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``port_bench/``
and the package ``lowlight_image_enhancement_tpu_torch``. The run makes
its inputs and weights from ``--seed``, warms up the cell's shapes
(set-up), measures for ``--seconds`` (``--trace 1``: then traces a few
more units under the profiler), checks what the timed path produced
against the plain reference under ``port_bench/reference/``, and prints
one JSON line as the last line of standard output: the cell's end-to-end
metrics (``--trace 0``) or per-layer metrics (``--trace 1``). The numbers
compared and their limits are the last lines of standard error and the
line's last key, ``checks``.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

# the measured package's JAX original and its libraries must not load
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "lowlight_image_enhancement_tpu")


def cache_env(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port's nvcc products already go to ``build/``)."""
    build = root / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton_cache")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def finite(x):
    """JSON has no infinity: a reading that never came reads 1e30."""
    return x if x is None or math.isfinite(x) else 1e30


def judge(checks: dict, limits: dict, attempted: int, failed: int) -> bool:
    """``correct``: every limited number read and within its limit, some
    units attempted and none failed."""
    return bool(checks) and all(
        k in checks and checks[k] <= v for k, v in limits.items()) \
        and failed == 0 and attempted > 0


def result_line(cell, run, attempted: int, failed: int, trace: bool,
                checks: dict, limits: dict, device_name: str) -> dict:
    from port_bench.harness.spec import metric_reader

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = metric_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = judge(checks, limits, attempted, failed)
    device = {"platform": "gpu", "kind": device_name, "count": cell.chips,
              "memory_peak_bytes": run.memory_peak_bytes}
    checks = {k: finite(v) for k, v in checks.items()}
    line = {"correct": correct, "attempted": attempted, "failed": failed,
            "metrics": metrics, "device": device}
    if trace and run.trace is not None:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        line["breakdown"] = run.trace.breakdown()
    line["checks"] = {k: {"value": checks.get(k), "limit": v}
                      for k, v in limits.items()}
    return line


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t0: float = T0):
    """``(run, attempted, failed, readings)`` of one run of ``cell``."""
    import torch

    from port_bench.harness.record import log
    from port_bench.harness.serve import run_serve
    from port_bench.harness.train import run_train

    run_kind = {"serve": run_serve, "train": run_train}[cell.traffic["kind"]]
    tmpdir = tempfile.mkdtemp(prefix="port_bench_")
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        run, attempted, failed, check = run_kind(
            cell, seed, seconds, trace, device, t0, tmpdir)
        ms = sorted((u.end - u.start) * 1e3 for u in run.units)
        log(f"window closed: {attempted} units in {run.window_s:.3f} s, "
            f"set-up {run.setup_s:.3f} s; unit ms min {ms[0]:.1f} median "
            f"{ms[len(ms) // 2]:.1f} max {ms[-1]:.1f}")
        shutil.rmtree(tmpdir, ignore_errors=True)
        # the reference runs in fp32 proper
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        t = time.perf_counter()
        readings = check()
        log(f"check took {time.perf_counter() - t:.3f} s")
        return run, attempted, failed, readings
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
        shutil.rmtree(tmpdir, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path.cwd()
    cache_env(root)

    from port_bench.harness.spec import load_cell

    cell = load_cell(args.workload, root)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"port_bench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        import lowlight_image_enhancement_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"port_bench: the measured package is missing: {e}",
              file=sys.stderr)
        return 3
    run, attempted, failed, readings = run_cell(
        cell, args.seed, args.seconds, bool(args.trace), "cuda")
    found = forbidden_modules()
    if found:
        print(f"port_bench: modules that must not load were loaded: {found}",
              file=sys.stderr)
        return 4
    line = result_line(cell, run, attempted, failed, bool(args.trace),
                       readings, cell.limits, torch.cuda.get_device_name(0))
    info = {k: v for k, v in readings.items() if k not in cell.limits}
    if info:
        print(f"port_bench: also read {json.dumps(info)}", file=sys.stderr)
    for k, c in line["checks"].items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
