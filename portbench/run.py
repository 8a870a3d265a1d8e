"""One run of one cell: the command line, the checks around the run, and
the result line.

The run exits with a code other than 0, and prints no result, when the
card or cards the cell asks for are missing, when the program cannot be
imported (a checkout without it), or when a module of JAX or of the JAX
package is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from dataclasses import dataclass

FORBIDDEN = ("jax", "jaxlib", "flax", "orbax", "kube_sqs_autoscaler_tpu")


def _process_start() -> float:
    """When this process started, on the ``time.perf_counter`` clock
    (from ``/proc``: clock ticks since boot, against the uptime)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.perf_counter() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.perf_counter()


PROCESS_START = _process_start()


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: ``kube_sqs_autoscaler_tpu_torch`` is not one)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


def _fixed_caches(root) -> None:
    """Every compile cache at a fixed path inside the checkout (the
    port's nvcc builds already land in ``build/kernels`` there)."""
    build = root / "build"
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_extensions"))
    os.environ.setdefault("CUDA_CACHE_PATH", str(build / "cuda_cache"))
    # libraries that would load JAX on their own stay off it
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")


@dataclass
class Context:
    """What a driver reads: the cell, the run's arguments, the sizes."""

    cell: object
    sizes: object
    seed: int
    seconds: float
    trace: bool
    device: object
    process_start: float
    # also read the float8 control on the checked sample (calibration only)
    control: bool = False


def execute(cell, seed: int, seconds: float, trace: bool, device,
            sizes=None, process_start: float | None = None) -> dict:
    """Run ``cell`` once and return the result line's object (tests call
    this on the CPU with small ``sizes``)."""
    from portbench import correct, models, spec

    mix = cell.traffic
    if sizes is None:
        sizes = models.sizes(cell.config,
                             mix["bucket"] + mix["generate_tokens"])
    ctx = Context(cell=cell, sizes=sizes, seed=seed, seconds=seconds,
                  trace=trace, device=device,
                  process_start=(PROCESS_START if process_start is None
                                 else process_start))
    out = spec.driver(mix["driver"]).run(ctx)
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"])(out["record"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out["end_to_end"][m["name"]],
                               "unit": m["unit"]} for m in cell.end_to_end}
    result = {
        "correct": correct.passed(out["checks"]),
        "attempted": out["attempted"],
        "failed": out["failed"],
        "metrics": metrics,
        "device": {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": _device_name(device), "count": cell.chips,
                   "memory_peak_bytes": out["memory_peak_bytes"]},
        "generator_late_ms_max": out["generator_late_ms_max"],
        "host": out["host"],
    }
    if trace:
        summary = out["record"]["summary"]
        result["device"]["busy_s"] = summary.busy_s
        result["device"]["window_s"] = summary.window_s
        result["breakdown"] = summary.breakdown()
    result["checks"] = out["checks"]
    return result


def _device_name(device) -> str:
    import torch

    return torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="python -m portbench")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from portbench import spec

    _fixed_caches(spec.ROOT)
    cell = spec.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count()={torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = execute(cell, args.seed, args.seconds, bool(args.trace),
                     torch.device("cuda", 0))
    found = forbidden_modules()
    if found:
        print(f"portbench: loaded in the measuring process: {found}",
              file=sys.stderr)
        return 3
    for name, (value, limit) in result["checks"].items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0
