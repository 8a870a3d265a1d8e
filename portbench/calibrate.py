"""Readings for the limits that decide ``correct``, and for the knee of a
rate mix: many seeds or rates in one process, so the set-up of the card
is paid once.

    python -m portbench.calibrate --workload <cell> --seeds 1,2,3 --seconds 8
    python -m portbench.calibrate --workload <cell> --seeds 1 --seconds 20 \\
        --rates 6,8,10

Each run prints one JSON line: the program's widest served gap and the
float8 control's on the same sample (``--rates``: the control is not read;
the median latency of each half of the requests due in the window is, to
show a backlog that grows; ``--tail`` caps the wait for the answers of
requests due in the window).  Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m portbench.calibrate")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--rates", default="")
    parser.add_argument("--tail", type=float, default=None)
    parser.add_argument("--out", default="")
    args = parser.parse_args(argv)

    from portbench import models, run, spec

    run._fixed_caches(spec.ROOT)
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = spec.cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    rates = [float(r) for r in args.rates.split(",")] if args.rates else []
    jobs = ([(seed, rate) for rate in rates for seed in seeds] if rates
            else [(seed, None) for seed in seeds])
    mix = cell.traffic
    sizes = models.sizes(cell.config, mix["bucket"] + mix["generate_tokens"])
    out = open(args.out, "a") if args.out else None
    for seed, rate in jobs:
        this = cell
        if rate is not None:
            this = dataclasses.replace(cell, traffic=dict(
                mix, rate=dict(mix["rate"], per_s=rate),
                tail_s=mix["tail_s"] if args.tail is None else args.tail))
        ctx = run.Context(cell=this, sizes=sizes, seed=seed,
                          seconds=args.seconds, trace=False, device=device,
                          process_start=time.perf_counter(),
                          control=rate is None)
        result = spec.driver(mix["driver"]).run(ctx)
        line = {"workload": cell.name, "seed": seed, "seconds": args.seconds,
                "program": result["program_gaps"],
                "control": result["control_gaps"],
                "checks": result["checks"],
                "attempted": result["attempted"], "failed": result["failed"],
                "end_to_end": result["end_to_end"],
                "memory_peak_bytes": result["memory_peak_bytes"],
                "generator_late_ms_max": result["generator_late_ms_max"],
                "host": result["host"]}
        if rate is not None:
            lat = np.asarray(result["latencies_s"]) * 1e3
            half = len(lat) // 2
            line.update(rate=rate, p50_first_half_ms=float(np.median(lat[:half])),
                        p50_second_half_ms=float(np.median(lat[half:])))
        text = json.dumps(line)
        print(text, flush=True)
        if out is not None:
            out.write(text + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
