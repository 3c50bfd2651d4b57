"""The readings that a cell's limits are set from, many seeds in one
process: for each seed the numbers compared for the program (a short
window at the cell's own load), and with --control those of the control,
the reference computed in TF32 in the program's place (the nearest
precision below the configuration's float32 with TF32 off).

    python3 -m portbench.tools.readings --workload <name> --seeds 1,2,3 --seconds 5 [--control]

Prints one JSON line a seed: {"seed", "steps", "program": {...},
"detail": {...}[, "control": {...}, "control_detail": {...}]}; the
details are each leaf's norms, program and reference.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from portbench.reference import model


def readings(workload: str, seed: int, seconds: float, control: bool, device="cuda",
             ref_blocks: tuple = ()) -> dict:
    from portbench import harness

    run = harness.make_run(harness.manifest(), workload, seed, seconds, False, device)
    drv, m, numbers, _ = harness.measure(run, time.time())
    out = {"seed": seed, "steps": len(m.durations), "program": numbers, "detail": drv.detail}
    for rows in ref_blocks:
        # the train reference at another block of rows: its own rounding
        ref = drv._reference(False, dict(run.traffic, reference_block_rows=rows))
        out[f"ref_block_{rows}"] = {
            "change_norms": [float((p - p0).norm()) for p, p0 in zip(ref["params1"], model.leaves(drv.params0))],
            "grad_norms": [float(g.norm()) for g in ref["grads1"]], "losses": ref["losses"]}
    if control:
        out["control"] = drv.compare(tf32=True)
        out["control_detail"] = drv.detail
    del drv, m
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--control-seeds", type=int, default=None,
                   help="the control on the first N seeds only (default: every seed with --control)")
    p.add_argument("--ref-blocks", default="",
                   help="train cells: also each leaf's change from the reference at these blocks of rows")
    args = p.parse_args(argv)
    blocks = tuple(int(b) for b in args.ref_blocks.split(",") if b)
    for i, s in enumerate(args.seeds.split(",")):
        control = args.control and (args.control_seeds is None or i < args.control_seeds)
        print(json.dumps(readings(args.workload, int(s), args.seconds, control, ref_blocks=blocks)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
