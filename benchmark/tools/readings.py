"""The readings a cell's limit is set from, on the card, in one process:
the program's sound readings over many seeds (a short window at the
cell's own load each, the same check as a run), and the control's (the
plain reference in bfloat16 put in the program's place, judged by the
float32 reference on the same frames and pixels).

    python benchmark/tools/readings.py --workload <cell> --seeds 1,2,3 \\
        --seconds 3 --control 3 [--out FILE]

One JSON line a seed: the seed, the frames checked, each number with
the program and, for the first ``--control`` seeds, the control, and
the reference's seconds. The benchmark's runs never run this.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [HERE, ROOT]

import torch  # noqa: E402

from yardstick import check, drivers, runner  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 3
    seeds = [int(s) for s in args.seeds.split(",")]
    c = runner.load_cell(ROOT, HERE, args.workload, "cuda")
    prog = runner.build_program(c)
    frames_checked = int(c.traffic["check"]["frames"])
    out = open(args.out, "a") if args.out else None
    for i, seed in enumerate(seeds):
        d = runner.draw(c, seed)
        off = drivers.Profiler(False, 0, 0.0, 0, "cuda")
        win = runner.timed_window(c, prog, d, args.seconds, off)
        chosen = check.choose_frames(win.frames, frames_checked, d.rng)
        t = time.perf_counter()
        program, _, _ = runner.judge(c, chosen, d.pick)
        line = {"workload": args.workload, "seed": seed,
                "frames": [f.index for f in chosen], "pixels": len(d.pick),
                "program": program, "reference_s": time.perf_counter() - t,
                "window_frames": len(win.frames)}
        if i < args.control:
            t = time.perf_counter()
            ctrl, _, _ = runner.judge(c, chosen, d.pick,
                                      dtype=torch.bfloat16)
            line["control"] = ctrl
            line["control_dtype"] = "bfloat16"
            line["control_s"] = time.perf_counter() - t
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
