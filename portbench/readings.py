"""Readings behind the limits of a cell's comparison, in one process on
the card: the program's numbers on each of ``--seeds``, the control's
(the plain reference in the program's place, computed with TF32, the
next precision below the configuration's f32) on ``--control``, and, for
each of ``--faults`` (``portbench/faults.py``), the program with that
fault planted, on ``--control``'s seeds. Each reading is one JSON line
on stdout and in ``--out``.

    python3 -m portbench.readings --workload <cell> --seconds 3 \
        --seeds 1,2,3 --control 4,5,6 [--faults half_batch] [--out FILE]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time


def _seeds(s):
    return [int(x) for x in s.split(",") if x]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--seeds", type=_seeds, default=[])
    p.add_argument("--control", type=_seeds, default=[])
    p.add_argument("--faults", default="")
    p.add_argument("--out")
    args = p.parse_args(argv)
    from portbench import faults, run
    base = run.parse(["--workload", args.workload, "--seed", "0",
                      "--seconds", str(args.seconds)])
    H, _, cell, torch, dev = run.prepare(base)
    limits = cell["workload"]["limits"]
    out = open(args.out, "a") if args.out else None

    def one(kind, seed, fault=None, control=False):
        base.seed = seed
        t0 = time.perf_counter()
        spans = H.Spans()
        with fault() if fault else contextlib.nullcontext():
            job = cell["driver"].setup(run.Context(base, cell, dev, spans))
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            win = H.closed_loop(torch, job, args.seconds)
            job.release()
            if control:
                torch.backends.cuda.matmul.allow_tf32 = True
                torch.backends.cudnn.allow_tf32 = True
                try:
                    outputs = job.control_outputs(win)
                finally:
                    tf32 = bool(cell["config"]["tf32"])
                    torch.backends.cuda.matmul.allow_tf32 = tf32
                    torch.backends.cudnn.allow_tf32 = tf32
            else:
                outputs = job.program_outputs(win)
            t2 = time.perf_counter()
            samples = job.judge_outputs(outputs)
        rec = {"kind": kind, "seed": seed, "samples": len(samples),
               "detail": [s.get("detail") for s in samples if "detail" in s],
               "numbers": {k: max(s[k] for s in samples) for k in limits},
               "e2e": job.end_to_end(win), "calls": win["calls"],
               "setup_s": t1 - t0, "judge_s": time.perf_counter() - t2}
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
        del job
        torch.cuda.empty_cache()

    for s in args.seeds:
        one("program", s)
    for s in args.control:
        one("control", s, control=True)
    table = faults.FAULTS[cell["workload"]["driver"]]
    for name in filter(None, args.faults.split(",")):
        for s in args.control:
            one(f"fault:{name}", s, fault=table[name])
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
