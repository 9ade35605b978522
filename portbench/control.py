"""The readings the limits of ``correct`` are set from, on the card.

    python3 -m portbench.control --workload <name> --seeds 1,2,3 --seconds <s>

For each seed, in one process (the set-up of imports, CUDA and the kernel
builds paid once): one run of the cell as ``portbench.run`` makes it, at
the cell's own traffic and sizes, whose compared numbers are the program's
readings; and, on the same sample of requests, the control, the reference
one precision below the configuration's (float8 e4m3 for its bfloat16,
``reference/encoder.py``), read by the same comparison and held to the
same limits (``run.gate``): the control has to come out not correct. One
JSON line per seed, then one with the largest program reading, the
smallest control reading of each number, and the seeds on which the
control came out correct (there should be none). The benchmark's own runs
never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    from portbench.run import Refused, execute
    from portbench.spec import ROOT, Spec

    spec = Spec(ROOT)
    lower: dict = {}
    upper: dict = {}
    control_passed: list = []
    for seed in (int(s) for s in args.seeds.split(",")):
        try:
            result = execute(spec, args.workload, seed, args.seconds, False,
                             control=True)
        except Refused as exc:
            print(f"portbench.control: {exc}", file=sys.stderr)
            return exc.code
        info = result.pop("_info")
        low = result.pop("_control")
        program = {k: c["value"] for k, c in result["checks"].items()}
        control = {k: c["value"] for k, c in low["checks"].items()}
        for k, v in program.items():
            lower[k] = max(lower.get(k, v), v)
        for k, v in control.items():
            upper[k] = min(upper.get(k, v), v)
        if low["correct"]:
            control_passed.append(seed)
        print(json.dumps({"seed": seed, "correct": result["correct"],
                          "control_correct": low["correct"],
                          "program": program, "control": control,
                          "metrics": {k: m["value"] for k, m in
                                      result["metrics"].items()},
                          "info": info}), flush=True)
    print(json.dumps({"workload": args.workload, "lower": lower,
                      "upper": upper, "control_correct_on": control_passed}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
