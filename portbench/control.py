#!/usr/bin/env python3
"""The readings a cell's limits are set from: the program's and the
control's numbers on several seeds, in one process.

    python3 portbench/control.py --workload <cell> --seeds a,b,c
        [--seconds S] [--sides program,control]

For each seed, each side runs the cell as ``run.py`` would (set-up, a
window of ``--seconds``, the reference's check), the control putting the
entry point's ``control`` in the program's place: for an encode, the program
with the configuration's ``control`` settings (its own path whose streams
are not the reference greedy encoder's); for a decode, the reference
decoder writing each run whole into the window.  Each reading is one JSON
line: the seed, the side, ``correct`` and every number compared with its
limit.  The benchmark's own runs never run the control.  ``--device cpu
--shard-bytes N --shards K`` rehearse it on the plain versions.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    import argparse

    from portbench.harness.main import execute, parse_args

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", default="3")
    ap.add_argument("--sides", default="program,control")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shard-bytes", default=None)
    ap.add_argument("--shards", default=None)
    a = ap.parse_args(argv)
    for seed in a.seeds.split(","):
        for side in a.sides.split(","):
            argv = ["--workload", a.workload, "--seed", seed, "--seconds",
                    a.seconds, "--device", a.device]
            for flag, v in (("--shard-bytes", a.shard_bytes),
                            ("--shards", a.shards)):
                if v is not None:
                    argv += [flag, v]
            replace = None if side == "program" else \
                (lambda run: run.entry.control(run))
            t = time.perf_counter()
            line = execute(parse_args(argv), t, replace)
            print(json.dumps({
                "seed": int(seed), "side": side, "correct": line["correct"],
                "attempted": line["attempted"], "failed": line["failed"],
                "checks": line["checks"],
                "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
