#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port ``tamp_tpu_torch``.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

runs one cell of ``BENCHMARK.json`` on the card this process sees
(``portbench/harness/main.py`` says how) and prints, as its last line, one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``, each
number the reference compared beside its limit.  Without a card it exits
nonzero and prints no result; ``--device cpu --shard-bytes N`` rehearses
a cell on the kernels' plain versions at a tiny size.
"""

import os
import sys
import time

T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
# every build and kernel cache inside the checkout, at fixed paths (the
# port's own nvcc builds go to build/tamp_tpu_torch/, fixed in its code);
# the bytecode of every module imported from here on too, this process's
# and the reference's workers', so that only a checkout's first run
# compiles the Python of torch and numpy (an installation may ship none)
CACHE = os.path.join(ROOT, "build", "portbench-cache")
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("PYTHONPYCACHEPREFIX", "pyc")):
    os.environ[var] = os.path.join(CACHE, sub)
sys.pycache_prefix = os.environ["PYTHONPYCACHEPREFIX"]
sys.dont_write_bytecode = False
os.environ.pop("PYTHONDONTWRITEBYTECODE", None)

if __name__ == "__main__":
    from portbench.harness.main import main

    sys.exit(main(sys.argv[1:], t0=T0))
