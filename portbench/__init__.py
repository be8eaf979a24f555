"""The benchmark of the port ``tamp_tpu_torch`` (``BENCHMARK.json``); its
command is ``python3 portbench/run.py``."""
