"""Worlds of the port's processes for the mesh-layer tests.

Each rank is a child process that joins a gloo world over loopback
(``tamp_tpu_torch.parallel.distributed.initialize``; a world of one makes
its own in ``make_mesh``), so no process group outlives a test in the
pytest worker.  A child runs ``body`` after the join, with ``WORLD``,
``RANK`` and ``TMP`` (a directory shared with the parent) defined, and
fails if it imported anything of JAX or of the JAX package.
"""

import os
import socket
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

HEAD = """
import sys
sys.path.insert(0, {root!r})
WORLD, RANK, TMP = {world}, {rank}, {tmp!r}
from tamp_tpu_torch.parallel.distributed import initialize
initialize({addr!r} if WORLD > 1 else None, WORLD, RANK, device="cpu")
"""

TAIL = """
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "tamp_tpu")]
if bad:
    sys.exit(f"the port's process imported {bad[:5]}")
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(body: str, world: int, tmp) -> list:
    """Start the ``world`` ranks running ``body``; returns their processes."""
    addr = f"127.0.0.1:{_free_port()}"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "2"  # the suite runs several workers at once
    return [subprocess.Popen(
        [sys.executable, "-c", HEAD.format(root=ROOT, world=world, rank=rank,
                                           tmp=str(tmp), addr=addr)
         + body + TAIL],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(world)]


def wait(procs, timeout: float = 300) -> None:
    """Wait for every rank (killing all at ``timeout`` seconds in all) and
    fail with their output unless each exited 0."""
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic())))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, (so, se)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{so}\n{se}"
