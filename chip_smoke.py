#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tamp_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):

1. the card's name and power limit; build the kernels and the host greedy
   committer from ``csrc/``;
2. each kernel against its plain PyTorch version on the same inputs, at a
   reduced size (2 shards x 64 KiB), exactly: B1 and B2 at windows
   8/10/12/15, and on seeded hazard rows of the long family (repeats of 17
   to LEXT + 20 bytes, the two families at different slots, a tie of long
   matches, periods that put the glue inside a long run, npos off the
   block and below LEXT) at windows 8/10/12/15 and w12 l5 (LEXT 134), B3
   at windows 10 and 14 plus an excess-bits row, B4, B8, X1
   and X2 on an extended stream, a window-15 stream, a double-FLUSH
   ``more`` stream, a v1 stream, an out-of-bounds, an overflowing and a
   corrupt stream (error codes included; the chase and xla tables equal,
   and on valid streams the wavefront finish equals B4), B5 at cap 15 (w10
   l8) and cap 16 (w11 l5) with and without the probe and at w15, B6 at w10
   l8, w11 l5 and an excess-bits row at l7, B7 at w10 l8 with and without
   lazy matching, w15 and w14 l6 (minp 3); the entry points on empty and
   tiny shards for the extended and v1 formats, lazy and not, the greedy
   encode (sparse and dense pulls, lazy and not) equal to the table-less
   committer, and two streams whose payload fills its bucket exactly in
   every decode mode and the serial algorithm; then the walks' hazards: B4
   and X2 on seeded random hazard streams (matches into the last 1-64 ring
   bytes, RLE and extended matches at the ring end, FLUSH and double FLUSH,
   out-of-bounds and, for B4, overflow mid-stream, a trailing incomplete
   token; for X2 also max_out inside a match and inside an RLE of more
   than 8 bytes) at windows 8, 10 and 15, B3 on seeded random fields (split indices at
   windows 14 and 15, an error field and a zero advance mid-tile, max_out
   clipping, npos < 16), B6 on seeded random lazy tables (deferral chains
   across tile seams, an excess literal deferred and not, deferred sizes up
   to 65535, a stop with its cache set, max_out clipping, npos < 16), B7
   on seeded random walker planes (RLE advances of 241 across tile seams,
   lazy deferrals, a shard without entries, npos < 16), B8 on seeded
   random jump planes (hops of 1-34 bits across tile seams, one landing on
   a tile's first bit, incomplete tokens in the first tile, mid-row and in
   the last, a hop that does not advance, a shard without tokens, T_max
   below the count, NBP not a multiple of the tile) and on one with a hop
   past its maps, which it must refuse, and B5 on seeded hazard rows at
   windows 8/10/12/15 (all-equal bytes, glue periods, a 15/16 tie,
   one-byte-only candidates, npos off the block and below 17); then X3
   and X4 (the optimal DPs) on seeded hazard shards at w8 l8, w10 l8, w11
   l6 and w12 l8 (text of 1 to 2048 + 133 bytes around the blocks and the
   lookback K, all-equal bytes, a long periodic stretch at the cap and the
   ring-end room caps, forced-RLE chunk splits of 241 and 240, an
   unencodable literal at l6) and on 4 x 64 KiB of the corpus, X3 also
   on 1, 13 and 203 shards of 1, 5, 33 and 40 blocks (one block, fewer
   than a group of 32, ragged last groups) at w10 l8 and w11 l6, and X1
   on seeded hazard rows (a deficit at every token, segment changes
   inside a chunk of 32 tokens and at its first token, 0, 31-33, 127-129
   and T_max truncating tokens) at 1, 7 and 203 shards; then
   ``engine="device"`` (extended: B5 and the host table committer; v1:
   the device-commit encode): v1 lazy at w8
   and w15 (l5), custom dictionaries, empty input and the file path's
   batches of 1, 7 and 203 shards, each with B5 against its plain version
   at the path's rows, the streams against the plain versions' and, for
   the batches, ``compress_file_sharded`` against ``compress_sharded``;
3. eleven round trips at full size: 8 x 1 MiB shards of a seeded random-word
   text with a run-heavy stretch, window 10 / literal 8, through
   ``compress_sharded`` and ``decompress_sharded_device``: the main path
   (``engine="device-commit"``, extended, no lazy matching), then extended
   with lazy matching, v1, v1 with lazy matching,
   ``engine="device-greedy"`` without and with lazy matching, and
   ``engine="device-optimal"`` extended (``optimal``: X4, B4) and v1
   (``optimal v1``: B5, X3, B3, B4), and ``engine="device"`` extended,
   extended lazy and v1 (``device``, ``device lazy``: B5 and the host
   table committer, B4; ``device v1``: B5, B3, B4).  For each:
   the kernel launch counts of that one round trip
   (every count set to 0 just before it), encode and decode rates (CUDA
   events, median of 3 after a warm-up), the ratio, and the card's
   container equal to the plain versions' on a small input.  For the main
   path also the time of each stage of the encode and the decode, and the
   device's busy and idle share in each (torch.profiler); for the extended
   lazy path the stages of the encode (B2 in place of B1) and its idle
   share.  For the v1
   paths, lazy and not, a stage split of the encode (B5, the fused device
   call, the pulls, the host ring tail, the frame).  For the greedy
   paths: the container equal to the table-less committer's (the card-side
   parity check), a stage breakdown with the bytes pulled per input byte,
   the device's idle share, the dense pull's rate and the table-less
   threaded committer's rate (the host-only yardstick).  For the optimal
   paths: the v1 container no larger than the v1 and v1 lazy ones, the
   extended ratio beside extended lazy's (not checked), a stage split of
   each encode through its own stage functions and its idle share.  For
   the device paths: B5's launches a call, B5's full-size tables of the
   model histories equal to its plain version (extended, lazy and not),
   the v1 and v1 lazy containers equal to the v1 and v1 lazy
   device-commit ones, each container
   decoded by the serial algorithm, ``compress_file_sharded`` through a
   temporary file equal to the round trip's container (and its rate),
   each encode's idle share, and the extended encode's stages (host prep,
   pad, h2d, B5, pack and pull, the gather and two commits a shard, the
   frame).  Then
   the decode
   modes: those four containers and an extended window-15 one of the same
   corpus, each decoded through ``decompress_sharded_device`` with
   ``TAMP_TPU_DECODE`` set to commit, chase and xla, and with
   ``algorithm="serial"``: the output equal to the input, the launch
   counts of that one decode (B8 and X1 on chase, X1 on xla, X2 on serial,
   B4 on none of the three), and the rate; then mode commit at the shapes
   far from the cell's (COMMIT_SHAPES: one 4 KiB shard, window 15 on 64
   shards): the output equal to the input, the call's ms and MB/s and
   B4's device ms (its four launches, each once a wrapper call, counted
   and timed in a child process, ``--b4-child``); then the mesh layer: in a
   world of one process (this one) ``make_mesh``, the search step on the
   corpus as (8, 1 MiB) at w10 l8 (B5 once, its tables equal to B5's plain
   version, the estimate to the plain tables'; its ms and a stage split)
   and the decode step on the main path's 8 streams in modes commit (B4
   once) and xla (X1), the corpus back, MB/s, a stream reading past the
   window end refused; then ``compress_distributed`` in a world of two
   child processes sharing the card (host gathers only), rank 0's
   containers for ``engine="device-commit"`` and ``"device"`` equal to the
   round trips', their rates beside one process's; then
   ``decompress_file_sharded`` of the main path's container and of the
   ``engine="device"`` file that ``compress_file_sharded`` writes, from
   temporary files, in modes commit, chase and xla and by the serial
   algorithm, at the default ``workers`` (one batch) and ``workers=2``
   (two of 4): the corpus back, each mode's kernels once a batch, the peak
   device memory, the main path's rates beside
   ``decompress_sharded_device``'s, and a raw size off by one and a v1
   shard in the second batch refused; ``entry()``'s six tables equal to
   B5's plain version from two B5 launches, and its ms; and
   ``dryrun_multichip`` over every card (a world of one), its seconds and
   launches; then the front door: ``tamp_tpu_torch.compress`` and
   ``decompress`` of the corpus as one stream for extended, extended
   lazy, v1, v1 lazy, optimal and optimal v1, each route's kernels
   launched, its stream decoded back by one X2 launch, median MB/s of
   three calls and peak device memory beside the 8 x 1 MiB rates of the
   same encode; every route's stream equal to the one its route gives
   with the plain versions in place of the kernels, on the card, and the
   extended streams to the table-less committer's; one byte past the
   stream limit refused; an RLE stream of
   ~92x decoded whole by three X2 launches; the CLI in process on
   temporary files and stdin/stdout (compress and decompress of a raw
   stream, ``--sharded`` both ways, ``--optimal`` with and without it,
   ``-d`` with a 100-byte dictionary, container decodes), each output
   equal to the API's, with seconds and launches; ``build-dictionary
   --auto-trim`` on 2000 seeded records, B5 and B7 once a threshold, its
   seconds; then the rest of the JAX package's API (``phase_api_rest``):
   ``compress_sharded`` of the corpus with the JAX engine names
   ``"native"``, ``"tables"`` and ``"optimal"`` and with none (the
   default, ``"native"``), each container equal to phase 3's container of
   its route (greedy, device, optimal) with that route's kernels launched
   and its MB/s; ``decompress_sharded`` of the main path's container
   (the corpus back, X2 once, MB/s beside ``decompress_sharded_device``'s
   serial algorithm), of a v1 frame whose one shard decodes to 2**20 +
   4096 bytes (the port's own one-shot and framing; whole), and of a
   stream reading past the window (OutOfBoundsError); ``tamp_tpu_torch.
   open``'s C++ stream over 1 MiB and its Python stream over 64 KiB,
   written in 1-, 7- and 4096-byte chunks with a flush in the middle (the
   two equal on 64 KiB, each decoded back by both and by the card's X2),
   with host MB/s; the C++ stream of the whole corpus without the flush
   equal to ``tamp_tpu_torch.compress``'s stream from the card; an abort
   from a progress callback resumed to the same bytes, in both
   directions; then the port's bench (``phase_bench``): ``bench_torch``
   in this process at BENCH_ARGV (8 MiB headline and device batch, 2
   reps), every key of its line present (BENCH_KEYS), every rate
   positive, the greedy and optimal v1 containers byte-equal to their
   host references (each key 1), its line printed, and
   tools/torch_commit_kernel_bench.py's ``measure(1.0, 2)`` once;
4. each kernel at its path's shapes: its time, its plain version's time
   and result, and its bound (the least time the card could take; for the
   tables B1, B2 and B5, lazy or not, the larger of their bytes and one
   word operation per 32 slots of each target); B5 with the probe family
   and B5 on ``engine="device"``'s model histories (cap 16) have rows of
   their own; the walks' rows (B3, B4, B6, B7) also carry their
   walk steps (``steps``: planned-field steps, tokens, lazy-walk tokens,
   replay steps); X3 and X4 carry the edges their serial DP relaxes on
   the path's inputs (``edges``; their operation bound counts an add and
   a min an edge); B4's four launches, X4's three and X3's five are timed
   apart (profiler; B4_LAUNCHES, X4_LAUNCHES, X3_LAUNCHES; B4's in a child
   process, ``--b4-child``, where each of its four kernels must run once a
   wrapper call, its row carrying their sum, and its front's token count
   must equal the walk's; X3's and X4's rows carry the profiler
   traces their split took, ``launch_traces``, and the lag from the first
   launch call to the first kernel on the profiler's clocks,
   ``launch_lag_us``), X1 is timed alone beside its
   call (the call zero-fills the (S, T_max) output) and in ns a truncating
   token, X5 (the per-bit parse) is timed as B4's words and as the pair
   of the chase and xla modes, its plain version the tensor ops on the
   card, and the X1, X2, X3 and X4 rows print their first ports' times
   (FIRST_PORT_MS) beside; the rows of the kernels that phase 3's file
   decodes, ``entry()``, the dry run, the one-shots and the CLI launched
   carry those counts too (``file_launches``, ``entry_launches``,
   ``dryrun_launches``, ``api_launches``, ``cli_launches``,
   ``api_rest_launches``, ``bench_launches``).

The last lines are the ``kernels`` JSON object, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

# the corpus, the kernels' launch counters, the idle share and nvidia-smi's
# line are the port's bench's (one copy)
from bench_torch import build_corpus as corpus
from bench_torch import counters, idle_share, smi

# the hazard generators are the card tests' (one copy)
sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
from test_torch_cuda import (  # noqa: E402
    X2_HAZARD_KINDS, ext_opt_inputs, hazard_fields, hazard_lazy_tables,
    hazard_nxt, hazard_opt_shards, hazard_predict_planes, hazard_rows,
    hazard_rows_ext, hazard_stream, v1_opt_inputs, x1_hazard_rows,
    x2_hazard_streams,
)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
INT32_LANES_PER_SM = 64    # Hopper SM: 64 INT32 lanes (H100 whitepaper)
SMALL = 1 << 16            # shard size of phase 2
# the round trips of phase 3, the main path first: name, compress_sharded
# options, and the kernels (wrapper names, B1..B7) each must launch
PATHS = (
    ("extended", {"engine": "device-commit"},
     ("ext_tables", "commit_fields", "commit_decode")),
    ("extended lazy", {"engine": "device-commit", "lazy_matching": True},
     ("ext_tables_probe", "commit_fields", "commit_decode")),
    ("v1", {"engine": "device-commit", "extended": False},
     ("v1_tables", "commit_fields", "commit_decode")),
    ("v1 lazy", {"engine": "device-commit", "extended": False,
                 "lazy_matching": True},
     ("v1_tables", "commit_v1_lazy", "commit_decode")),
    ("greedy", {"engine": "device-greedy"},
     ("v1_tables", "greedy_predict_batch", "commit_decode")),
    ("greedy lazy", {"engine": "device-greedy", "lazy_matching": True},
     ("v1_tables", "greedy_predict_batch", "commit_decode")),
    ("optimal", {"engine": "device-optimal"},
     ("opt_ext_choice", "commit_decode")),
    ("optimal v1", {"engine": "device-optimal", "extended": False},
     ("v1_tables", "opt_v1_choice", "commit_fields", "commit_decode")),
    ("device", {"engine": "device"}, ("v1_tables", "commit_decode")),
    ("device lazy", {"engine": "device", "lazy_matching": True},
     ("v1_tables", "commit_decode")),
    ("device v1", {"engine": "device", "extended": False},
     ("v1_tables", "commit_fields", "commit_decode")),
)
DEVICE_PATHS = ("device", "device lazy", "device v1")  # engine="device"
OPT_CASES = ((8, 8), (10, 8), (11, 6), (12, 8))  # X3 and X4: window, literal
# X4's and X3's launches, by a substring of their kernels' names (neither
# matches a kernel of the other)
X4_LAUNCHES = {"pass 1": "pass1_ext", "combine": "combine_ext",
               "pass 2": "pass2_ext"}
X3_LAUNCHES = {"pass 1": "v1_pass1", "groups": "v1_group", "scan": "v1_scan",
               "bounds": "v1_bounds", "pass 2": "v1_pass2"}
# B4's four launches (every name holds "commit_decode_kernel", the
# profiler's key for B4; the commit's alone is followed by its arguments)
B4_LAUNCHES = {"maps": "commit_decode_kernel_maps",
               "entries": "commit_decode_kernel_entries",
               "pack": "commit_decode_kernel_pack",
               "commit": "commit_decode_kernel("}
B4_REPS = 5  # calls the B4 child times under the profiler a job
B4_TIMEOUT_S = 300
# phase 3's commit decodes at the shapes far from the cell's: (name,
# shards, window); the corpus's first shards x 4 KiB, or the whole corpus
COMMIT_SHAPES = (("1 x 4 KiB", 1, 10), ("w15, 64 shards", 64, 15))
# X3's blocks and groups in phase 2: (shards, blocks a shard)
X3_GROUP_CASES = ((1, 1), (1, 33), (203, 5), (13, 40))
X1_HAZARD_S = (1, 7, 203)  # shards of X1's hazard rows in phase 2
# the phase-4 times of X1's, X2's, X3's and X4's first ports (this script
# on the tree before their redesign, and for X1's kernel and X3's launches
# tools/torch_walk_probe.py --x there; NVIDIA H100 80GB HBM3, 700.00 W),
# printed beside this run's (on their report lines only: they are not this
# run's numbers, so the kernels line leaves them out)
FIRST_PORT_MS = {
    "trunc_deficits (X1)": "0.210-0.259 (kernel alone 0.189)",
    "serial_decode (X2)": "265.930-266.053",
    "opt_v1_choice (X3)":
        "0.990-1.064 (pass 1 0.43, combine 0.22, pass 2 0.28)",
    "opt_ext_choice (X4)":
        "7.060-7.110 (pass 1 4.40, combine 0.87, pass 2 1.26)"}
# the engines of phase 3's two-process compress_distributed, and how long
# its children may run
DIST_ENGINES = ("device-commit", "device")
DIST_TIMEOUT_S = 300
# phase 3's file decodes: default workers (one batch of the 8 shards on a
# host of 4 or more cores) and workers=2 (two batches of 4); each mode with
# its algorithm and the kernels (wrapper names) it must launch once a batch
FILE_WORKERS = (None, 2)
FILE_DECODES = (
    ("commit", "wavefront", ("parse_words", "commit_decode")),
    ("chase", "wavefront", ("parse_words", "token_table_chase",
                            "trunc_deficits")),
    ("xla", "wavefront", ("parse_words", "trunc_deficits")),
    ("serial", "serial", ("serial_decode",)),
)
# the kernels (wrapper names) the dry run must launch
DRYRUN_KERNELS = ("v1_tables", "ext_tables", "commit_fields",
                  "greedy_predict_batch", "opt_v1_choice", "opt_ext_choice",
                  "commit_decode", "serial_decode")
# phase 3's one-shots (tamp_tpu_torch.compress, the corpus as one stream):
# route, options, the kernels (wrapper names) its compress must launch, and
# the round trip of phase 3 that runs the same encode in 1 MiB shards
ONE_SHOTS = (
    ("extended", {}, ("v1_tables", "greedy_predict_batch"), "greedy"),
    ("extended lazy", {"lazy_matching": True},
     ("v1_tables", "greedy_predict_batch"), "greedy lazy"),
    ("v1", {"extended": False}, ("v1_tables", "commit_fields"), "v1"),
    ("v1 lazy", {"extended": False, "lazy_matching": True},
     ("v1_tables", "commit_v1_lazy"), "v1 lazy"),
    ("optimal", {"parse": "optimal"}, ("opt_ext_choice",), "optimal"),
    ("optimal v1", {"parse": "optimal", "extended": False},
     ("v1_tables", "opt_v1_choice", "commit_fields"), "optimal v1"),
)
ONE_SHOT_REPS = 3       # timed calls of each one-shot (the median is kept)
# phase_api_rest: the JAX engine names (None: no engine given) on the
# corpus, phase 3's round trip whose container each must equal, and the
# kernels (wrapper names) each must launch
API_ENGINES = (
    ("native", "greedy", ("v1_tables", "greedy_predict_batch")),
    ("tables", "device", ("v1_tables",)),
    ("optimal", "optimal", ("opt_ext_choice",)),
    (None, "greedy", ("v1_tables", "greedy_predict_batch")),
)
NATIVE_STREAM_BYTES = 1 << 20  # the C++ stream's chunked write
PY_STREAM_BYTES = 1 << 16      # the Python stream's (~0.5 MB/s)
# the chunked writes: 1-byte chunks over the first 1/128 of the input,
# 7-byte ones to 1/16, a flush, then 4096-byte ones
STREAM_CHUNKS = ((1, 1 / 128), (7, 1 / 16), (4096, 1.0))
WHOLE_CHUNKS = ((4096, 1.0),)  # the corpus's C++ stream: 4096-byte writes
C2_BYTES = (1 << 20) + 4096    # one v1-frame shard past the 1 MiB default
DICT_SAMPLES = 2000    # records of build-dictionary's seeded corpus
# phase_bench: bench_torch's arguments, and the keys its line must carry
# (bench.py's headline keys and device stages, by the same names)
BENCH_ARGV = ("--mb", "8", "--device-mb", "8", "--reps", "2")
BENCH_KEYS = (
    "metric", "value", "unit", "vs_baseline", "pipeline", "corpus_mb",
    "ratio", "decode_mb_s", "decode_vs_baseline", "optimal_ratio",
    "optimal_mb_s", "container_decode_mb_s", "container_decode_chase_mb_s",
    "container_decode_xla_mb_s", "container_decode_serial_mb_s",
    "v1_encode_mb_s", "ext_encode_mb_s", "ext_ratio", "greedy_encode_mb_s",
    "greedy_byte_equal_reference", "optimal_encode_mb_s", "optimal_v1_ratio",
    "optimal_byte_equal_host_dp", "decode_commit_compute_ms_mb",
    "encode_commit_compute_ms_mb", "compute_dispatch_ms", "device_batch_mb",
    "setup_s", "device")
GREEDY_B7_CASES = ((10, 8, False), (10, 8, True), (15, 8, False),
                   (14, 6, True))  # window, literal, lazy (w14 l6: minp 3)
# the decode modes of phase 3: name, the kernels (wrapper names, X5, B8,
# X1, X2) each must launch; none of them launches B4
DECODES = (
    ("chase", ("parse_words", "token_table_chase", "trunc_deficits")),
    ("xla", ("parse_words", "trunc_deficits")),
    ("serial", ("serial_decode",)),
)
# two w10/l8 streams whose 64-byte payload fills its bucket, the last token
# ending on the payload's last bit, and their raw bytes
EXACT_BUCKET = (
    ("5ab5dbed80876bb50142a8169b459edf64b45a2df66b5dbad968b6c80052db69b35aadd"
     "62b15becf63b2d98032da00770150b4592c96c9059ace2040444576d091",
     b"koloekj oooihgodhhofknlhm knmifjnbbogcefhgmoepi hddl fgniboiemaa"),
    ("5ab75a02a6df66083b2d9ad770b65c0c46d800f62b3d92c965b1da6c83396ab75b2c968"
     "020b458ac56db5596d6c09b183659187966b500ed92d36d01eb558ac770",
     b"nho ofooefkplpialoebgddecidoijnldhdhhbbmjekfkpcoad aafjjndimnljbcp"),
)


def fail(msg: str):
    raise RuntimeError(f"chip_smoke: {msg}")


def int_ops_per_s() -> float:
    """The card's peak rate of 32-bit integer instructions: SMs x INT32
    lanes per SM x the maximum SM clock that nvidia-smi reports."""
    import torch

    r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                        "--format=csv,noheader,nounits"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        fail(f"nvidia-smi could not read the SM clock: {r.stderr.strip()}")
    mhz = float(r.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * INT32_LANES_PER_SM * mhz * 1e6


def cuda_ms(fn, reps: int = 3):
    """Median ms of ``fn()`` over ``reps`` runs after one warm-up, timed
    with CUDA events on the current stream; returns (ms, last result)."""
    import torch

    out = fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times), out


def sync(dev) -> None:
    """Wait for the card, so that a fault shows where it happened."""
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()


def max_abs_err(pairs) -> int:
    import torch

    err = 0
    for x, y in pairs:
        x = torch.as_tensor(x).to("cpu", torch.int64)
        y = torch.as_tensor(y).to("cpu", torch.int64)
        if x.shape != y.shape:
            fail(f"shape mismatch {tuple(x.shape)} vs {tuple(y.shape)}")
        if x.numel():
            err = max(err, int((x - y).abs().max()))
    return err


class BitWriter:
    """MSB-first bit writer for a hand-built Tamp stream."""

    def __init__(self):
        self.bits: list[int] = []

    def put(self, v: int, n: int):
        self.bits.extend((v >> (n - 1 - i)) & 1 for i in range(n))

    def align(self):
        self.bits.extend([0] * (-len(self.bits) % 8))

    def bytes(self) -> bytes:
        self.align()
        return bytes(int("".join(map(str, self.bits[i : i + 8])), 2)
                     for i in range(0, len(self.bits), 8))


def more_stream():
    """A window-10 extended ``more`` stream with a double FLUSH: literals,
    a match, an RLE token, FLUSH, FLUSH, then a match into the reset
    (default) dictionary.  Returns (stream, expected output)."""
    from tamp_tpu_torch.constants import HUFFMAN_CODES as HC
    from tamp_tpu_torch.constants import HUFFMAN_LENGTHS as HL
    from tamp_tpu_torch.dictionary import dictionary_array

    bw = BitWriter()
    bw.put(((10 - 8) << 5) | ((8 - 5) << 3) | (1 << 1) | 1, 8)
    bw.put(0, 8)  # reserved header byte
    for ch in b"abcabcabc":
        bw.put(0x100 | ch, 9)
    bw.put(HC[1], HL[1])  # match of size minp + 1 = 3 at slot 0
    bw.put(0, 10)
    bw.put(HC[12], HL[12])  # RLE of 20: secondary symbol 1, trail 2
    bw.put(HC[1], HL[1] - 1)
    bw.put(2, 4)
    for _ in range(2):  # FLUSH, FLUSH: the window resets
        bw.put(HC[14], HL[14])
        bw.align()
    for ch in b"xyz":
        bw.put(0x100 | ch, 9)
    bw.put(HC[2], HL[2])  # match of size 4 at slot 100 of the default dict
    bw.put(100, 10)
    d = dictionary_array(1024, literal=8)
    want = b"abcabcabc" + b"abc" + b"c" * 20 + b"xyz" + d[100:104].tobytes()
    return bw.bytes(), want


def v1_stream():
    """A window-10 v1 (non-extended) stream: literals, a match into the
    written bytes, and a match of symbol 13 (a basic match of minp + 13
    bytes in v1, not an extended one) into the default dictionary.
    Returns (stream, expected output)."""
    from tamp_tpu_torch.constants import HUFFMAN_CODES as HC
    from tamp_tpu_torch.constants import HUFFMAN_LENGTHS as HL
    from tamp_tpu_torch.dictionary import dictionary_array

    bw = BitWriter()
    bw.put(((10 - 8) << 5) | ((8 - 5) << 3), 8)
    for ch in b"abcabc":
        bw.put(0x100 | ch, 9)
    bw.put(HC[1], HL[1])  # size 3 at slot 0
    bw.put(0, 10)
    bw.put(HC[13], HL[13])  # size 15 at slot 500
    bw.put(500, 10)
    d = dictionary_array(1024, literal=8)
    return bw.bytes(), b"abcabc" + b"abc" + d[500:515].tobytes()


def oob_stream():
    """A window-10 extended stream whose second token is a basic match
    reading past the window end (ERR_OOB)."""
    from tamp_tpu_torch.constants import HUFFMAN_CODES as HC
    from tamp_tpu_torch.constants import HUFFMAN_LENGTHS as HL

    bw = BitWriter()
    bw.put(((10 - 8) << 5) | ((8 - 5) << 3) | (1 << 1), 8)
    bw.put(0x100 | 0x41, 9)
    bw.put(HC[11], HL[11])  # size minp + 11 = 13 at slot 1020: 1033 > W
    bw.put(1020, 10)
    return bw.bytes()


def phase_hazards(dev, report):
    """Phase 2, the walks' hazards: B4 and X2 on seeded hazard streams (X2
    also with max_out inside a match and inside an RLE), B3 on seeded
    hazard fields, B6 on seeded lazy tables, B7 on seeded walker
    planes, B8 on seeded jump planes (and one it must refuse), B5 on
    seeded hazard rows and X1 on seeded hazard rows (x1_hazard_rows, at
    1, 7 and 203 shards), each against its plain version, exactly."""
    import numpy as np
    import torch

    from tamp_tpu_torch.dictionary import dictionary_array
    from tamp_tpu_torch.ops import decode_commit as dc
    from tamp_tpu_torch.ops import decode_wavefront as dw
    from tamp_tpu_torch.ops.encode_commit import (
        commit_fields, commit_fields_plain, commit_v1_lazy,
        commit_v1_lazy_plain,
    )
    from tamp_tpu_torch.ops.greedy_predict import (
        greedy_predict_batch, greedy_predict_plain,
    )
    from tamp_tpu_torch.ops.match_v1 import v1_tables, v1_tables_plain
    from tamp_tpu_torch.ops.token_chase import (
        token_table_chase, token_table_chase_plain,
    )

    want_err = {"out of bounds": dc.ERR_OOB, "overflow": dc.ERR_OVERFLOW,
                "overflow, max_out not a multiple of 16": dc.ERR_OVERFLOW}
    for window in (8, 10, 15):
        d = torch.from_numpy(dictionary_array(1 << window)).to(dev)
        for kind in ("hazards", "more, double FLUSH", "out of bounds",
                     "overflow", "overflow, max_out not a multiple of 16",
                     "trailing incomplete token"):
            more = kind.startswith("more")
            streams, lens = zip(*(hazard_stream(
                window * 100 + i, window, more=more, n_tokens=3000 + 700 * i,
                oob_at=1700 + 90 * i if kind == "out of bounds" else -1)
                for i in range(4)))
            max_out = 1 << max(max(lens), 1024).bit_length()
            if kind.startswith("overflow"):
                max_out = (min(lens) // 2 & ~15) + 7 * ("multiple" in kind)
            if kind == "trailing incomplete token":
                streams = [x[:-2] for x in streams]
            skip = 2 if more else 1
            nxt, packed = dw.payload_parse([x[skip:] for x in streams],
                                           window=window, literal=8,
                                           extended=True, device=dev)
            kw = dict(W=1 << window, more=more, max_out=max_out)
            got = dc.commit_decode(nxt, packed, d, d, **kw)
            plain = dc.commit_decode_plain(dc.fuse_parse(nxt, packed), d, d,
                                           **kw)
            sync(dev)
            err = max_abs_err(zip(got, plain))
            report(f"B4 hazard stream w{window} {kind}: kernel vs plain "
                   f"max_abs_err={err} lens={got[1].tolist()} "
                   f"errs={got[2].tolist()}")
            if err:
                fail(f"B4 differs from its plain version on the w{window} "
                     f"{kind} hazard streams")
            if got[2].tolist() != [want_err.get(kind, dc.ERR_OK)] * 4:
                fail(f"B4 gave the wrong verdict on the w{window} {kind} "
                     "hazard streams")
            if kind in ("hazards", "more, double FLUSH") \
                    and got[1].tolist() != list(lens):
                fail(f"B4 decoded the w{window} {kind} hazard streams to the "
                     "wrong lengths")

    # X2 on hazard streams, and with max_out inside a match or an RLE
    from tamp_tpu_torch.ops import decode_serial as dser

    for window in (8, 10, 15):
        d = torch.from_numpy(dictionary_array(1 << window)).to(dev)
        for kind in X2_HAZARD_KINDS:
            streams, lens, more, max_out = x2_hazard_streams(window, kind)
            skip = 2 if more else 1
            pieces = [x[skip:] for x in streams]
            pl = np.zeros((len(pieces), max(map(len, pieces))), np.uint8)
            for i, p in enumerate(pieces):
                pl[i, : len(p)] = np.frombuffer(p, np.uint8)
            pl = torch.from_numpy(pl)
            nb = torch.tensor([len(p) for p in pieces], dtype=torch.int32)
            kw = dict(window=window, literal=8, extended=True, more=more,
                      max_out=max_out)
            got = dser.serial_decode(pl.to(dev), nb.to(dev), d, d, **kw)
            plain = dser.serial_decode_plain(pl, nb, d.cpu(), d.cpu(), **kw)
            sync(dev)
            err = max_abs_err(zip(got, plain))
            report(f"X2 hazard stream w{window} {kind} (max_out {max_out}): "
                   f"kernel vs plain max_abs_err={err} "
                   f"lens={got[1].tolist()} errs={got[2].tolist()}")
            if err:
                fail(f"X2 differs from its plain version on the w{window} "
                     f"{kind} hazard streams")
            oob = kind.startswith("out of")
            if got[2].tolist() != [dser.ERR_OOB if oob else dser.ERR_OK] * 3:
                fail(f"X2 gave the wrong verdict on the w{window} {kind} "
                     "hazard streams")
            if kind != "trailing incomplete token" and got[1].tolist() != [
                    min(n, max_out) for n in lens]:
                fail(f"X2 decoded the w{window} {kind} hazard streams to "
                     "the wrong lengths")

    NP = 3 * 4096 + 512
    npos = torch.tensor([NP, NP, NP, NP - 100, 9000, 15], dtype=torch.int32,
                        device=dev)  # 15: no walk
    for idx_bits, max_out in ((0, None), (14, None), (15, None), (0, 400),
                              (15, 401)):
        A, B = (torch.from_numpy(x).to(dev)
                for x in hazard_fields(idx_bits + 5, 6, NP, idx_bits))
        kw = dict(max_out=max_out or NP + NP // 8 + 64, idx_bits=idx_bits)
        out, st = commit_fields(A, B, npos, **kw)
        pout, pst = commit_fields_plain(A, B, npos, **kw)
        sync(dev)
        err = max_abs_err([(out, pout), (st, pst)])
        report(f"B3 hazard fields idx_bits={idx_bits} max_out={kw['max_out']}"
               f": kernel vs plain max_abs_err={err} "
               f"err_slots={st[:, 6].tolist()} nbytes={st[:, 1].tolist()}")
        if err:
            fail(f"B3 differs from its plain version on the hazard fields, "
                 f"idx_bits={idx_bits}, max_out={kw['max_out']}")
        if st[:, 6].tolist() != [0, 1, 2, 0, 0, 0] or int(st[5, 0]) != 0:
            fail("B3 missed an error row or walked a row with npos < 16")

    for window, literal, max_out in ((10, 8, None), (10, 7, None),
                                     (11, 5, None), (10, 8, 400),
                                     (11, 5, 401)):
        P, Q, npos = (torch.from_numpy(x).to(dev) for x in hazard_lazy_tables(
            window * 10 + literal, 6, NP, window, literal))
        kw = dict(window=window, literal=literal,
                  max_out=max_out or NP + NP // 8 + 64)
        out, st = commit_v1_lazy(P, Q, npos, **kw)
        pout, pst = commit_v1_lazy_plain(P, Q, npos, **kw)
        sync(dev)
        err = max_abs_err([(out, pout), (st, pst)])
        report(f"B6 hazard tables w{window} l{literal} max_out={kw['max_out']}"
               f": kernel vs plain max_abs_err={err} "
               f"err_slots={st[:, 6].tolist()} cache={st[:, 4].tolist()} "
               f"stops={st[:, 0].tolist()}")
        if err:
            fail(f"B6 differs from its plain version on the hazard tables, "
                 f"w{window} l{literal}, max_out={kw['max_out']}")
        if int(st[3, 0]) <= NP or int(st[4, 4]) < 0 or int(st[5, 0]) != 0 \
                or (literal < 8 and st[1:3, 6].tolist() != [1, 1]):
            fail("B6's hazard tables missed a jump past the end, a stop with "
                 "its cache set, an excess literal or the npos < 16 row")

    for window, literal, lazy in ((10, 8, False), (10, 8, True),
                                  (14, 6, True)):
        pk, pp, npos = (torch.from_numpy(x).to(dev)
                        for x in hazard_predict_planes(window + lazy, 5, NP,
                                                       window, literal))
        kw = dict(NP=NP, window=window, literal=literal, lazy=lazy)
        got = greedy_predict_batch(pk, pp, npos, **kw)
        plain = greedy_predict_plain(pk, pp, npos, **kw)
        sync(dev)
        err = b7_err(got, plain)
        ne = got[2][:, 0].tolist()
        report(f"B7 hazard planes w{window} l{literal} lazy={lazy}: kernel "
               f"vs plain max_abs_err={err} entries={ne} "
               f"stops={got[2][:, 1].tolist()}")
        if err:
            fail(f"B7 differs from its plain version on the hazard planes, "
                 f"w{window} l{literal}, lazy={lazy}")
        if ne[1] or ne[4] or not min(ne[0], ne[2], ne[3]):
            fail("B7's hazard planes missed the row without entries or the "
                 "npos < 16 row")

    # B8: NBP a multiple of 512, not of the kernel's tile
    NBP = 3 * 4096 + 512
    for min_hop, T_max in ((1, NBP), (9, NBP // 9 + 2), (1, 150)):
        nxt = torch.from_numpy(hazard_nxt(min_hop + T_max, 7, NBP,
                                          min_hop=min_hop)).to(dev)
        got = token_table_chase(nxt, NBP, T_max)
        plain = token_table_chase_plain(nxt, NBP, T_max)
        sync(dev)
        err = max_abs_err(zip(got, plain))
        report(f"B8 hazard planes hops {min_hop}-34 T_max={T_max}: kernel vs "
               f"plain max_abs_err={err} T={got[1].tolist()}")
        if err:
            fail(f"B8 differs from its plain version on the hazard planes, "
                 f"hops {min_hop}-34, T_max={T_max}")
        T = got[1].tolist()
        if T[4] or (T_max > 150 and not T[1] < T[2] < T[0]):
            fail("B8's hazard planes missed the row without a token or an "
                 "early stop")
    nxt = torch.from_numpy(hazard_nxt(3, 6, NBP, long_hop=True)).to(dev)
    try:
        token_table_chase(nxt, NBP, NBP)
    except RuntimeError as e:
        report(f"B8 on a plane with a hop 100 bits past a tile: raised ({e})")
    else:
        fail("B8 returned a table for a plane whose hop passes its map")

    # B5: the hazard rows past W, both caps, probe on and off; at w15, where
    # the plain version takes minutes for all eight rows, rows 3 and 6 (the
    # glue period W + 1, the probe at tau = W - 1) of W + 300 positions at
    # cap 15 with the probe
    for window in (8, 10, 12, 15):
        W = 1 << window
        rows = [3, 6] if window == 15 else list(range(8))
        data, npos = (torch.from_numpy(x[rows]).to(dev) for x in hazard_rows(
            window, 8, W + (300 if window == 15 else 600), window))
        d = torch.from_numpy(dictionary_array(W)).to(dev)
        for cap, probe in ((15, True), (16, False), (16, True), (15, False)
                           )[: 1 if window == 15 else 4]:
            kw = dict(window_bits=window, cap=cap, probe=probe)
            got = v1_tables(data, npos, d, **kw)
            plain = v1_tables_plain(data, npos, d, **kw)
            sync(dev)
            err = max_abs_err(zip(got, plain))
            report(f"B5 hazard rows w{window} cap {cap} probe={probe}: "
                   f"kernel vs plain max_abs_err={err}")
            if err:
                fail(f"B5 differs from its plain version on the hazard rows, "
                     f"w{window}, cap {cap}, probe={probe}")

    # X1 on seeded hazard rows: deficits at every token, segment changes
    # inside a chunk and at its first token, n_tr = 0, 31, 32, 33, T_max
    for S in X1_HAZARD_S:
        for W in (256, 1024):
            args = [torch.from_numpy(x).to(dev)
                    for x in x1_hazard_rows(W + S, S, 2100, W)]
            got = dw.trunc_deficits(*args, W)
            plain = dw.trunc_deficits_plain(*args, W)
            sync(dev)
            err = max_abs_err([(got, plain)])
            report(f"X1 hazard rows S={S} W={W}: kernel vs plain "
                   f"max_abs_err={err}, nonzero deficits "
                   f"{int((plain != 0).sum())}")
            if err:
                fail(f"X1 differs from its plain version on the hazard rows, "
                     f"S={S}, W={W}")


def x3_group_shards(window: int, literal: int, S: int, NP: int):
    """S seeded shards of at most NP bytes for X3's block groups: pieces of
    the corpus (masked to the literal's bits) and the hazard shards from
    the last (cut to NP; at literal < 8 the last holds an unencodable
    byte), in turns.  As tests/test_torch_cuda.py's, with corpus text."""
    import numpy as np

    haz = hazard_opt_shards(window, window, literal)
    text = np.frombuffer(corpus(NP * (S + 1) // 2 + NP, seed=window),
                         np.uint8) & ((1 << literal) - 1)
    return [haz[-1 - k // 2 % len(haz)][:NP] if k % 2 else
            text[k // 2 * NP : (k // 2 + 1) * NP - 37 * (k % 5)].tobytes()
            for k in range(S)]


def on_device(dev, arrays):
    import torch

    return [None if a is None else torch.from_numpy(a).to(dev)
            for a in arrays]


def phase_optimal_small(dev, report):
    """Phase 2, the optimal DPs: kernels X3 and X4 against their plain
    versions (run on the card) on seeded hazard shards at w8 l8, w10 l8,
    w11 l6 (with an unencodable literal) and w12 l8, and on 4 x 64 KiB of
    the corpus at w10 l8, exactly: choice, cost0 and bad; then X3 at w10
    l8 and w11 l6 on X3_GROUP_CASES (x3_group_shards): one block a shard,
    fewer blocks than a group, a group and one block, 40 blocks, at 1, 13
    and 203 shards."""
    from tamp_tpu_torch.ops.opt_parse import (
        opt_v1_choice, opt_v1_choice_plain,
    )
    from tamp_tpu_torch.ops.opt_parse_ext import (
        opt_ext_choice, opt_ext_choice_plain,
    )

    text = corpus(4 * SMALL, seed=9)
    for window, literal in OPT_CASES:
        cases = [("hazards", hazard_opt_shards(window, window, literal))]
        if (window, literal) == (10, 8):
            cases.append(("corpus", [text[i : i + SMALL]
                                     for i in range(0, len(text), SMALL)]))
        kw = dict(window=window, literal=literal)
        for what, shards in cases:
            for name, fn, plain, inputs in (
                    ("X3", opt_v1_choice, opt_v1_choice_plain,
                     v1_opt_inputs),
                    ("X4", opt_ext_choice, opt_ext_choice_plain,
                     ext_opt_inputs)):
                args = on_device(dev, inputs(shards, window, literal))
                got = fn(*args, **kw)
                sync(dev)
                err = max_abs_err(zip(got, plain(*args, **kw)))
                if err:
                    fail(f"{name} differs from its plain version on the "
                         f"{what} shards at w{window} l{literal}: "
                         f"max_abs_err {err}")
        report(f"X3, X4 at w{window} l{literal}: equal to their plain "
               f"versions on {' and '.join(c[0] for c in cases)} shards")
    # X3's block groups: one block, fewer than a group, ragged groups, at
    # 1 and 203 shards, with an unencodable byte at l6
    from tamp_tpu_torch.ops.opt_parse import B_V1

    for window, literal in ((10, 8), (11, 6)):
        kw = dict(window=window, literal=literal)
        for S, n_b in X3_GROUP_CASES:
            NP = n_b * B_V1
            args = on_device(dev, v1_opt_inputs(
                x3_group_shards(window, literal, S, NP), window, literal,
                NP))
            got = opt_v1_choice(*args, **kw)
            plain = opt_v1_choice_plain(*args, **kw)
            sync(dev)
            err = max_abs_err(zip(got, plain))
            if err or bool(plain[2].any()) != (literal < 8 and S > 1):
                fail(f"X3 differs from its plain version on {S} shards of "
                     f"{n_b} blocks at w{window} l{literal}: max_abs_err "
                     f"{err}, bad {plain[2].tolist()}")
        report(f"X3 at w{window} l{literal}: equal to its plain version on "
               f"(shards, blocks) {X3_GROUP_CASES}")


def phase_kernels_small(dev, report):
    """Phase 2: each kernel against its plain version, reduced size."""
    import numpy as np
    import torch

    from tamp_tpu_torch.constants import compute_min_pattern_size
    from tamp_tpu_torch.dictionary import dictionary_array
    from tamp_tpu_torch.engine.greedy import greedy_compress
    from tamp_tpu_torch.engine.pipeline_ext import (
        encode_ext_device_greedy, ext_fields, prepare_batch,
    )
    from tamp_tpu_torch.ops import decode_commit as dc
    from tamp_tpu_torch.ops import decode_serial as dser
    from tamp_tpu_torch.ops import decode_wavefront as dw
    from tamp_tpu_torch.ops.encode_commit import (
        commit_fields, commit_fields_plain, commit_v1_lazy,
        commit_v1_lazy_plain,
    )
    from tamp_tpu_torch.ops.encode_fused import v1_cap
    from tamp_tpu_torch.ops.match_ext import (
        ext_tables, ext_tables_plain, ext_tables_probe,
        ext_tables_probe_plain,
    )
    from tamp_tpu_torch.ops.token_chase import (
        token_table_chase, token_table_chase_plain,
    )
    from tamp_tpu_torch.ops.match_v1 import v1_tables, v1_tables_plain
    from tamp_tpu_torch.parallel.shard import (
        _pack_frame, _parse_frame, compress_sharded, decompress_sharded_device,
    )

    small = corpus(2 * SMALL, seed=5)
    shards = [np.frombuffer(small[i : i + SMALL], np.uint8)
              for i in range(0, len(small), SMALL)]

    def fields(datas, window, literal):
        _prep, dh, rc, npos = prepare_batch(datas, window=window)
        d = torch.from_numpy(dictionary_array(1 << window, literal)).to(dev)
        dh = torch.from_numpy(dh).to(dev)
        npos = torch.from_numpy(npos).to(dev)
        tabs, A, B = ext_fields(dh, torch.from_numpy(rc).to(dev), npos, d,
                                window=window, literal=literal)
        lext = compute_min_pattern_size(window, literal) + 131
        return dh, npos, d, lext, tabs, A, B

    for window in (8, 10, 12, 15):
        dh, npos, d, lext, tabs, _A, _B = fields(shards, window, 8)
        plain = ext_tables_plain(dh, npos, d, window_bits=window, LEXT=lext)
        sync(dev)
        err = max_abs_err(zip(tabs, plain))
        report(f"B1 w{window} 2x64KiB: kernel vs plain max_abs_err={err}")
        if err:
            fail(f"B1 differs from its plain version at window {window}")

    for window in (8, 10, 12, 15):
        dh, npos, d, lext, _t, _A, _B = fields(shards, window, 8)
        got = ext_tables_probe(dh, npos, d, window_bits=window, LEXT=lext)
        plain = ext_tables_probe_plain(dh, npos, d, window_bits=window,
                                       LEXT=lext)
        sync(dev)
        err = max_abs_err(zip(got, plain))
        report(f"B2 w{window} 2x64KiB: kernel vs plain max_abs_err={err}")
        if err:
            fail(f"B2 differs from its plain version at window {window}")

    # B1 and B2 on the long family's hazard rows (18 rows of W + 600
    # positions; W + 300 at w15), w12 also at literal 5 (LEXT 134)
    for window, literal in ((8, 8), (10, 8), (12, 8), (12, 5), (15, 8)):
        W = 1 << window
        lext = compute_min_pattern_size(window, literal) + 131
        dh, npos = (torch.from_numpy(x).to(dev) for x in hazard_rows_ext(
            window, 18, W + (300 if window == 15 else 600), window, lext))
        d = torch.from_numpy(dictionary_array(W, literal)).to(dev)
        kw = dict(window_bits=window, LEXT=lext)
        plain = ext_tables_probe_plain(dh, npos, d, **kw)
        for name, got in (("B1", ext_tables(dh, npos, d, **kw)),
                          ("B2", ext_tables_probe(dh, npos, d, **kw))):
            sync(dev)
            err = max_abs_err(zip(got, plain))
            report(f"{name} hazard rows w{window} l{literal} (LEXT {lext}): "
                   f"kernel vs plain max_abs_err={err}")
            if err:
                fail(f"{name} differs from its plain version on the hazard "
                     f"rows, w{window} l{literal}")

    def v1_batch(datas, window):
        data = torch.from_numpy(np.stack(datas)).to(dev)
        npos = torch.tensor([x.shape[0] for x in datas], dtype=torch.int32,
                            device=dev)
        d = torch.from_numpy(dictionary_array(1 << window, 8)).to(dev)
        return data, npos, d

    masked = [x & 31 for x in shards]
    for window, literal, probe in ((10, 8, False), (10, 8, True),
                                   (11, 5, False), (11, 5, True),
                                   (15, 8, True)):
        cap = v1_cap(window, literal)
        data, npos, d = v1_batch(masked if literal == 5 else shards, window)
        kw = dict(window_bits=window, cap=cap, probe=probe)
        got = v1_tables(data, npos, d, **kw)
        plain = v1_tables_plain(data, npos, d, **kw)
        sync(dev)
        err = max_abs_err(zip(got, plain))
        report(f"B5 w{window} l{literal} cap {cap} probe={probe}: kernel vs "
               f"plain max_abs_err={err}")
        if err:
            fail(f"B5 differs from its plain version at window {window}, "
                 f"cap {cap}, probe={probe}")

    excess = shards[0] & 0x7F
    excess[SMALL // 2] = 0xC3
    for window, literal, datas in ((10, 8, shards), (11, 5, masked),
                                   (10, 7, [shards[1] & 0x7F, excess])):
        data, npos, d = v1_batch(datas, window)
        flen, fidx, plen, pidx = v1_tables(
            data, npos, d, window_bits=window, cap=v1_cap(window, literal),
            probe=True)
        packed = (flen << 23) | (fidx << 8) | data.to(torch.int32)
        probe = (plen << 15) | pidx
        kw = dict(window=window, literal=literal,
                  max_out=SMALL + SMALL // 8 + 64)
        out, st = commit_v1_lazy(packed, probe, npos, **kw)
        pout, pst = commit_v1_lazy_plain(packed, probe, npos, **kw)
        sync(dev)
        err = max_abs_err([(out, pout), (st, pst)])
        errs = st[:, 6].tolist()
        report(f"B6 w{window} l{literal}: kernel vs plain max_abs_err={err} "
               f"err_slots={errs} cache={st[:, 4].tolist()}")
        if err:
            fail(f"B6 differs from its plain version at window {window}")
        if literal == 7 and errs != [0, 1]:
            fail("B6 missed the excess-bits row")

    for window, literal, datas in ((10, 8, shards), (14, 8, shards),
                                   (10, 7, [shards[1] & 0x7F, excess])):
        _dh, npos, _d, _l, _t, A, B = fields(datas, window, literal)
        NP = A.shape[1]
        kw = dict(max_out=NP + NP // 8 + 64,
                  idx_bits=window if window >= 14 else 0)
        out, st = commit_fields(A, B, npos, **kw)
        pout, pst = commit_fields_plain(A, B, npos, **kw)
        sync(dev)
        err = max_abs_err([(out, pout), (st, pst)])
        errs = st[:, 6].tolist()
        report(f"B3 w{window} l{literal}: kernel vs plain max_abs_err={err} "
               f"err_slots={errs}")
        if err:
            fail(f"B3 differs from its plain version at window {window}")
        if literal == 7 and errs != [0, 1]:
            fail("B3 missed the excess-bits row")

    for window, literal, lazy in GREEDY_B7_CASES:
        datas = shards if literal == 8 else [x & 63 for x in shards]
        data, npos, _d = v1_batch(datas, window)
        d = torch.from_numpy(dictionary_array(1 << window, literal)).to(dev)
        bm, ent, st, plain = b7_pair(data, npos, d, window=window,
                                     literal=literal, lazy=lazy)
        err = b7_err((bm, ent, st), plain)
        report(f"B7 w{window} l{literal} lazy={lazy}: kernel vs plain "
               f"max_abs_err={err} entries={st[:, 0].tolist()} "
               f"stops={st[:, 1].tolist()}")
        if err:
            fail(f"B7 differs from its plain version at window {window}, "
                 f"literal {literal}, lazy={lazy}")
        if not (st[:, 0] > 0).all():
            fail("B7 predicted no token start on text")

    def decode_case(name, streams, window, literal, more, dict_init,
                    max_out, extended=True):
        skip = 2 if more else 1
        nxt, packed = dw.payload_parse(
            [s[skip:] for s in streams], window=window, literal=literal,
            extended=extended, device=dev)
        W = 1 << window
        di = torch.from_numpy(np.array(dict_init, np.uint8)).to(dev)
        dr = torch.from_numpy(
            dictionary_array(W, literal if extended else 8)).to(dev)
        got = dc.commit_decode(nxt, packed, di, dr, W=W, more=more,
                               max_out=max_out)
        plain = dc.commit_decode_plain(dc.fuse_parse(nxt, packed), di, dr,
                                       W=W, more=more, max_out=max_out)
        sync(dev)
        err = max_abs_err(zip(got, plain))
        report(f"B4 {name}: kernel vs plain max_abs_err={err} "
               f"lens={got[1].tolist()} errs={got[2].tolist()}")
        if err:
            fail(f"B4 differs from its plain version on {name}")

        # B8 and the xla table; X1 on the chase table's fold
        NBP = nxt.shape[1]
        T_max = NBP // (1 + literal) + 2
        tab = token_table_chase(nxt, NBP, T_max)
        ptab = token_table_chase_plain(nxt, NBP, T_max)
        xtab = dw._token_table(nxt, NBP, literal, T_max)
        x1_in = dw.fold_inputs(*tab, packed, more=more)
        defs = dw.trunc_deficits(*x1_in, W)
        pdefs = dw.trunc_deficits_plain(*x1_in, W)
        fin = dw.wavefront_finish(*tab, packed, di, dr, window=window,
                                  more=more, max_out=max_out)
        # X2 on the same payloads
        pl = np.zeros((len(streams), max(len(s) for s in streams)), np.uint8)
        for i, s in enumerate(streams):
            pl[i, : len(s) - skip] = np.frombuffer(s[skip:], np.uint8)
        pl = torch.from_numpy(pl)
        nb = torch.tensor([len(s) - skip for s in streams], dtype=torch.int32)
        kw = dict(window=window, literal=literal, extended=extended,
                  more=more, max_out=max_out)
        ser = dser.serial_decode(pl.to(dev), nb.to(dev), di, dr, **kw)
        pser = dser.serial_decode_plain(pl, nb, di.cpu(), dr.cpu(), **kw)
        sync(dev)
        e8 = max_abs_err(zip(tab, ptab)) + max_abs_err(zip(xtab, ptab))
        e1 = max_abs_err([(defs, pdefs)])
        e2 = max_abs_err(zip(ser, pser))
        report(f"B8 {name}: kernel vs plain max_abs_err={e8} "
               f"T={tab[1].tolist()}; X1: max_abs_err={e1} truncating "
               f"tokens={x1_in[3].tolist()}; X2: max_abs_err={e2} "
               f"lens={ser[1].tolist()} errs={ser[2].tolist()}")
        if e8 or e1 or e2:
            fail(f"B8, X1 or X2 differs from its plain version on {name}")
        if not got[2].any() and max_abs_err(zip(fin, got)):
            fail(f"the chase decode differs from B4's on {name}")
        if not got[2].any() and ser[2].any():
            fail(f"X2 rejected {name}")
        return got

    for window in (10, 15):
        blob = compress_sharded(small, window=window, shard_size=SMALL,
                                device=dev, engine="device-commit")
        _raw, _ss, pieces = _parse_frame(blob)
        out, lens, errs = decode_case(
            f"extended w{window}", pieces, window, 8, False,
            dictionary_array(1 << window, 8), SMALL)
        for i, s in enumerate(shards):
            if errs[i] != 0 or out[i, : int(lens[i])].cpu().numpy() \
                    .tobytes() != s.tobytes():
                fail(f"B4 did not round-trip shard {i} at window {window}")
        if window == 10:
            bad = bytearray(pieces[0])
            bad[len(bad) // 2] ^= 0x5A
            decode_case("corrupt stream", [bytes(bad)], 10, 8, False,
                        dictionary_array(1024, 8), SMALL)
            _o, _l, errs = decode_case("out-of-bounds stream", [oob_stream()],
                                       10, 8, False,
                                       dictionary_array(1024, 8), 1024)
            if errs.tolist() != [dc.ERR_OOB]:
                fail("B4 missed the out-of-bounds match")
            _o, _l, errs = decode_case("output overflow", pieces, 10, 8,
                                       False, dictionary_array(1024, 8),
                                       SMALL // 2)
            if errs.tolist() != [dc.ERR_OVERFLOW] * len(pieces):
                fail("B4 missed the output overflow")
    stream, want = more_stream()
    out, lens, errs = decode_case("more/double-FLUSH", [stream], 10, 8, True,
                                  dictionary_array(1024, 8), 1024)
    if out[0, : int(lens[0])].cpu().numpy().tobytes() != want:
        fail("B4 double-FLUSH stream decoded wrongly")
    stream, want = v1_stream()
    out, lens, errs = decode_case("v1 stream", [stream], 10, 8, False,
                                  dictionary_array(1024, 8), 1024,
                                  extended=False)
    if out[0, : int(lens[0])].cpu().numpy().tobytes() != want:
        fail("B4 v1 stream decoded wrongly")

    # payloads that fill their bucket: every decode mode keeps the final
    # token
    for hexs, raw in EXACT_BUCKET:
        stream = bytes.fromhex(hexs)
        for mode in dw.MODES:
            if dw.decode_shards_wavefront([stream], max_out=4096, device=dev,
                                          mode=mode) != [raw]:
                fail(f"mode {mode} dropped a bucket-filling payload's final "
                     "token")
        if dser.decode_shards_device([stream], max_out=4096,
                                     device=dev) != [raw]:
            fail("the serial decoder dropped a bucket-filling payload's "
                 "final token")
    report("exact-bucket payloads: equal to their input in modes "
           f"{dw.MODES} and the serial algorithm")

    # empty and tiny shards through the entry points, card against plain
    tiny = b"".join(bytes([97 + k % 3]) * (k % 5) for k in range(40))
    for name, kw, _kernels in PATHS:
        for data, size in ((b"", SMALL), (tiny, 7), (tiny, 16), (tiny, 17)):
            blob = compress_sharded(data, shard_size=size, device=dev, **kw)
            if blob != compress_sharded(data, shard_size=size, device="cpu",
                                        **kw):
                fail(f"{name}: tiny shards of {size} bytes encode "
                     "differently")
            for alg in ("wavefront", "serial"):
                if bytes(decompress_sharded_device(
                        blob, algorithm=alg, device=dev)) != data:
                    fail(f"{name}: tiny shards of {size} bytes did not "
                         f"round-trip ({alg})")
        report(f"entry points, {name}: empty and tiny shards equal to the "
               "plain versions")

    # the greedy encode on empty and tiny shards, both pulls: equal to the
    # table-less committer, and decoded back
    for pull in ("sparse", "dense"):
        for lazy in (False, True):
            for data, size in ((b"", SMALL), (tiny, 7), (tiny, 16),
                               (tiny, 17)):
                pieces = [data[i : i + size]
                          for i in range(0, len(data), size)] or [b""]
                got = encode_ext_device_greedy(pieces, lazy_matching=lazy,
                                               pull=pull, device=dev)
                if got != [greedy_compress(x, lazy_matching=lazy)
                           for x in pieces]:
                    fail(f"greedy {pull} lazy={lazy}: tiny shards of {size} "
                         "bytes differ from the table-less committer")
                blob = _pack_frame(got, len(data), size)
                for alg in ("wavefront", "serial"):
                    if bytes(decompress_sharded_device(
                            blob, algorithm=alg, device=dev)) != data:
                        fail(f"greedy {pull} lazy={lazy}: tiny shards of "
                             f"{size} bytes did not round-trip ({alg})")
    report("entry points, greedy sparse and dense pulls, lazy and not: empty "
           "and tiny shards equal to the table-less committer")


def device_rows(shards, kw: dict):
    """The rows kernel B5 reads on ``engine="device"`` for ``shards`` and
    the options ``kw``: the model histories (extended) or the raw shards
    (v1), and the initial window."""
    import numpy as np

    from tamp_tpu_torch.dictionary import dictionary_array
    from tamp_tpu_torch.engine.encode_extended import model_inputs

    window, literal = kw.get("window", 10), kw.get("literal", 8)
    extended = kw.get("extended", True)
    datas = [np.frombuffer(x, np.uint8) for x in shards]
    if kw.get("dictionary") is not None:
        d = np.frombuffer(kw["dictionary"], np.uint8).copy()
    else:
        d = dictionary_array(1 << window, literal if extended else 8)
    if extended:
        return [model_inputs(x, window)[2] for x in datas], d
    return datas, d


def b5_device_err(dev, shards, kw: dict) -> int:
    """Kernel B5 against its plain version (both on the card) on the rows
    and at the cap and probe ``engine="device"`` gives it for ``shards``
    (extended: cap 16 over the model histories; v1: the v1 cap over the
    raw shards); returns the largest element difference."""
    import torch

    from tamp_tpu_torch.engine.pipeline import pad_shards
    from tamp_tpu_torch.ops.encode_fused import v1_cap
    from tamp_tpu_torch.ops.match_v1 import v1_tables, v1_tables_plain

    rows, d = device_rows(shards, kw)
    batch, npos = pad_shards(rows)
    args = (torch.from_numpy(batch).to(dev), torch.from_numpy(npos).to(dev),
            torch.from_numpy(d).to(dev))
    window, literal = kw.get("window", 10), kw.get("literal", 8)
    cap = 16 if kw.get("extended", True) else v1_cap(window, literal)
    opts = dict(window_bits=window, cap=cap,
                probe=kw.get("lazy_matching", False))
    return max_abs_err(zip(v1_tables(*args, **opts),
                           v1_tables_plain(*args, **opts)))


def phase_device_small(dev, report):
    """Phase 2, ``engine="device"`` at small size: v1 lazy at w8 and w15
    (l5), custom dictionaries, empty input, and the file path's batch
    shapes (1, 7 and 203 shards, the last short).  Each case: kernel B5
    against its plain version on the card at the path's rows, cap and
    probe; the streams of ``encode_device_batch`` on the card equal to the
    plain versions' (``device="cpu"``) and decoded back; for the batch
    shapes ``compress_file_sharded`` equal to ``compress_sharded``."""
    import io

    import numpy as np

    from tamp_tpu_torch.engine.pipeline import encode_device_batch
    from tamp_tpu_torch.parallel.shard import (
        _pack_frame, compress_file_sharded, compress_sharded,
        decompress_sharded_device,
    )

    text = corpus(SMALL, seed=12)
    l5 = bytes(b & 31 for b in text)
    custom = np.random.default_rng(0x5EED).integers(
        97, 123, 1 << 10).astype(np.uint8).tobytes()

    def cut(raw, size):
        return [raw[i : i + size] for i in range(0, len(raw), size)] or [b""]

    cases = (
        ("v1 lazy w8 l5", l5[:8192], 4096,
         dict(window=8, literal=5, extended=False, lazy_matching=True)),
        ("v1 lazy w15 l5", l5[:8192], 4096,
         dict(window=15, literal=5, extended=False, lazy_matching=True)),
        ("extended, custom dictionary", text[:16384], 8192,
         dict(dictionary=custom)),
        ("extended lazy, custom dictionary", text[:16384], 8192,
         dict(dictionary=custom, lazy_matching=True)),
        ("v1, custom dictionary", text[:16384], 8192,
         dict(dictionary=custom, extended=False)),
        ("extended, empty input", b"", 4096, {}),
        ("v1 lazy, empty input", b"", 4096,
         dict(extended=False, lazy_matching=True)),
        ("extended, file batch of 1 shard", text[:3000], 4096, {}),
        ("extended lazy, file batch of 7 shards", text[: 6 * 1024 + 300],
         1024, dict(lazy_matching=True)),
        ("v1, file batch of 203 shards", text[: 202 * 256 + 17], 256,
         dict(extended=False)),
    )
    for name, raw, size, kw in cases:
        shards = cut(raw, size)
        err = b5_device_err(dev, shards, kw)
        if err:
            fail(f"device {name}: B5 differs from its plain version "
                 f"(max_abs_err {err})")
        got = encode_device_batch(shards, device=dev, **kw)
        if got != encode_device_batch(shards, device="cpu", **kw):
            fail(f"device {name}: the card's streams differ from the plain "
                 "versions'")
        blob = _pack_frame(got, len(raw), size)
        dictionary = kw.get("dictionary")
        for alg in ("wavefront", "serial"):
            if bytes(decompress_sharded_device(
                    blob, algorithm=alg, dictionary=dictionary,
                    device=dev)) != raw:
                fail(f"device {name}: the container did not round-trip "
                     f"({alg})")
        if "file batch" in name:
            dst = io.BytesIO()
            compress_file_sharded(io.BytesIO(raw), dst, shard_size=size,
                                  workers=-(-len(shards) // 2),
                                  engine="device", device=dev, **kw)
            if dst.getvalue() != compress_sharded(
                    raw, engine="device", shard_size=size, device=dev, **kw):
                fail(f"device {name}: the file container differs from "
                     "compress_sharded's")
        report(f"engine=device, {name} ({len(shards)} shards): B5 equal to "
               "its plain version, streams equal to the plain versions', "
               "round trip equal")


def phase_device(dev, report, data, blobs, launches, shard_size: int,
                 card: str):
    """Phase 3, ``engine="device"`` (extended, extended lazy and v1) after
    their round trips: B5's launches a call; for the extended paths B5's
    tables at full size element-equal to its plain version on the card;
    the v1 and v1 lazy containers equal to the v1 and v1 lazy
    ``device-commit`` ones (v1 runs that encode); each container decoded
    by the serial
    algorithm; ``compress_file_sharded`` through a temporary file equal
    to ``compress_sharded``'s container, with its rate; the device's idle
    share of each encode."""
    import tempfile

    from tamp_tpu_torch.parallel.shard import (
        compress_file_sharded, compress_sharded, decompress_sharded_device,
    )

    if blobs["device v1"] != blobs["v1"]:
        fail("device v1: the container differs from the v1 device-commit "
             "container")
    lazy_v1 = compress_sharded(data, engine="device", extended=False,
                               lazy_matching=True, shard_size=shard_size,
                               device=dev)
    if lazy_v1 != blobs["v1 lazy"]:
        fail("device v1 lazy: the container differs from the v1 lazy "
             "device-commit container")
    report("  device v1, device v1 lazy: containers equal to the v1 and v1 "
           "lazy device-commit ones")
    shards = [data[i : i + shard_size]
              for i in range(0, len(data), shard_size)]
    kws = {name: kw for name, kw, _k in PATHS}
    with tempfile.TemporaryDirectory() as tmp:
        src = Path(tmp) / "corpus.bin"
        src.write_bytes(data)
        for name in DEVICE_PATHS:
            kw = {k: v for k, v in kws[name].items() if k != "engine"}
            report(f"  {name}: B5 launches a call "
                   f"{launches[name]['v1_tables']}")
            if kw.get("extended", True):
                err = b5_device_err(dev, shards, kw)
                if err:
                    fail(f"{name}: B5 differs from its plain version at "
                         f"full size (max_abs_err {err})")
                report(f"  {name}: B5's tables of the model histories "
                       "equal to its plain version at full size")
            ms, back = cuda_ms(lambda: decompress_sharded_device(
                blobs[name], algorithm="serial", device=dev))
            if bytes(back) != data:
                fail(f"{name}: the serial decode differs from the input")
            dst = Path(tmp) / "out.ttpu"
            fms, _n = cuda_ms(lambda: compress_file_sharded(
                src, dst, shard_size=shard_size, engine="device", device=dev,
                **kw))
            if dst.read_bytes() != blobs[name]:
                fail(f"{name}: the file container differs from "
                     "compress_sharded's")
            report(f"  {name}: serial decode equal, "
                   f"{len(data) / ms / 1e3:.2f} MB/s; compress_file_sharded "
                   f"equal to compress_sharded, {len(data) / fms / 1e3:.2f} "
                   f"MB/s [{card}]")
            idle_share(report, f"{name} encode", lambda: compress_sharded(
                data, shard_size=shard_size, device=dev, **kws[name]), card)


def phase_device_split(dev, report, data, blob, shard_size: int, card: str):
    """Where the extended ``engine="device"`` encode's time goes, through
    the entry's own stage functions (engine/encode_extended.py,
    engine/pipeline.py), host clock around work that ends in a
    synchronize, median of 3 after a warm-up: the model inputs (a thread a
    shard), the pad, the copy to the card, B5, the pack and the one pull,
    the gather and the two commits a shard (a thread a shard), the frame;
    the staged container equal to the round trip's (``blob``)."""
    import numpy as np
    import torch

    from tamp_tpu_torch.dictionary import dictionary_array
    from tamp_tpu_torch.engine.encode_extended import ext_commits, model_inputs
    from tamp_tpu_torch.engine.pipeline import (
        device_tables, pack_tables, pad_shards, per_shard,
    )
    from tamp_tpu_torch.parallel.shard import _pack_frame, compress_sharded

    window, literal = 10, 8
    datas = [np.frombuffer(data[i : i + shard_size], np.uint8)
             for i in range(0, len(data), shard_size)]
    stages: dict[str, list[float]] = {}
    timed = timed_stages(dev, stages)

    commits = "gather + two commits a shard (a thread a shard)"
    for _ in range(4):
        model = timed("host prep (plan, model history; a thread a shard)",
                      lambda: per_shard(lambda i: model_inputs(
                          datas[i], window), len(datas)))
        batch, npos = timed("host pad", lambda: pad_shards(
            [m[2] for m in model]))
        args = timed("host->device", lambda: (
            torch.from_numpy(batch).to(dev), torch.from_numpy(npos).to(dev),
            torch.from_numpy(dictionary_array(1 << window, literal)).to(dev)))
        tabs = timed("B5 device_tables (cap 16)", lambda: device_tables(
            *args, window=window, lazy=False))
        planes = timed("pack + device->host (one pull)",
                       lambda: pack_tables(tabs, window).cpu().numpy())
        streams = timed(commits, lambda: ext_commits(
            datas, model, planes, window=window, literal=literal,
            lazy_matching=False, dictionary=None))
        framed = timed("frame", lambda: _pack_frame(streams, len(data),
                                                    shard_size))
        timed("whole compress_sharded call", lambda: compress_sharded(
            data, shard_size=shard_size, engine="device", device=dev))
        del tabs, args
    if framed != blob:
        fail("device: the staged encode differs from the round trip's")
    for stage, ts in stages.items():
        ms = statistics.median(ts[1:])
        report(f"  device encode {stage}: {ms:.2f} ms [{card}]")


def b7_inputs(data, npos, d, *, window: int, lazy: bool):
    """Kernel B7's inputs as the greedy path makes them from the raw rows
    ``data``: the packed walker plane ``pk`` and the probe plane ``pp``
    (None without lazy matching)."""
    from tamp_tpu_torch.engine import pipeline_ext as pe

    tabs = pe.greedy_tables(data, npos, d, window=window, lazy=lazy)
    return pe.greedy_predict_planes(data, npos, tabs, int(d[-1]), lazy=lazy)


def b7_pair(data, npos, d, *, window: int, literal: int, lazy: bool):
    """B7 on the card and its plain version on the same inputs: (bitmap,
    entries, state, plain results)."""
    from tamp_tpu_torch.ops.greedy_predict import (
        greedy_predict_batch, greedy_predict_plain,
    )

    pk, pp = b7_inputs(data, npos, d, window=window, lazy=lazy)
    kw = dict(NP=pk.shape[1], window=window, literal=literal, lazy=lazy)
    bm, ent, st = greedy_predict_batch(pk, pp, npos, **kw)
    plain = greedy_predict_plain(pk, pp, npos, **kw)
    sync(data.device)
    return bm, ent, st, plain


def b7_err(got, plain) -> int:
    """max_abs_err of B7's outputs against its plain version: bitmap and
    state whole, entries up to each shard's count (the kernel leaves the
    rest of the row unwritten)."""
    bm, ent, st = got
    pbm, pent, pst = plain
    n = pst[:, 0].tolist()
    return max_abs_err([(bm, pbm), (st, pst)] + [
        (ent[s, :k], pent[s, :k]) for s, k in enumerate(n)])


def phase_main_path(dev, report, data, shard_size: int, card: str,
                    name: str, kw: dict, kernels, rates=None):
    """Phase 3: one round trip at full size, which must launch each of
    ``kernels``; returns (blob, launches, ratio) with the launch counts of
    that one round trip, and puts its encode and decode MB/s into
    ``rates[name]`` where ``rates`` is given."""
    import torch

    from tamp_tpu_torch.parallel.shard import (
        compress_sharded, decompress_sharded_device,
    )

    fns = counters()
    for fn in fns.values():
        fn.launches = 0
    blob = compress_sharded(data, shard_size=shard_size, device=dev, **kw)
    back = decompress_sharded_device(blob, device=dev)
    launches = {k: fn.launches for k, fn in fns.items()}
    if bytes(back) != data:
        fail(f"{name}: the round trip differs")
    ratio = len(blob) / len(data)
    report(f"phase 3, {name}: round trip of {len(data)} bytes in "
           f"{-(-len(data) // shard_size)} shards equal; ratio {ratio:.6f}; "
           f"launches {launches}")
    for k in kernels:
        if launches[k] <= 0:
            fail(f"{name}: kernel {k} was not launched")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    enc_ms, blob2 = cuda_ms(lambda: compress_sharded(
        data, shard_size=shard_size, device=dev, **kw))
    dec_ms, _ = cuda_ms(lambda: decompress_sharded_device(blob, device=dev))
    if blob2 != blob:
        fail(f"{name}: the encode is not deterministic")
    peak = (torch.cuda.max_memory_allocated() / 2**30
            if dev.type == "cuda" else 0.0)
    if rates is not None:
        rates[name] = (len(data) / enc_ms / 1e3, len(data) / dec_ms / 1e3)
    report(f"  {name}: encode {len(data) / enc_ms / 1e3:.2f} MB/s "
           f"({enc_ms:.1f} ms), decode {len(data) / dec_ms / 1e3:.2f} MB/s "
           f"({dec_ms:.1f} ms), ratio {ratio:.6f}, peak device memory "
           f"{peak:.2f} GiB [{card}]")
    piece = data[:40000] + data[len(data) // 2 : len(data) // 2 + 20000]
    on_card = compress_sharded(piece, shard_size=1 << 15, device=dev, **kw)
    if on_card != compress_sharded(piece, shard_size=1 << 15, device="cpu",
                                   **kw):
        fail(f"{name}: card and plain-version containers differ on a small "
             "input")
    if bytes(decompress_sharded_device(on_card, device="cpu")) != piece:
        fail(f"{name}: plain-version decode of the card's container differs")
    report(f"  {name}: the card's container equals the plain versions' on "
           f"{len(piece)} bytes")
    return blob, launches, ratio


def phase_decode_modes(dev, report, data, blobs, shard_size: int,
                       card: str):
    """Phase 3, the decode modes: each container of ``blobs`` (by path
    name) decoded in modes commit, chase and xla and by the serial
    algorithm, through ``decompress_sharded_device`` with
    ``TAMP_TPU_DECODE`` set.  Each decode must give the input and launch
    its kernels (B4 on no mode but commit); returns the launch counts of
    each one decode and the rates, by (container, mode)."""
    import os

    from tamp_tpu_torch.parallel.shard import decompress_sharded_device

    fns = counters()
    launches, rates = {}, {}
    for name, blob in blobs.items():
        for mode, kernels in (("commit", ("parse_words", "commit_decode")),
                              ) + DECODES:
            alg = "serial" if mode == "serial" else "wavefront"
            os.environ["TAMP_TPU_DECODE"] = mode if alg == "wavefront" \
                else "commit"
            try:
                for fn in fns.values():
                    fn.launches = 0
                back = decompress_sharded_device(blob, algorithm=alg,
                                                 device=dev)
                got = {k: fn.launches for k, fn in fns.items()}
                if bytes(back) != data:
                    fail(f"{name}, mode {mode}: the decode differs from the "
                         "input")
                for k in kernels:
                    if got[k] <= 0:
                        fail(f"{name}, mode {mode}: kernel {k} was not "
                             "launched")
                if mode != "commit" and got["commit_decode"]:
                    fail(f"{name}, mode {mode}: B4 was launched")
                ms, _ = cuda_ms(lambda: decompress_sharded_device(
                    blob, algorithm=alg, device=dev))
            finally:
                del os.environ["TAMP_TPU_DECODE"]
            launches[name, mode] = got
            rates[name, mode] = len(data) / ms / 1e3
            ran = {k: n for k, n in got.items() if n}
            report(f"  decode {name}, mode {mode}: equal, "
                   f"{rates[name, mode]:.2f} MB/s ({ms:.1f} ms), launches "
                   f"{ran} [{card}]")
    return launches, rates


def phase_commit_shapes(dev, report, data, card: str):
    """Phase 3, mode commit at the shapes far from the cell's
    (COMMIT_SHAPES): one 4 KiB shard, where B4's fixed launch costs weigh
    most, and window 15 on 64 shards, where its ring is largest and its
    front has the most shards.  Each container (``device-commit``, cut from
    ``data``) decoded by ``decompress_sharded_device`` must give its input
    back; reports the call's median ms and MB/s, B4's device ms a call
    (every kernel whose name holds ``commit_decode_kernel``) and its
    wrapper launches a call; B4's launches are counted and timed in a
    short child process (:func:`b4_launches`).  Returns {name: (call ms,
    B4 ms)}."""
    from tamp_tpu_torch.ops import decode_commit as dc
    from tamp_tpu_torch.parallel.shard import (
        compress_sharded, decompress_sharded_device,
    )

    calls, jobs = {}, {}
    for name, shards, window in COMMIT_SHAPES:
        raw = data[: 4096 * shards] if shards == 1 else data
        blob = compress_sharded(raw, window=window, device=dev,
                                shard_size=-(-len(raw) // shards),
                                engine="device-commit")
        fn = lambda: decompress_sharded_device(blob, mode="commit",  # noqa
                                               device=dev)
        before = dc.commit_decode.launches
        if bytes(fn()) != raw:
            fail(f"commit decode {name}: the output differs from the input")
        n = dc.commit_decode.launches - before
        ms, _peak, _o = median_ms(dev, fn, reps=21 if shards == 1 else 7)
        calls[name] = (len(raw), ms, n)
        jobs[name] = dict(blob=blob)
    out = {}
    for name, split in b4_launches(jobs).items():
        nbytes, ms, n = calls[name]
        out[name] = (ms, sum(split.values()))
        report(f"  commit decode {name}: {nbytes} bytes, {ms:.3f} ms a "
               f"call ({nbytes / ms / 1e3:.2f} MB/s), B4 {out[name][1]:.4f}"
               f" ms on the card, {n} B4 call(s) [{card}]")
    return out


def b4_launches(jobs: dict) -> dict:
    """B4's four launches (B4_LAUNCHES) counted and timed by the profiler
    in a short child process (``--b4-child``), where the trace holds every
    kernel: in the smoke's own long process it misses most of them.  Each
    job is dict(blob=container), decoded by ``decompress_sharded_device``
    in mode commit, or dict(pk=words, d=dictionary, W=..., max_out=...,
    min_bits=...), B4's wrapper on those words.  Fails unless each
    of the four kernels runs once a wrapper call.  Returns {job: {launch:
    device ms a job's call}}."""
    import tempfile

    import torch

    with tempfile.TemporaryDirectory() as tmp:
        torch.save({k: {n: v.cpu() if torch.is_tensor(v) else v
                        for n, v in job.items()} for k, job in jobs.items()},
                   Path(tmp, "jobs.pt"))
        try:
            r = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()), "--b4-child",
                 tmp], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True, timeout=B4_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            fail(f"the B4 child ran past {B4_TIMEOUT_S} s")
        if r.returncode != 0:
            fail(f"the B4 child exited {r.returncode}:\n{r.stdout[-4000:]}")
        got = json.loads(Path(tmp, "b4.json").read_text())
    out = {}
    for name, res in got.items():
        n = res["calls"]  # wrapper calls: one or more a job's call
        if n < B4_REPS or n % B4_REPS or any(
                c != n for c in res["counts"].values()):
            fail(f"B4 ({name}): {n} wrapper calls and kernels "
                 f"{res['counts']} in {B4_REPS} calls")
        out[name] = {k: ms / B4_REPS for k, ms in res["ms"].items()}
    return out


def b4_child(tmp: str) -> int:
    """``--b4-child DIR``: each job of DIR/jobs.pt (:func:`b4_launches`)
    once to warm up, then B4_REPS times under the profiler; writes
    DIR/b4.json: {job: {calls: wrapper calls, counts: {launch: kernels},
    ms: {launch: device ms}}}."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tamp_tpu_torch.ops import decode_commit as dc
    from tamp_tpu_torch.parallel.shard import decompress_sharded_device

    dev = torch.device("cuda")
    res = {}
    for name, job in torch.load(Path(tmp, "jobs.pt")).items():
        if "blob" in job:
            fn = lambda: decompress_sharded_device(  # noqa: E731
                job["blob"], mode="commit", device=dev)
        else:
            pk, d = job["pk"].to(dev), job["d"].to(dev)
            fn = lambda: dc._launch(  # noqa: E731
                pk, d, d, W=job["W"], more=False, max_out=job["max_out"],
                min_bits=job["min_bits"])
        fn()
        torch.cuda.synchronize()
        before = dc.commit_decode.launches
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(B4_REPS):
                fn()
            torch.cuda.synchronize()
        counts = {k: 0 for k in B4_LAUNCHES}
        ms = {k: 0.0 for k in B4_LAUNCHES}
        for e in prof.events():
            if e.device_type != DeviceType.CUDA:
                continue
            for k, key in B4_LAUNCHES.items():
                if key in e.name:
                    counts[k] += 1
                    ms[k] += (e.time_range.end - e.time_range.start) / 1e3
        res[name] = dict(calls=dc.commit_decode.launches - before,
                         counts=counts, ms=ms)
    Path(tmp, "b4.json").write_text(json.dumps(res))
    return 0


def timed_stages(dev, stages: dict):
    """``timed(stage, fn)``: ``fn()`` between two synchronizes, its host
    ms appended to ``stages[stage]``."""
    def timed(stage, fn):
        sync(dev)
        t = time.perf_counter()
        out = fn()
        sync(dev)
        stages.setdefault(stage, []).append((time.perf_counter() - t) * 1e3)
        return out
    return timed


def phase_mesh(dev, report, data, blobs, card: str):
    """Phase 3, the mesh layer (``parallel/shard.make_mesh`` and its two
    steps) in a world of one process, this one, on the card: the search
    step on the corpus as (8, 1 MiB) at w10 l8 (B5 once, its tables equal
    to B5's plain version on the card, the estimate equal to the plain
    tables' at rel 1e-5; its ms, median of 3 after a warm-up, and a stage
    split); the decode step on the main path's 8 streams in modes commit
    (B4 once) and xla (X1, no B4): the corpus back, its total, its MB/s; a
    stream reading past the window end raises ValueError.  The group is
    destroyed at the end.  Returns the launch counts of each step by
    name."""
    import os

    import numpy as np
    import torch
    import torch.distributed as dist

    from tamp_tpu_torch.dictionary import dictionary_array
    from tamp_tpu_torch.engine.pipeline import pad_shards
    from tamp_tpu_torch.ops.match_v1 import v1_tables, v1_tables_plain
    from tamp_tpu_torch.parallel.shard import (
        _gather_rows, _parse_frame, estimate_bits, make_mesh,
        sharded_decode_step, sharded_search_step,
    )

    window, literal = 10, 8
    arr = np.frombuffer(data, np.uint8).reshape(8, -1)
    mesh = make_mesh()
    report(f"phase 3, mesh: {mesh} on {dev}, backend "
           f"{dist.get_backend_config()}")
    fns = counters()
    launches = {}

    def counted(name, fn):
        for f in fns.values():
            f.launches = 0
        out = fn()
        launches[name] = {k: f.launches for k, f in fns.items()}
        return out

    out = counted("search", lambda: sharded_search_step(mesh, arr, window,
                                                        literal))
    ran = {k: n for k, n in launches["search"].items() if n}
    if ran != {"v1_tables": 1}:
        fail(f"mesh search step: launches {ran}, not B5 once")
    rows, npos = pad_shards(list(arr))
    args = (torch.from_numpy(rows).to(dev), torch.from_numpy(npos).to(dev),
            torch.from_numpy(dictionary_array(1 << window, literal)).to(dev))
    plain = v1_tables_plain(*args, window_bits=window, cap=16)
    err = max_abs_err([(out["len16"], plain[0]), (out["idx16"], plain[1])])
    est = float(estimate_bits(plain[0], window, literal).sum())
    got = float(out["est_bits_total"])
    if err or abs(got - est) > 1e-5 * abs(est):
        fail(f"mesh search step: tables max_abs_err {err}, estimate {got} "
             f"beside the plain tables' {est}")
    del out, plain
    ms, _ = cuda_ms(lambda: sharded_search_step(mesh, arr, window, literal))
    # the step's stages, as sharded_search_step runs them
    stages: dict[str, list[float]] = {}
    timed = timed_stages(dev, stages)
    group = mesh.get_group()
    for _ in range(4):
        rows, npos = timed("host pad", lambda: pad_shards(list(arr)))
        args = timed("host->device", lambda: (
            torch.from_numpy(rows).to(dev), torch.from_numpy(npos).to(dev),
            torch.from_numpy(dictionary_array(1 << window, literal))
            .to(dev)))
        tabs = timed("B5 v1_tables (cap 16)", lambda: v1_tables(
            *args, window_bits=window, cap=16))
        est_t = timed("estimate", lambda: estimate_bits(
            tabs[0], window, literal).sum())
        timed("collectives (all_reduce, two all_gathers)", lambda: (
            dist.all_reduce(est_t, group=group),
            _gather_rows(tabs[0], group), _gather_rows(tabs[1], group)))
        del tabs, args
    split = {k: statistics.median(v[1:]) for k, v in stages.items()}
    b5 = split["B5 v1_tables (cap 16)"]
    report(f"  mesh search step (8 x {arr.shape[1]}, w10 l8): equal to B5's "
           f"plain version, estimate {got:.1f} bits; {ms:.3f} ms, B5 "
           f"{b5:.3f} ms ({b5 / ms:.3f} of the step) [{card}]")
    for stage, t in split.items():
        report(f"  mesh search step {stage}: {t:.3f} ms [{card}]")

    _r, _s, pieces = _parse_frame(blobs["extended"])
    shard = len(data) // len(pieces)
    for mode, kernel in (("commit", "commit_decode"),
                         ("xla", "trunc_deficits")):
        os.environ["TAMP_TPU_DECODE"] = mode
        try:
            outs, lens, total = counted(
                f"decode {mode}", lambda: sharded_decode_step(
                    mesh, pieces, max_out=shard))
            ran = {k: n for k, n in launches[f"decode {mode}"].items() if n}
            b4 = 1 if mode == "commit" else 0
            if ran.get(kernel, 0) < 1 or ran.get("commit_decode", 0) != b4:
                fail(f"mesh decode step, mode {mode}: launches {ran}")
            lens_h = lens.cpu().tolist()
            back = b"".join(bytes(outs[i, :n].cpu().numpy())
                            for i, n in enumerate(lens_h))
            if back != data or int(total) != len(data):
                fail(f"mesh decode step, mode {mode}: the output differs "
                     f"from the corpus (total {int(total)})")
            del outs, lens
            dms, _ = cuda_ms(lambda: sharded_decode_step(mesh, pieces,
                                                         max_out=shard))
        finally:
            del os.environ["TAMP_TPU_DECODE"]
        report(f"  mesh decode step, mode {mode}: equal, total {int(total)}, "
               f"{len(data) / dms / 1e3:.2f} MB/s ({dms:.1f} ms), launches "
               f"{ran} [{card}]")
    try:
        sharded_decode_step(mesh, pieces[:-1] + [oob_stream()],
                            max_out=shard)
    except ValueError:
        report("  mesh decode step: a stream reading past the window end "
               "raises ValueError")
    else:
        fail("mesh decode step: a stream reading past the window end did "
             "not raise")
    dist.destroy_process_group()
    return launches


def phase_distributed(dev, report, data, blobs, card: str):
    """Phase 3, ``compress_distributed`` in a world of two processes
    sharing the card (``--dist-child``, joined over loopback; host
    gathers only: NCCL takes no two ranks on one GPU): rank 0's
    containers for ``engine="device-commit"`` and ``"device"`` equal to
    the round trips' (``extended``, ``device``), its rate (median of 3
    between barriers, after a warm-up) beside this process's
    ``compress_sharded`` rate, timed the same way.  One card: the two
    processes share its SMs, so this shows no scaling across cards."""
    import os
    import socket
    import tempfile

    import torch

    from tamp_tpu_torch.parallel.shard import compress_sharded

    one = {}
    for engine in DIST_ENGINES:
        ts = []
        for _ in range(4):
            sync(dev)
            t = time.perf_counter()
            compress_sharded(data, engine=engine, device=dev)
            sync(dev)
            ts.append((time.perf_counter() - t) * 1e3)
        one[engine] = statistics.median(ts[1:])
    torch.cuda.empty_cache()
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        addr = f"127.0.0.1:{sk.getsockname()[1]}"
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--dist-child",
             str(rank), addr, tmp], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for rank in range(2)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=DIST_TIMEOUT_S)[0])
        except subprocess.TimeoutExpired:
            fail(f"compress_distributed: a child ran past {DIST_TIMEOUT_S} s")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for rank, (p, out) in enumerate(zip(procs, outs)):
            if p.returncode != 0:
                fail(f"compress_distributed: rank {rank} exited "
                     f"{p.returncode}:\n{out[-4000:]}")
        times = json.loads(Path(tmp, "times.json").read_text())
        for engine, name in zip(DIST_ENGINES, ("extended", "device")):
            if Path(tmp, f"{engine}.ttpu").read_bytes() != blobs[name]:
                fail(f"compress_distributed, engine={engine}: rank 0's "
                     f"container differs from the one-process {name} one")
            ms = statistics.median(times[engine])
            report(f"  compress_distributed, engine={engine}, 2 processes on "
                   f"one card: container equal to compress_sharded's; "
                   f"{len(data) / ms / 1e3:.2f} MB/s ({ms:.1f} ms; runs "
                   f"{', '.join(f'{t:.1f}' for t in times[engine])}) beside "
                   f"one process {len(data) / one[engine] / 1e3:.2f} MB/s "
                   f"({one[engine]:.1f} ms): "
                   f"{one[engine] / ms:.2f}x [{card}]")
        report(f"  compress_distributed: the children ran "
               f"{time.perf_counter() - t0:.1f} s")


def phase_file_entry(dev, report, data, blobs, card: str):
    """Phase 3, the file decode and the port's entry points.
    ``decompress_file_sharded`` of the main path's container and of the
    ``engine="device"`` file that ``compress_file_sharded`` writes (equal
    to the round trip's), each in modes commit, chase and xla and by the
    serial algorithm, at FILE_WORKERS: the corpus back, each mode's kernels
    once a batch (B4 and X2 exactly), the peak device memory of each
    decode, and for the main path's container the rate (median of 3 after
    a warm-up) beside the same mode's ``decompress_sharded_device``; a
    raw size off by one and a v1 shard in the second batch raise
    ValueError.  ``entry()``: its six tables equal B5's plain version on
    the card, from two B5 launches; fn's ms.  ``dryrun_multichip`` over
    every card (a world of one on one card) runs to its end, launching
    DRYRUN_KERNELS; its seconds.  Returns the launch counts of these paths
    by wrapper name, as extra keys of their kernels' rows."""
    import os
    import struct
    import tempfile

    import torch

    from tamp_tpu_torch.entry import (
        ENTRY_T, ENTRY_WINDOW, dryrun_multichip, entry,
    )
    from tamp_tpu_torch.ops.match_v1 import v1_tables_plain
    from tamp_tpu_torch.parallel.shard import (
        _pack_frame, _parse_frame, compress_file_sharded,
        decompress_file_sharded, decompress_sharded_device,
    )

    fns = counters()
    extra: dict[str, dict] = {}

    def counted(fn):
        for f in fns.values():
            f.launches = 0
        out = fn()
        return out, {k: f.launches for k, f in fns.items() if f.launches}

    raw_size, shard_size, pieces = _parse_frame(blobs["extended"])
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        src, back = tmp / "corpus.bin", tmp / "back.bin"
        src.write_bytes(data)
        files = {"device-commit": tmp / "extended.ttpu",
                 "device": tmp / "device.ttpu"}
        files["device-commit"].write_bytes(blobs["extended"])
        compress_file_sharded(src, files["device"], shard_size=shard_size,
                              device=dev, engine="device")
        if files["device"].read_bytes() != blobs["device"]:
            fail("compress_file_sharded: the file differs from the device "
                 "round trip's container")
        for mode, alg, kernels in FILE_DECODES:
            os.environ["TAMP_TPU_DECODE"] = mode if alg == "wavefront" \
                else "commit"
            try:
                for workers in FILE_WORKERS:
                    batches = -(-len(pieces)
                                // (2 * (workers or os.cpu_count() or 4)))
                    for name, path in files.items():
                        if dev.type == "cuda":
                            torch.cuda.reset_peak_memory_stats()
                        n, ran = counted(lambda: decompress_file_sharded(
                            path, back, workers, algorithm=alg, device=dev))
                        peak = (torch.cuda.max_memory_allocated() / 2**30
                                if dev.type == "cuda" else 0.0)
                        if n != len(data) or back.read_bytes() != data:
                            fail(f"file decode {name}, mode {mode}, workers "
                                 f"{workers}: the output differs")
                        for k in kernels:
                            if ran.get(k, 0) < batches or (
                                    k in ("parse_words", "commit_decode",
                                          "serial_decode")
                                    and ran[k] != batches):
                                fail(f"file decode {name}, mode {mode}: "
                                     f"launches {ran} for {batches} batches")
                        if mode != "commit" and ran.get("commit_decode"):
                            fail(f"file decode {name}, mode {mode}: B4 ran")
                        report(f"  file decode {name}, mode {mode}, workers "
                               f"{workers} ({batches} batches): equal, "
                               f"launches {ran}, peak device memory "
                               f"{peak:.2f} GiB [{card}]")
                        if name == "device-commit":
                            for k in kernels:
                                extra.setdefault(k, {}).setdefault(
                                    "file_launches", {})[
                                    f"{mode}, {batches} batches"] = ran.get(k, 0)
                    ms, _ = cuda_ms(lambda: decompress_file_sharded(
                        files["device-commit"], back, workers, algorithm=alg,
                        device=dev))
                    report(f"  file decode rate, mode {mode}, workers "
                           f"{workers}: {len(data) / ms / 1e3:.2f} MB/s "
                           f"({ms:.1f} ms) [{card}]")
                ms, _ = cuda_ms(lambda: decompress_sharded_device(
                    blobs["extended"], algorithm=alg, device=dev))
                report(f"  decompress_sharded_device, mode {mode}, the same "
                       f"call: {len(data) / ms / 1e3:.2f} MB/s ({ms:.1f} ms) "
                       f"[{card}]")
            finally:
                del os.environ["TAMP_TPU_DECODE"]
        off = bytearray(blobs["extended"])
        struct.pack_into("<Q", off, 10, raw_size + 1)
        v1_shard = _parse_frame(blobs["v1"])[2][5]
        mixed = _pack_frame(pieces[:5] + [v1_shard] + pieces[6:], raw_size,
                            shard_size)
        for name, blob in (("a raw size off by one", bytes(off)),
                           ("a v1 shard in the second batch", mixed)):
            bad = tmp / "bad.ttpu"
            bad.write_bytes(blob)
            try:
                decompress_file_sharded(bad, back, 2, device=dev)
            except ValueError as e:
                report(f"  file decode of {name}: ValueError ({e})")
            else:
                fail(f"file decode of {name} did not raise")
    report(f"phase 3: file decodes done ({time.perf_counter() - t0:.1f} s)")

    fn, args = entry()
    got, ran = counted(lambda: fn(*args))
    if ran != {"v1_tables": 2}:
        fail(f"entry(): launches {ran}, not B5 twice")
    kw = dict(window_bits=ENTRY_WINDOW)
    l15, i15, pl, pi = v1_tables_plain(*args, cap=15, probe=True, **kw)
    l16, i16 = v1_tables_plain(*args, cap=16, **kw)
    err = max_abs_err(zip(got, (t[0, :ENTRY_T]
                                for t in (l15, i15, l16, i16, pl, pi))))
    if err:
        fail(f"entry(): tables differ from B5's plain version by {err}")
    ms, _ = cuda_ms(lambda: fn(*args))
    extra.setdefault("v1_tables", {})["entry_launches"] = ran.get(
        "v1_tables", 0)
    report(f"  entry(): six tables equal to B5's plain version, launches "
           f"{ran}; fn {ms:.4f} ms [{card}]")

    n_dev = torch.cuda.device_count()
    t = time.perf_counter()
    _, ran = counted(lambda: dryrun_multichip(n_dev))
    secs = time.perf_counter() - t
    missing = [k for k in DRYRUN_KERNELS if not ran.get(k)]
    if missing:
        fail(f"dryrun_multichip: kernels {missing} were not launched")
    for k, n in ran.items():
        extra.setdefault(k, {})["dryrun_launches"] = n
    report(f"  dryrun_multichip({n_dev}): ran to its end in {secs:.2f} s; "
           f"launches {ran} [{card}]")
    return extra


def dict_corpus(n: int, seed: int = 0x5EED) -> list[bytes]:
    """Seeded JSON-like sensor records (~115 bytes each): a few keys in
    random subsets and order, random readings and node ids."""
    import random

    rng = random.Random(seed)
    keys = (b"temperature", b"humidity", b"pressure", b"battery",
            b"firmware", b"timestamp", b"uptime", b"rssi")
    out = []
    for _ in range(n):
        parts = [b'{"device_id": "node-%d", ' % rng.randrange(500)]
        for k in rng.sample(keys, rng.randint(2, 6)):
            parts.append(b'"%s": %d.%d, ' % (k, rng.randrange(100),
                                             rng.randrange(10)))
        parts.append(b'"status": "%s"}' % rng.choice((b"ok", b"warn",
                                                       b"fail")))
        out.append(b"".join(parts))
    return out


def median_ms(dev, fn, reps: int = ONE_SHOT_REPS):
    """(median ms, peak device GiB, last result) of ``reps`` calls of
    ``fn``: CUDA events around each and the allocator's peak on the card
    over all of them, the host clock (and 0) elsewhere."""
    import torch

    times = []
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    for _ in range(reps):
        if dev.type != "cuda":
            t = time.perf_counter()
            out = fn()
            times.append((time.perf_counter() - t) * 1e3)
            continue
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    peak = (torch.cuda.max_memory_allocated() / 2**30
            if dev.type == "cuda" else 0.0)
    return statistics.median(times), peak, out


@contextlib.contextmanager
def plain_kernels():
    """A context in which every kernel wrapper of the port that the
    one-shots reach is replaced, in each module of the package that holds
    it, by its plain version, which runs on the same tensors (tensor ops on
    the card; B3's, B6's and B7's walks on host copies): a route run inside
    launches no kernel and counts nothing."""
    from tamp_tpu_torch.ops.encode_commit import (
        commit_fields_plain, commit_v1_lazy_plain,
    )
    from tamp_tpu_torch.ops.greedy_predict import greedy_predict_plain
    from tamp_tpu_torch.ops.match_v1 import v1_tables_plain
    from tamp_tpu_torch.ops.opt_parse import opt_v1_choice_plain
    from tamp_tpu_torch.ops.opt_parse_ext import opt_ext_choice_plain

    plains = {"v1_tables": v1_tables_plain,
              "greedy_predict_batch": greedy_predict_plain,
              "commit_fields": commit_fields_plain,
              "commit_v1_lazy": commit_v1_lazy_plain,
              "opt_v1_choice": opt_v1_choice_plain,
              "opt_ext_choice": opt_ext_choice_plain}
    fns = counters()
    saved = []
    for mod in list(sys.modules.values()):
        if not getattr(mod, "__name__", "").startswith("tamp_tpu_torch"):
            continue
        for name, plain in plains.items():
            if getattr(mod, name, None) is fns[name]:
                saved.append((mod, name))
                setattr(mod, name, plain)
    try:
        yield
    finally:
        for mod, name in saved:
            setattr(mod, name, fns[name])


def phase_front_door(dev, report, data, blobs, rates, card: str):
    """Phase 3, the package's front door on the card.

    The one-shots (``tamp_tpu_torch.compress`` / ``decompress``) of the
    corpus as one stream for each route of ONE_SHOTS: each route's kernels
    launched, the stream decoded back by one X2 launch, ONE_SHOT_REPS more
    compresses and decompresses timed (median MB/s and peak device memory)
    beside phase 3's 8 x 1 MiB rates of the same encode; each route's
    stream equal to the one its route gives with every kernel replaced by
    its plain version (:func:`plain_kernels`) on the same input, and the
    extended streams also to the table-less host committer's; one byte
    past ``MAX_STREAM_BYTES`` refused with ValueError; an RLE stream of
    ~92x expansion decoded whole by three X2 launches (the output room
    grown twice).  The CLI in process (``cli.main.main``) on temporary
    files and on stdin/stdout: compress and decompress of a raw stream,
    ``--sharded`` both ways (extended and v1), ``--optimal`` with and
    without ``--sharded``, ``-d`` with a 100-byte dictionary, the decode of
    containers and raw streams, each output equal to the API's or phase
    3's containers, with its seconds and launches.  ``build-dictionary
    --auto-trim`` on DICT_SAMPLES seeded records: B5 and B7 once a
    threshold, the dictionary smaller on the corpus than the default one,
    its totals on a few records equal to the plain versions'; its seconds.
    Returns the launch counts by wrapper name (``api_launches``,
    ``cli_launches``)."""
    import io
    import tempfile

    import tamp_tpu_torch as tt
    from tamp_tpu_torch.cli.main import main as cli
    from tamp_tpu_torch.dictbuild import evaluate_dictionary_tradeoff
    from tamp_tpu_torch.engine.greedy import greedy_compress

    fns = counters()
    extra: dict[str, dict] = {}

    def counted(fn):
        for f in fns.values():
            f.launches = 0
        out = fn()
        return out, {k: f.launches for k, f in fns.items() if f.launches}

    def note(key: str, leg: str, ran: dict):
        for k, n in ran.items():
            extra.setdefault(k, {}).setdefault(key, {})[leg] = n

    t0 = time.perf_counter()
    streams = {}
    for route, kw, kernels, path in ONE_SHOTS:
        blob, ran = counted(lambda: tt.compress(data, device=dev, **kw))
        missing = [k for k in kernels if not ran.get(k)]
        if missing:
            fail(f"one-shot {route}: kernels {missing} were not launched "
                 f"({ran})")
        back, dran = counted(lambda: tt.decompress(blob, device=dev))
        if back != data:
            fail(f"one-shot {route}: the decode differs")
        if dran != {"serial_decode": 1}:
            fail(f"one-shot {route}: the decode launched {dran}, not X2 "
                 "once")
        enc_ms, enc_peak, again = median_ms(
            dev, lambda: tt.compress(data, device=dev, **kw))
        if again != blob:
            fail(f"one-shot {route}: the encode is not deterministic")
        dec_ms, dec_peak, _ = median_ms(
            dev, lambda: tt.decompress(blob, device=dev))
        note("api_launches", f"{route} compress", ran)
        note("api_launches", f"{route} decompress", dran)
        streams[route] = blob
        enc_s, dec_s = rates[path]
        report(f"  one-shot {route}: {len(data)} bytes as one stream, "
               f"ratio {len(blob) / len(data):.6f}; compress "
               f"{len(data) / enc_ms / 1e3:.2f} MB/s ({enc_ms:.1f} ms, median "
               f"of {ONE_SHOT_REPS}, peak device memory {enc_peak:.3f} GiB), "
               f"decompress (X2, one CTA) {len(data) / dec_ms / 1e3:.2f} MB/s "
               f"({dec_ms:.1f} ms, median of {ONE_SHOT_REPS}, peak "
               f"{dec_peak:.3f} GiB); the same encode in 8 x 1 MiB shards "
               f"({path}): compress {enc_s:.2f} MB/s, decompress (B4) "
               f"{dec_s:.2f} MB/s; launches {ran}, {dran} [{card}]")
    for route, lazy in (("extended", False), ("extended lazy", True)):
        if streams[route] != greedy_compress(data, lazy_matching=lazy):
            fail(f"one-shot {route}: the stream differs from the "
                 "table-less committer's")
    report("  one-shots extended and extended lazy: streams equal to the "
           "table-less committer's")
    t = time.perf_counter()
    with plain_kernels():
        for route, kw, _kernels, _path in ONE_SHOTS:
            plain, ran = counted(lambda: tt.compress(data, device=dev, **kw))
            if ran:
                fail(f"one-shot {route}: the plain route launched {ran}")
            if plain != streams[route]:
                fail(f"one-shot {route}: the card's stream of {len(data)} "
                     "bytes differs from the plain versions'")
    report(f"  one-shots: every route's stream of {len(data)} bytes equal "
           "to the one of its route with the plain versions in place of "
           f"the kernels, on the card ({time.perf_counter() - t:.1f} s)")
    try:
        tt.compress(bytes(tt.MAX_STREAM_BYTES + 1), device=dev)
    except ValueError as e:
        report(f"  one-shot of MAX_STREAM_BYTES + 1 bytes: ValueError ({e})")
    else:
        fail("one-shot: MAX_STREAM_BYTES + 1 bytes did not raise")
    runs = bytes([7]) * len(data)
    blob = tt.compress(runs, device=dev)
    back, dran = counted(lambda: tt.decompress(blob, device=dev))
    if back != runs or dran != {"serial_decode": 3}:
        fail(f"RLE stream: decoded equal {back == runs}, launches {dran} "
             "(X2 three times: the room grown twice)")
    note("api_launches", "RLE stream decompress", dran)
    report(f"  one-shot decode of an RLE stream, {len(blob)} bytes to "
           f"{len(runs)} ({len(runs) / len(blob):.1f}x): whole, launches "
           f"{dran} [{card}]")
    report(f"phase 3: one-shots done ({time.perf_counter() - t0:.1f} s)")

    dflag = [] if dev.type == "cuda" else ["--device", "cpu"]

    def run(argv, stdin: bytes = b""):
        """main(argv) with ``stdin`` as its standard input; its standard
        output's bytes."""
        saved = sys.stdin, sys.stdout
        out = io.BytesIO()
        sys.stdin = io.TextIOWrapper(io.BytesIO(stdin))
        sys.stdout = io.TextIOWrapper(out)
        try:
            rc = cli([str(a) for a in argv] + dflag)
            got = out.getvalue()
        finally:
            sys.stdin, sys.stdout = saved
        if rc != 0:
            fail(f"cli {argv}: exit code {rc}")
        return got

    t0 = time.perf_counter()
    piece = data[: 1 << 20]
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        src, back = tmp / "corpus", tmp / "back"
        src.write_bytes(data)
        short = tmp / "short.dict"
        short.write_bytes(data[-100:])
        custom = tt.initialize_dictionary(1024)
        custom[-100:] = data[-100:]
        with_dict = tt.compress(piece, dictionary=custom, device=dev)
        outs = {n: tmp / f"{n}.out" for n in ("raw", "v1", "opt", "opt1")}
        legs = (
            ("compress, file to file",
             ["compress", src, "-o", outs["raw"]], b"",
             lambda r: outs["raw"].read_bytes() == streams["extended"]),
            ("decompress a raw stream, file to file",
             ["decompress", outs["raw"], "-o", back], b"",
             lambda r: back.read_bytes() == data),
            ("compress --sharded, stdin to stdout",
             ["compress", "--sharded"], data,
             lambda r: r == blobs["greedy"]),
            ("decompress a container, stdin to stdout", ["decompress"],
             blobs["greedy"], lambda r: r == data),
            ("compress --sharded --no-extended, file to file",
             ["compress", src, "-o", outs["v1"], "--sharded",
              "--no-extended"], b"",
             lambda r: outs["v1"].read_bytes() == blobs["v1"]),
            ("decompress a container, file to file",
             ["decompress", outs["v1"], "-o", back], b"",
             lambda r: back.read_bytes() == data),
            ("compress --optimal --sharded, file to file",
             ["compress", src, "-o", outs["opt"], "--optimal", "--sharded"],
             b"", lambda r: outs["opt"].read_bytes() == blobs["optimal"]),
            ("compress --optimal, file to file",
             ["compress", src, "-o", outs["opt1"], "--optimal"], b"",
             lambda r: outs["opt1"].read_bytes() == streams["optimal"]),
            ("compress -d (100 bytes), 1 MiB piece, stdin to stdout",
             ["compress", "-d", short], piece, lambda r: r == with_dict),
            ("decompress -d, stdin to stdout", ["decompress", "-d", short],
             with_dict, lambda r: r == piece),
        )
        for leg, argv, stdin, check in legs:
            t = time.perf_counter()
            got, ran = counted(lambda: run(argv, stdin))
            secs = time.perf_counter() - t
            if not check(got):
                fail(f"cli, {leg}: the output differs from the API's")
            note("cli_launches", leg, ran)
            report(f"  cli, {leg}: equal to the API's in {secs:.2f} s; "
                   f"launches {ran} [{card}]")
        report(f"phase 3: the CLI done ({time.perf_counter() - t0:.1f} s)")

        samples = dict_corpus(DICT_SAMPLES)
        corpus_f, dict_f = tmp / "records", tmp / "records.dict"
        corpus_f.write_bytes(b"\n".join(samples))
        t = time.perf_counter()
        _, ran = counted(lambda: run(
            ["build-dictionary", corpus_f, "--delimiter", "\n", "-o",
             dict_f, "--auto-trim"]))
        secs = time.perf_counter() - t
        thresholds = 6  # dictbuild.find_best_trim_threshold's sweep
        if ran.get("v1_tables") != thresholds or \
                ran.get("greedy_predict_batch") != thresholds:
            fail(f"build-dictionary: launches {ran}, not B5 and B7 once a "
                 f"threshold ({thresholds})")
        note("cli_launches", "build-dictionary --auto-trim", ran)
        built = dict_f.read_bytes()
        sizes = {name: evaluate_dictionary_tradeoff(samples, d, device=dev)
                 for name, d in (("built", built), ("default", bytes(
                     tt.initialize_dictionary(1024))))}
        if len(built) != 1024 or not sizes["built"] < sizes["default"]:
            fail(f"build-dictionary: {len(built)} bytes, corpus totals "
                 f"{sizes}")
        few = samples[:64]
        if evaluate_dictionary_tradeoff(few, built, device=dev) != \
                evaluate_dictionary_tradeoff(few, built, device="cpu"):
            fail("build-dictionary: the card's totals differ from the plain "
                 "versions'")
        report(f"  cli, build-dictionary --auto-trim of {len(samples)} "
               f"records ({len(b''.join(samples))} bytes): {secs:.2f} s, "
               f"launches {ran}; the corpus in {sizes['built']} bytes with "
               f"it, {sizes['default']} with the default [{card}]")
    return extra


def chunked_write(c, data: bytes, chunks=STREAM_CHUNKS) -> None:
    """Write ``data`` to the stream ``c`` in ``chunks`` ((size, up to which
    share of ``data``) pairs), with a flush (FLUSH token) before the last
    size's writes where there are several."""
    at = 0
    for size, upto in chunks:
        end = int(len(data) * upto)
        if len(chunks) > 1 and (size, upto) == chunks[-1]:
            c.flush()
        for i in range(at, end, size):
            c.write(data[i : min(i + size, end)])
        at = end


def phase_api_rest(dev, report, data, blobs, card: str):
    """Phase 3, the rest of the JAX package's API on the card (see the
    module docstring): the JAX engine names of ``compress_sharded`` and
    its default, ``decompress_sharded`` and the streaming codec of
    ``tamp_tpu_torch.open``.  Returns the launch counts by wrapper name
    (``api_rest_launches``)."""
    import io
    import struct

    import tamp_tpu_torch as tt
    from tamp_tpu_torch.parallel.shard import (
        _pack_frame, compress_sharded, decompress_sharded,
        decompress_sharded_device,
    )
    from tamp_tpu_torch.stream import NativeCompressor, NativeDecompressor

    fns = counters()
    extra: dict[str, dict] = {}

    def counted(fn):
        for f in fns.values():
            f.launches = 0
        sync(dev)
        t = time.perf_counter()
        out = fn()
        sync(dev)
        return out, {k: f.launches for k, f in fns.items() if f.launches}, \
            (time.perf_counter() - t) * 1e3

    def note(leg: str, ran: dict):
        for k, n in ran.items():
            extra.setdefault(k, {}).setdefault("api_rest_launches", {})[
                leg] = n

    for engine, path, kernels in API_ENGINES:
        kw = {} if engine is None else {"engine": engine}
        blob, ran, ms = counted(lambda: compress_sharded(data, device=dev,
                                                         **kw))
        name = f"engine {engine}" if engine else "no engine (the default)"
        missing = [k for k in kernels if not ran.get(k)]
        if blob != blobs[path] or missing:
            fail(f"compress_sharded, {name}: container equal to {path}'s "
                 f"{blob == blobs[path]}, kernels {missing} not launched")
        note(f"compress_sharded {name}", ran)
        report(f"  compress_sharded, {name}: equal to phase 3's "
               f"{path} container, {len(data) / ms / 1e3:.2f} MB/s "
               f"({ms:.1f} ms, one call); launches {ran} [{card}]")

    main = blobs["extended"]
    back, ran, _ms = counted(lambda: decompress_sharded(main, device=dev))
    if back != data or ran != {"serial_decode": 1}:
        fail(f"decompress_sharded: the corpus back {back == data}, launches "
             f"{ran} (X2 once)")
    note("decompress_sharded", ran)
    ms, _peak, _ = median_ms(dev, lambda: decompress_sharded(main,
                                                             device=dev))
    sms, _peak, _ = median_ms(dev, lambda: decompress_sharded_device(
        main, algorithm="serial", device=dev))
    report(f"  decompress_sharded of the main path's container: the corpus "
           f"back, X2 once, {len(data) / ms / 1e3:.2f} MB/s ({ms:.1f} ms, "
           f"median of {ONE_SHOT_REPS}); decompress_sharded_device serial "
           f"{len(data) / sms / 1e3:.2f} MB/s ({sms:.1f} ms) [{card}]")
    raw = corpus(C2_BYTES, seed=2)
    stream = tt.compress(raw, device=dev)
    v1 = (b"TTPU" + struct.pack("<BBIQI", 1, 0, 1, len(raw), len(stream))
          + stream)
    back, ran, ms = counted(lambda: decompress_sharded(v1, device=dev))
    if back != raw:
        fail("decompress_sharded: the v1 frame of one shard past 1 MiB did "
             "not decode whole")
    note("decompress_sharded v1 frame", ran)
    report(f"  decompress_sharded of a v1 frame, one shard of {len(raw)} "
           f"bytes: whole in {ms:.1f} ms; launches {ran} [{card}]")
    try:
        decompress_sharded(_pack_frame([oob_stream()], 4096, 4096),
                           device=dev)
    except tt.OutOfBoundsError as e:
        report(f"  decompress_sharded of a stream reading past the window: "
               f"OutOfBoundsError ({e})")
    else:
        fail("decompress_sharded: a stream reading past the window was "
             "not refused")

    def write(impl, piece, chunks=STREAM_CHUNKS):
        """(the stream, median seconds of ONE_SHOT_REPS writes of it)."""
        secs = []
        for _ in range(ONE_SHOT_REPS):
            buf = io.BytesIO()
            t = time.perf_counter()
            with tt.open(buf, "wb", implementation=impl) as c:
                chunked_write(c, piece, chunks)
            secs.append(time.perf_counter() - t)
        return buf.getvalue(), statistics.median(secs)

    small = data[:PY_STREAM_BYTES]
    py, py_s = write("python", small)
    if write("native", small)[0] != py:
        fail("open: the C++ and the Python streams differ on "
             f"{len(small)} bytes")
    big = data[:NATIVE_STREAM_BYTES]
    nat, nat_s = write("native", big)
    for impl, blob, piece in (("python", py, small), ("native", nat, big),
                              ("native", py, small)):
        t = time.perf_counter()
        back = tt.open(io.BytesIO(blob), "rb", implementation=impl).read()
        secs = time.perf_counter() - t
        if back != piece:
            fail(f"open: the {impl} decoder did not read a stream back")
        report(f"  open, {impl} decode of {len(piece)} bytes: "
               f"{len(piece) / secs / 1e6:.2f} MB/s (host)")
    back, ran, _ms = counted(lambda: tt.decompress(nat, device=dev))
    if back != big:
        fail("open: the card's X2 did not decode the C++ stream")
    note("decompress of the C++ stream", ran)
    report(f"  open, chunked writes (1, 7 and 4096 bytes, a flush between): "
           f"Python stream of {len(small)} bytes {len(small) / py_s / 1e6:.2f}"
           f" MB/s, C++ stream of {len(big)} bytes "
           f"{len(big) / nat_s / 1e6:.2f} MB/s (host, medians of "
           f"{ONE_SHOT_REPS}); equal on "
           f"{len(small)} bytes, decoded back by both and by X2 (launches "
           f"{ran}) [{card}]")
    whole, whole_s = write("native", data, chunks=WHOLE_CHUNKS)
    card_stream, ran, ms = counted(lambda: tt.compress(data, device=dev))
    if whole != card_stream:
        fail("open: the C++ stream of the corpus differs from "
             "tamp_tpu_torch.compress's stream from the card")
    note("compress (the card's stream)", ran)
    report(f"  open, C++ stream of the {len(data)}-byte corpus (4096-byte "
           f"writes): {len(data) / whole_s / 1e6:.2f} MB/s (host, median of "
           f"{ONE_SHOT_REPS}), equal to "
           f"tamp_tpu_torch.compress's from the card ({ms:.1f} ms) [{card}]")

    buf, calls = io.BytesIO(), [0]

    def aborter(_bi, _bo):
        calls[0] += 1
        return calls[0] == 2

    c = NativeCompressor(buf)
    c.set_progress_callback(aborter)
    try:
        c.write(big)
        fail("open: the callback's abort did not stop the write")
    except tt.AbortedError:
        pass
    c.write(b"")  # resume: the rest of the input is held
    c.close()
    d = NativeDecompressor(buf.getvalue())
    d.set_progress_callback(lambda _bi, _bo: True)
    got = bytearray(len(big))
    try:
        d.readinto(got)
        fail("open: the callback's abort did not stop the read")
    except tt.AbortedError:
        pass
    d.set_progress_callback(None)
    rest = d.read()
    k = len(big) - len(rest)
    if buf.getvalue() != write("native", big, chunks=WHOLE_CHUNKS)[0] or \
            bytes(got[:k]) + bytes(rest) != big or not 0 < k < len(big):
        fail("open: an aborted stream did not resume to the same bytes")
    report(f"  open, abort from a progress callback: the C++ stream of "
           f"{len(big)} bytes resumed to the same bytes; the decoder stopped "
           f"after {k} bytes and resumed to the rest")
    return extra


def phase_bench(dev, report, card: str):
    """Phase 3, the port's bench in this process (see the module
    docstring): bench_torch at BENCH_ARGV and ``measure(1.0, 2)``.
    Returns the bench's launch counts by wrapper name
    (``bench_launches``, by leg)."""
    import bench_torch
    from tools.torch_commit_kernel_bench import measure

    t = time.perf_counter()
    line = bench_torch.run(bench_torch.parse_args(
        [*BENCH_ARGV, "--device", dev.type]), report)
    missing = [k for k in BENCH_KEYS if k not in line]
    rates = {k: v for k, v in line.items()
             if k == "value" or k.endswith(("_mb_s", "_ms_mb", "_ms"))}
    low = [k for k, v in rates.items() if not v > 0]
    flags = [k for k in ("greedy_byte_equal_reference",
                         "optimal_byte_equal_host_dp") if line.get(k) != 1]
    if missing or low or flags:
        fail(f"bench_torch: keys missing {missing}, rates not positive "
             f"{low}, byte-equal flags not 1 {flags}")
    report(json.dumps(line))
    report(f"  bench_torch: {len(line)} keys, {len(rates)} rates positive, "
           f"the greedy and optimal v1 containers equal to their host "
           f"references, in {time.perf_counter() - t:.1f} s [{card}]")
    t = time.perf_counter()
    r = measure(1.0, 2, device=dev)
    if not (r["decode_commit_ms_per_mb"] > 0
            and r["encode_commit_ms_per_mb"] > 0):
        fail(f"measure(1.0, 2): {r}")
    report(f"  measure(1.0, 2): {json.dumps(r)} in "
           f"{time.perf_counter() - t:.1f} s [{card}]")
    extra: dict[str, dict] = {}
    for leg, ran in line["launches"].items():
        for k, n in ran.items():
            extra.setdefault(k, {}).setdefault("bench_launches", {})[leg] = n
    return extra


def dist_child(rank: int, addr: str, out_dir: str) -> int:
    """Rank ``rank`` of ``phase_distributed``'s two-process world: join
    over ``addr``, time ``compress_distributed`` for each engine of
    DIST_ENGINES on the corpus (a warm-up, then 3 runs, each between two
    barriers: host all_reduces, gloo), and on rank 0 write the containers
    and the times to ``out_dir``."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from tamp_tpu_torch.parallel.distributed import (
        compress_distributed, initialize,
    )
    from tamp_tpu_torch.parallel.shard import DEFAULT_SHARD_SIZE

    initialize(addr, 2, rank)
    data = corpus(8 * DEFAULT_SHARD_SIZE)
    barrier = torch.zeros(1)  # a host tensor: the gloo backend
    times = {}
    for engine in DIST_ENGINES:
        ts = []
        for _ in range(4):
            dist.all_reduce(barrier)
            t = time.perf_counter()
            blob = compress_distributed(data, engine=engine)
            dist.all_reduce(barrier)
            ts.append((time.perf_counter() - t) * 1e3)
        times[engine] = ts[1:]
        if rank == 0:
            Path(out_dir, f"{engine}.ttpu").write_bytes(blob)
        elif blob is not None:
            fail(f"compress_distributed returned a container on rank {rank}")
    if rank == 0:
        Path(out_dir, "times.json").write_text(json.dumps(times))
    dist.destroy_process_group()
    return 0


def phase_breakdown(dev, report, data, blob, shard_size: int, card: str,
                    lazy: bool = False):
    """Where an extended encode's time goes (the main path's, or with
    ``lazy`` the extended lazy one's, kernel B2 in place of B1), and for the
    main path one decode's: each stage, host clock around work that ends in
    a synchronize, median of 3 after a warm-up; the encode's framed streams
    equal to the round trip's container (``blob``).  The host half runs in
    the port's C++ (engine/greedy.host_ext_prep a thread a shard,
    host_ext_tail_bits one shard after another); beside it, timed and held
    equal to it, its plain versions one shard after another:
    engine/plan.ext_prep (the same (plans, khat, dh, rc), element for
    element) and engine/tail.ext_tail_bits with the 16 table rows a shard
    it pulls from the card (the same tail bytes)."""
    import numpy as np
    import torch

    from tamp_tpu_torch.constants import compute_min_pattern_size
    from tamp_tpu_torch.dictionary import dictionary_array
    from tamp_tpu_torch.engine.pipeline import pull_body_bytes
    from tamp_tpu_torch.engine.pipeline_ext import (
        encode_ext_device_commit, ext_fields, ext_tails, prepare_batch,
        resume_position,
    )
    from tamp_tpu_torch.engine.plan import ext_prep
    from tamp_tpu_torch.engine.tail import TAIL_ROWS, ext_tail_bits
    from tamp_tpu_torch.ops import decode_commit as dc
    from tamp_tpu_torch.ops import decode_wavefront as dw
    from tamp_tpu_torch.ops.encode_commit import (
        S_ACC, S_AN, S_T, commit_fields,
    )
    from tamp_tpu_torch.ops.match_ext import ext_tables, ext_tables_probe
    from tamp_tpu_torch.parallel.shard import _pack_frame, _parse_frame

    window, literal = 10, 8
    W = 1 << window
    lext = compute_min_pattern_size(window, literal) + 131
    shards = [np.frombuffer(data[i : i + shard_size], np.uint8)
              for i in range(0, len(data), shard_size)]
    stages: dict[str, list[float]] = {}
    pre, kern = ("lazy enc", "B2") if lazy else ("enc", "B1")
    tables = f"{pre} " + ("B2 ext_tables_probe alone" if lazy
                          else "B1 ext_tables alone")
    fields = (f"{pre} planned fields ({kern} + region planes + field "
              "planner)")
    stage_names = [f"{pre} host prep (plan, model, chunk counts; C++, a "
                   "thread a shard)",
                   f"{pre} host->device", fields, f"{pre} B3 commit_fields",
                   f"{pre} device->host (state rows, body bytes)",
                   f"{pre} tail walks (C++, one shard after another)"]
    plain_prep = (f"{pre} plain host prep (NumPy engine/plan.ext_prep, one "
                  "shard after another)")
    plain_tail = (f"{pre} plain tail walks (16-row pull + Python "
                  "engine/tail.ext_tail_bits, one shard after another)")
    whole = f"{pre} whole call (prep .. tail, for the rest)"
    dict_np = dictionary_array(W, literal)

    def python_tails(prep, state, tabs, npos_d, NP):
        base = torch.clamp_min(npos_d - TAIL_ROWS, 0)
        ridx = torch.clamp_max(
            base[:, None] + torch.arange(TAIL_ROWS, device=dev)[None, :],
            NP - 1).long()
        rows = torch.stack([torch.gather(t, 1, ridx)
                            for t in tabs]).cpu().numpy()
        base = base.cpu().numpy()
        out = []
        for i, x in enumerate(shards):
            plans, khat, dhi, _rc = prep[i]
            st = state[i]
            t_in = resume_position(khat, int(st[S_T]), dhi.shape[0])
            out.append(ext_tail_bits(
                x, t_in, dhi, khat, plans, tuple(rows[:, i]), int(base[i]),
                window=window, literal=literal, acc=int(st[S_ACC]),
                an=int(st[S_AN]), dict_last=int(dict_np[-1])))
        return out

    timed = timed_stages(dev, stages)

    for _ in range(4):
        prep, dh, rc, npos = timed(
            stage_names[0], lambda: prepare_batch(shards, window=window))
        ref = timed(plain_prep, lambda: [ext_prep(x, window) for x in shards])
        for i, (got, want) in enumerate(zip(prep, ref)):
            if not all(g.dtype == w.dtype and np.array_equal(g, w)
                       for g, w in zip(got, want)):
                fail(f"{pre}: host_ext_prep differs from plan.ext_prep on "
                     f"shard {i}")
        dh_d, rc_d, npos_d, dict_d = timed(stage_names[1], lambda: (
            torch.from_numpy(dh).to(dev), torch.from_numpy(rc).to(dev),
            torch.from_numpy(npos).to(dev),
            torch.from_numpy(dict_np).to(dev)))
        timed(tables, lambda: (ext_tables_probe if lazy else ext_tables)(
            dh_d, npos_d, dict_d, window_bits=window, LEXT=lext))
        tabs, A, B = timed(fields, lambda: ext_fields(
            dh_d, rc_d, npos_d, dict_d, window=window, literal=literal,
            lazy=lazy))
        NP = dh.shape[1]
        out, state = timed(stage_names[3], lambda: commit_fields(
            A, B, npos_d, max_out=NP + NP // 8 + 64, idx_bits=0))
        del A, B
        state, _bodies = timed(stage_names[4], lambda: (
            state.cpu().numpy(), pull_body_bytes(out, state)))
        tails = timed(stage_names[5], lambda: ext_tails(
            shards, prep, state, window=window, literal=literal, lazy=lazy,
            dict_arr=dict_np))
        ref = timed(plain_tail, lambda: python_tails(prep, state, tabs,
                                                     npos_d, NP))
        if tails != ref:
            bad = [i for i, (a, b) in enumerate(zip(tails, ref)) if a != b]
            fail(f"{pre}: host_ext_tail_bits differs from tail.ext_tail_bits"
                 f" on shards {bad}")
        del out, tabs
        streams = timed(whole, lambda: encode_ext_device_commit(
            shards, window=window, literal=literal, lazy_matching=lazy,
            device=dev))
        framed = timed(f"{pre} frame", lambda: _pack_frame(
            streams, len(data), shard_size))
        if lazy:
            continue

        _raw, _ss, pieces = _parse_frame(blob)
        payloads = timed("dec host frame", lambda: [p[1:] for p in pieces])
        pk = timed(
            "dec payload plane + host->device + per-bit parse (X5, B4's "
            "words)",
            lambda: dw.payload_parse(payloads, window=window,
                                     literal=literal, extended=True,
                                     device=dev, fused=True))
        di = torch.from_numpy(dictionary_array(W, literal)).to(dev)
        out, lens, _e = timed("dec B4 commit_decode", lambda: dc._launch(
            pk, di, di, W=W, more=False,
            max_out=dw._pow2_bucket(shard_size, 1024))[:3])
        timed("dec device->host", lambda: out[:, : int(lens.max())].cpu())
        del pk, out
    if framed != blob:
        fail(f"{pre}: the staged encode differs from the round trip's")
    med = {k: statistics.median(v[1:]) for k, v in stages.items()}
    for name, ms in med.items():
        report(f"  {name}: {ms:.2f} ms [{card}]")
    report(f"  {pre} region planes + field planner (fields - {kern}): "
           f"{med[fields] - med[tables]:.2f} ms [{card}]")
    report(f"  {pre} host prep, plain / C++: "
           f"{med[plain_prep] / med[stage_names[0]]:.2f}x; tail walks, "
           f"plain / C++: {med[plain_tail] / med[stage_names[5]]:.2f}x "
           f"[{card}]")
    report(f"  {pre} rest of the whole call (whole - prep - h2d - fields - "
           f"B3 - d2h - tails): "
           f"{med[whole] - sum(med[n] for n in stage_names):.2f} ms [{card}]")


def phase_v1_split(dev, report, data, blob, shard_size: int, card: str,
                   lazy: bool):
    """Phase 3, the v1 and v1 lazy encodes: where one encode's time goes,
    through the entry point's own stage functions (engine/pipeline.py,
    ops/encode_fused.py), host clock around work that ends in a
    synchronize, median of 3 after a warm-up: B5 alone, the fused device
    call (B5, the pack and the commit, B3 or B6), the host ring tail and the
    frame; the staged container equal to the round trip's (``blob``)."""
    import numpy as np
    import torch

    from tamp_tpu_torch.engine.encode import model_history
    from tamp_tpu_torch.engine.pipeline import (
        finish_streams, pad_shards, pull_body_bytes,
    )
    from tamp_tpu_torch.ops.encode_fused import encode_v1_fused, v1_cap
    from tamp_tpu_torch.ops.match_v1 import v1_tables
    from tamp_tpu_torch.parallel.shard import _pack_frame

    name = "v1 lazy" if lazy else "v1"
    window, literal = 10, 8
    datas = [np.frombuffer(data[i : i + shard_size], np.uint8)
             for i in range(0, len(data), shard_size)]
    stages: dict[str, list[float]] = {}
    timed = timed_stages(dev, stages)

    b5 = "B5 v1_tables" + (" with the probe" if lazy else "")
    fused = "fused device call (B5, pack, " + ("B6)" if lazy else
                                               "planner, B3)")
    for _ in range(4):
        hist, (batch, npos) = timed("host prep (model histories, pad)",
                                    lambda: (
            [model_history(x, window, literal, False, None)[1]
             for x in datas], pad_shards(datas)))
        batch_d, npos_d, dict_d = timed("host->device", lambda: (
            torch.from_numpy(batch).to(dev), torch.from_numpy(npos).to(dev),
            torch.from_numpy(hist[0][: 1 << window].copy()).to(dev)))
        NP = batch.shape[1]
        timed(b5, lambda: v1_tables(batch_d, npos_d, dict_d,
                                    window_bits=window,
                                    cap=v1_cap(window, literal), probe=lazy))
        out, state = timed(fused, lambda: encode_v1_fused(
            batch_d, npos_d, dict_d, window=window, literal=literal,
            lazy=lazy, max_out=NP + NP // 8 + 64))
        state = timed("device->host state rows", lambda: state.cpu().numpy())
        bodies = timed("device->host body bytes",
                       lambda: pull_body_bytes(out, state))
        blobs = timed("host ring tail", lambda: finish_streams(
            datas, hist, state, bodies, window=window, literal=literal,
            lazy_matching=lazy, custom=False))
        framed = timed("frame", lambda: _pack_frame(blobs, len(data),
                                                    shard_size))
        del out, batch_d
    if framed != blob:
        fail(f"{name}: the staged encode differs from the round trip's")
    med = {k: statistics.median(v[1:]) for k, v in stages.items()}
    for stage, ms in med.items():
        report(f"  {name} encode {stage}: {ms:.2f} ms [{card}]")
    report(f"  {name} encode rest of the fused call (fused - B5): "
           f"{med[fused] - med[b5]:.2f} ms [{card}]")


def phase_optimal(dev, report, data, blobs, ratios, shard_size: int,
                  card: str):
    """Phase 3, the optimal encodes: the v1 optimal container no larger
    than the v1 and v1 lazy device-commit ones (minimum bits over their
    token family), the extended one's ratio beside extended lazy (other
    token families: not checked); where each encode's time goes, through
    the entry points' own stage functions (engine/pipeline.py,
    engine/pipeline_ext.py; host clock around work that ends in a
    synchronize, median of 3 after a warm-up), the staged containers
    equal to the round trips'; and each encode's device idle share."""
    import numpy as np
    import torch

    from tamp_tpu_torch.engine.encode import model_history
    from tamp_tpu_torch.engine.pipeline import (
        optimal_fields_v1, optimal_streams_v1, pad_shards, pull_body_bytes,
    )
    from tamp_tpu_torch.engine.pipeline_ext import (
        optimal_batch, optimal_emit, optimal_prep,
    )
    from tamp_tpu_torch.ops.encode_commit import commit_fields
    from tamp_tpu_torch.ops.encode_fused import v1_cap
    from tamp_tpu_torch.ops.match_v1 import v1_tables
    from tamp_tpu_torch.ops.opt_parse import opt_v1_choice
    from tamp_tpu_torch.ops.opt_parse_ext import opt_ext_choice
    from tamp_tpu_torch.parallel.shard import _pack_frame, compress_sharded

    opt = len(blobs["optimal v1"])
    if opt > len(blobs["v1"]) or opt > len(blobs["v1 lazy"]):
        fail(f"optimal v1: container of {opt} bytes is larger than v1's "
             f"({len(blobs['v1'])}) or v1 lazy's ({len(blobs['v1 lazy'])})")
    report(f"  optimal v1: ratio {ratios['optimal v1']:.6f} beside v1 "
           f"{ratios['v1']:.6f} and v1 lazy {ratios['v1 lazy']:.6f}")
    report(f"  optimal: ratio {ratios['optimal']:.6f} beside extended lazy "
           f"{ratios['extended lazy']:.6f} and extended "
           f"{ratios['extended']:.6f} (other token families, not checked)")

    window, literal = 10, 8
    datas = [np.frombuffer(data[i : i + shard_size], np.uint8)
             for i in range(0, len(data), shard_size)]
    kw = dict(window=window, literal=literal)

    def split(name, steps):
        stages: dict[str, list[float]] = {}
        for _ in range(4):
            vals = {}
            for stage, fn in steps:
                sync(dev)
                t = time.perf_counter()
                vals[stage] = fn(vals)
                sync(dev)
                stages.setdefault(stage, []).append(
                    (time.perf_counter() - t) * 1e3)
        if vals["frame"] != blobs[name]:
            fail(f"{name}: the staged encode differs from the round trip's")
        total = 0.0
        for stage, times in stages.items():
            ms = statistics.median(times[1:])
            total += ms
            report(f"  {name} encode {stage}: {ms:.2f} ms [{card}]")
        report(f"  {name} encode, sum of the stages: {total:.2f} ms [{card}]")

    def v1_d2h(v):
        out, state, bad = v["B3 commit_fields (to npos + 15)"]
        if bad.any():
            fail("optimal v1: a shard of the corpus cannot be coded")
        st = state.cpu().numpy()
        return st, pull_body_bytes(out, st)

    split("optimal v1", (
        ("host prep (pad, window)", lambda v: (
            pad_shards(datas),
            model_history(datas[0][:0], window, literal, False, None)[0])),
        ("host->device", lambda v: on_device(dev, (
            *v["host prep (pad, window)"][0],
            v["host prep (pad, window)"][1].copy()))),
        ("B5 v1_tables", lambda v: v1_tables(
            *v["host->device"], window_bits=window,
            cap=v1_cap(window, literal))),
        ("X3 opt_v1_choice", lambda v: opt_v1_choice(
            v["B5 v1_tables"][0], *v["host->device"][:2], **kw)),
        ("fields", lambda v: optimal_fields_v1(
            v["X3 opt_v1_choice"][0], v["B5 v1_tables"][1],
            *v["host->device"][:2], **kw)),
        ("B3 commit_fields (to npos + 15)", lambda v: (*commit_fields(
            *v["fields"], v["host->device"][1] + 15,
            max_out=shard_size + shard_size // 8 + 64),
            v["X3 opt_v1_choice"][2])),
        ("device->host state rows, bad flags and body bytes", v1_d2h),
        ("frame", lambda v: _pack_frame(optimal_streams_v1(
            v["device->host state rows, bad flags and body bytes"][1],
            v["device->host state rows, bad flags and body bytes"][0], **kw,
            custom=False), len(data), shard_size)),
    ))

    def ext_d2h(v):
        choice, _cost0, bad = v["X4 opt_ext_choice"]
        if bad.any():
            fail("optimal: a shard of the corpus cannot be coded")
        return choice.cpu().numpy()

    split("optimal", (
        ("host runs + tables (a thread a shard)",
         lambda v: optimal_prep(datas, **kw)),
        ("host planes (pad, sideband)", lambda v: optimal_batch(
            datas, v["host runs + tables (a thread a shard)"],
            literal=literal)),
        ("host->device", lambda v: on_device(
            dev, v["host planes (pad, sideband)"])),
        ("X4 opt_ext_choice", lambda v: opt_ext_choice(
            *v["host->device"], **kw)),
        ("device->host choice plane", ext_d2h),
        ("walk + emit (a thread a shard)", lambda v: optimal_emit(
            datas, v["host runs + tables (a thread a shard)"],
            v["device->host choice plane"], **kw, custom_dict=False)),
        ("frame", lambda v: _pack_frame(
            v["walk + emit (a thread a shard)"], len(data), shard_size)),
    ))
    for name, ext in (("optimal v1", False), ("optimal", True)):
        idle_share(report, f"{name} encode", lambda: compress_sharded(
            data, shard_size=shard_size, engine="device-optimal",
            extended=ext), card)


def phase_greedy(dev, report, data, blob, shard_size: int, card: str,
                 lazy: bool):
    """Phase 3, a greedy path: its container (``blob``) equal to the
    table-less committer's on the same shards; where the encode's time goes
    (the entry point's own stages of engine/pipeline_ext.py, host clock
    around work that ends in a synchronize, median of 3 after a warm-up);
    the whole call in both pulls; and the rate of the table-less committer
    in threads, the host-only yardstick."""
    import numpy as np
    import torch

    from tamp_tpu_torch.dictionary import dictionary_array
    from tamp_tpu_torch.engine import pipeline_ext as pe
    from tamp_tpu_torch.engine.pipeline import pad_shards
    from tamp_tpu_torch.ops.greedy_predict import greedy_predict_batch
    from tamp_tpu_torch.parallel.shard import _pack_frame

    name = "greedy lazy" if lazy else "greedy"
    window, literal = 10, 8
    pieces = [data[i : i + shard_size]
              for i in range(0, len(data), shard_size)]
    datas = [np.frombuffer(x, np.uint8) for x in pieces]
    stages: dict[str, list[float]] = {}
    timed = timed_stages(dev, stages)

    pulled = 0
    for _ in range(4):
        ref = timed("table-less committer, threaded (host only)",
                    lambda: pe.greedy_commits(datas, lambda i: None,
                                              lazy_matching=lazy))
        dh, npos = timed("host batch (pad shards)",
                         lambda: pad_shards(datas))
        dh_d, npos_d, dict_d = timed("host->device", lambda: (
            torch.from_numpy(dh).to(dev), torch.from_numpy(npos).to(dev),
            torch.from_numpy(dictionary_array(1 << window, literal)).to(dev)))
        tabs = timed("B5 v1_tables cap 16" + (" + probe" if lazy else ""),
                     lambda: pe.greedy_tables(dh_d, npos_d, dict_d,
                                              window=window, lazy=lazy))
        pk, pp = timed("pack_predict_plane (+ probe plane)",
                       lambda: pe.greedy_predict_planes(
                           dh_d, npos_d, tabs, int(dict_d[-1]), lazy=lazy))
        del tabs
        bm, ent, _st = timed("B7 greedy_predict_batch", lambda: (
            greedy_predict_batch(pk, pp, npos_d, NP=dh.shape[1],
                                 window=window, literal=literal, lazy=lazy)))
        bits, ent_h = timed("bitmap and entry pull",
                            lambda: pe.pull_sparse(bm, ent, lazy))
        pulled = bm.numel() * 4 + ent_h.size * 4
        blobs = timed("threaded commits (expand + commit)",
                      lambda: pe.greedy_commits(
                          datas, lambda i: pe.sparse_tables(
                              bits[i], ent_h[i], datas[i].shape[0], lazy),
                          lazy_matching=lazy))
        timed("frame", lambda: _pack_frame(blobs, len(data), shard_size))
        timed("whole encode_ext_device_greedy call, sparse pull",
              lambda: pe.encode_ext_device_greedy(
                  pieces, lazy_matching=lazy, device=dev))
        dense = timed("whole call, dense pull", lambda: (
            pe.encode_ext_device_greedy(pieces, lazy_matching=lazy,
                                        pull="dense", device=dev)))
        del pk, pp, bm, ent
    if blob != _pack_frame(ref, len(data), shard_size):
        fail(f"{name}: the card's container differs from the table-less "
             "committer's")
    if blobs != ref or dense != ref:
        fail(f"{name}: the staged or dense-pull streams differ from the "
             "table-less committer's")
    report(f"  {name}: container equal to the table-less committer's; "
           f"pulled {pulled} bytes ({pulled / len(data):.4f} per input "
           f"byte; dense {2 * (2 if lazy else 1)} per position) [{card}]")
    for stage, ts in stages.items():
        ms = statistics.median(ts[1:])
        rate = (f", {len(data) / ms / 1e3:.2f} MB/s"
                if stage.startswith(("whole", "table-less")) else "")
        report(f"  {name} {stage}: {ms:.2f} ms{rate} [{card}]")


def phase_profile(report, data, blob, shard_size: int, card: str):
    """Device busy and idle share of one encode and one decode, from a
    torch.profiler trace: the device activity (kernels and copies) summed
    over the wall time of the call; the encode also with lazy matching, the
    decode also in mode chase, and the greedy encodes (without and with
    lazy matching)."""
    import os

    from tamp_tpu_torch.parallel.shard import (
        compress_sharded, decompress_sharded_device,
    )

    def chase():
        os.environ["TAMP_TPU_DECODE"] = "chase"
        try:
            return decompress_sharded_device(blob)
        finally:
            del os.environ["TAMP_TPU_DECODE"]

    for name, fn in (
            ("encode", lambda: compress_sharded(
                data, shard_size=shard_size, engine="device-commit")),
            ("extended lazy encode", lambda: compress_sharded(
                data, shard_size=shard_size, lazy_matching=True,
                engine="device-commit")),
            ("decode", lambda: decompress_sharded_device(blob)),
            ("decode (chase)", chase),
            ("greedy encode", lambda: compress_sharded(
                data, shard_size=shard_size, engine="device-greedy")),
            ("greedy lazy encode", lambda: compress_sharded(
                data, shard_size=shard_size, engine="device-greedy",
                lazy_matching=True))):
        idle_share(report, name, fn, card)


def launch_split(fn, parts, reps: int = 5, traces: int = 3):
    """Device ms a call of ``fn`` spends in each of its kernels, from a
    torch.profiler trace of ``reps`` calls after a warm one: ``parts`` maps
    a label to a substring of the kernel's name.  A trace that misses a
    kernel is taken again, up to ``traces`` traces in all, and each miss is
    printed with the device events the trace did hold (one run of the
    script saw X3's trace come back without its kernels).  Returns (ms by
    label, the traces taken, the lag in µs from the trace's first kernel
    launch call to its first kernel start, on the profiler's host and
    device clocks; None where the trace holds no launch call)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for trace in range(1, traces + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        got = {label: 0.0 for label in parts}
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue
            for label, key in parts.items():
                if key in e.key:
                    got[label] += e.self_device_time_total / 1e3 / reps
        events = prof.events()
        starts = [e.time_range.start for e in events
                  if e.device_type == DeviceType.CUDA]
        calls = [e.time_range.start for e in events
                 if e.device_type == DeviceType.CPU
                 and "LaunchKernel" in e.name]
        lag = min(starts) - min(calls) if starts and calls else None
        missing = [parts[label] for label, ms in got.items() if ms <= 0]
        if not missing:
            return got, trace, lag
        print(f"  launch_split: trace {trace} saw no kernel {missing}; it "
              f"held {len(starts)} device events and {len(calls)} launch "
              f"calls, lag {lag} us", flush=True)
    fail(f"the profiler saw no kernel {missing!r} in {traces} traces")


def walk_count(rows, stops, step):
    """Total steps of serial walks over rows: from 0, jump by
    ``step(row[t])`` while t < stop (a jump <= 0 ends the walk)."""
    total = 0
    for r, n in zip(rows, stops):
        t, r = 0, r.tolist()
        while t < n:
            d = step(r[t])
            if d <= 0:
                break
            t += d
            total += 1
    return total


def stream_tokens(dev, blob, window: int, literal: int, extended: bool):
    """The fused parse words of a container's streams on the card and the
    number of tokens in them: (words (S, NBP), tokens)."""
    from tamp_tpu_torch.ops import decode_wavefront as dw
    from tamp_tpu_torch.parallel.shard import _parse_frame

    _raw, _ss, pieces = _parse_frame(blob)
    pk = dw.payload_parse([p[1:] for p in pieces], window=window,
                          literal=literal, extended=extended, device=dev,
                          fused=True)
    # a decode walk reads one parse word per token, jumping by its bits
    tokens = walk_count(pk.cpu().numpy(), [pk.shape[1]] * len(pieces),
                        lambda p: (p >> 11) & 63)
    return pk, tokens


def phase_kernel_times(dev, report, data, blobs, launches, dec_launches,
                       mesh_launches, shard_size: int, card: str):
    """Phase 4: each kernel at its path's shapes against its plain
    version: times, results, bounds.  ``blobs`` and ``launches``: the
    containers and launch counts of phase 3, by path; ``dec_launches``:
    those of its decode modes, by (container, mode); ``mesh_launches``:
    those of the mesh steps, by step (B5's, B4's and X1's rows carry them
    as ``mesh_launches``).  Returns the ``kernels`` records."""
    import numpy as np
    import torch

    from tamp_tpu_torch.constants import compute_min_pattern_size
    from tamp_tpu_torch.dictionary import dictionary_array
    from tamp_tpu_torch.engine.pipeline_ext import ext_fields, prepare_batch
    from tamp_tpu_torch.ops import decode_commit as dc
    from tamp_tpu_torch.ops import decode_serial as dser
    from tamp_tpu_torch.ops import decode_wavefront as dw
    from tamp_tpu_torch.ops.encode_commit import (
        S_NBYTES, commit_fields, commit_fields_plain, commit_v1_lazy,
        commit_v1_lazy_plain,
    )
    from tamp_tpu_torch.ops.token_chase import (
        token_table_chase, token_table_chase_plain,
    )
    from tamp_tpu_torch.parallel.shard import _parse_frame
    from tamp_tpu_torch.ops.encode_fused import v1_cap
    from tamp_tpu_torch.ops.greedy_predict import (
        greedy_predict_batch, greedy_predict_plain,
    )
    from tamp_tpu_torch.ops.match_ext import (
        ext_tables, ext_tables_plain, ext_tables_probe, ext_tables_probe_plain,
    )
    from tamp_tpu_torch.ops.match_v1 import v1_tables, v1_tables_plain
    from tamp_tpu_torch.engine.pipeline_ext import (
        optimal_batch, optimal_prep,
    )
    from tamp_tpu_torch.ops.opt_parse import (
        opt_v1_choice, opt_v1_choice_plain,
    )
    from tamp_tpu_torch.ops.opt_parse_ext import (
        opt_ext_choice, opt_ext_choice_plain,
    )

    window, literal = 10, 8
    W = 1 << window
    lext = compute_min_pattern_size(window, literal) + 131
    shards = [np.frombuffer(data[i : i + shard_size], np.uint8)
              for i in range(0, len(data), shard_size)]
    _prep, dh, rc, npos = prepare_batch(shards, window=window)
    S, NP = dh.shape
    dh_d = torch.from_numpy(dh).to(dev)
    npos_d = torch.from_numpy(npos).to(dev)
    dict_d = torch.from_numpy(dictionary_array(W, literal)).to(dev)
    kernels = []

    # the tables' least work: every position's target (two for B2 and B5
    # with the probe) against its W slots, 32 slots a word operation
    n_dh = int(npos.astype(np.int64).sum())
    slot_words = -(-W // 32)

    # B1: the model bytes in, four int32 planes out
    ms, tabs = cuda_ms(lambda: ext_tables(dh_d, npos_d, dict_d,
                                          window_bits=window, LEXT=lext))
    pms, ptabs = cuda_ms(lambda: ext_tables_plain(
        dh_d, npos_d, dict_d, window_bits=window, LEXT=lext), reps=1)
    kernels.append(dict(
        name="ext_tables (B1)", route="cuda",
        source="tamp_tpu_torch/csrc/match_ext.cu",
        replaces="tamp_tpu/ops/match_ext_pallas.py:343",
        launches=launches["extended"]["ext_tables"],
        max_abs_err=max_abs_err(zip(tabs, ptabs)), ms=ms, plain_ms=pms,
        bytes=S * NP + W + 4 * S + 4 * 4 * S * NP,
        ops=n_dh * slot_words))
    del tabs, ptabs

    # B2: B1's work plus the probe family's target
    ms, tabs = cuda_ms(lambda: ext_tables_probe(
        dh_d, npos_d, dict_d, window_bits=window, LEXT=lext))
    pms, ptabs = cuda_ms(lambda: ext_tables_probe_plain(
        dh_d, npos_d, dict_d, window_bits=window, LEXT=lext), reps=1)
    kernels.append(dict(
        name="ext_tables_probe (B2)", route="cuda",
        source="tamp_tpu_torch/csrc/match_ext.cu",
        replaces="tamp_tpu/ops/match_ext_pallas.py:133",
        launches=launches["extended lazy"]["ext_tables_probe"],
        max_abs_err=max_abs_err(zip(tabs, ptabs)), ms=ms, plain_ms=pms,
        bytes=S * NP + W + 4 * S + 6 * 4 * S * NP,
        ops=2 * n_dh * slot_words))
    del tabs, ptabs

    # B3: the planned fields of this batch (the main path's commit input)
    _tabs, A, B = ext_fields(dh_d, torch.from_numpy(rc).to(dev), npos_d,
                             dict_d, window=window, literal=literal)
    del _tabs
    kw = dict(max_out=NP + NP // 8 + 64, idx_bits=0)
    ms, (out, st) = cuda_ms(lambda: commit_fields(A, B, npos_d, **kw))
    h0 = time.perf_counter()
    pout, pst = commit_fields_plain(A, B, npos_d, **kw)
    pms = (time.perf_counter() - h0) * 1e3
    # the walk reads A and B at its visited positions only
    steps = walk_count(B.cpu().numpy(), np.maximum(npos - 15, 0),
                       lambda m: (m >> 6) & 255)
    kernels.append(dict(
        name="commit_fields (B3)", route="cuda",
        source="tamp_tpu_torch/csrc/encode_commit.cu",
        replaces="tamp_tpu/ops/encode_commit_pallas.py:260",
        launches=launches["extended"]["commit_fields"],
        max_abs_err=max_abs_err([(out, pout), (st, pst)]), ms=ms,
        plain_ms=pms, steps=steps,
        bytes=8 * steps + int(st[:, S_NBYTES].sum()) + 4 * S + 64 * S,
        ops=3 * steps))

    # B4: the parse of the main path's container
    pk, tokens = stream_tokens(dev, blobs["extended"], window, literal, True)
    max_out = dw._pow2_bucket(shard_size, 1024)
    ms, got = cuda_ms(lambda: dc._launch(pk, dict_d, dict_d, W=W, more=False,
                                         max_out=max_out,
                                         min_bits=1 + literal))
    # the four launches counted (each once a wrapper call) and timed in a
    # short child process, whose trace holds every kernel
    split = b4_launches({"B4": dict(pk=pk, d=dict_d, W=W, max_out=max_out,
                                    min_bits=1 + literal)})["B4"]
    report("  B4 launches: " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in split.items())
        + f", sum {sum(split.values()):.4f} ms; each once a call, "
        f"{B4_REPS} calls in a child process [{card}]")
    if int(got[3].sum()) != tokens:
        fail(f"B4's front counted {int(got[3].sum())} tokens, the walk "
             f"{tokens}")
    h0 = time.perf_counter()
    plain = dc.commit_decode_plain(pk, dict_d, dict_d, W=W, more=False,
                                   max_out=max_out)
    pms = (time.perf_counter() - h0) * 1e3
    # the walk reads one parse word per token and writes the output once
    out_bytes = int(got[1].sum())
    kernels.append(dict(
        name="commit_decode (B4)", route="cuda",
        source="tamp_tpu_torch/csrc/decode_commit.cu",
        replaces="tamp_tpu/ops/decode_commit_pallas.py:87",
        launches=launches["extended"]["commit_decode"],
        mesh_launches=mesh_launches["decode commit"]["commit_decode"],
        max_abs_err=max_abs_err(zip(got, plain)), ms=ms, plain_ms=pms,
        steps=tokens,
        bytes=4 * tokens + 2 * W + out_bytes + 8 * S, ops=out_bytes,
        launch_ms=split, launch_sum_ms=sum(split.values())))
    del pk, got, plain

    # B5: the v1 tables of the raw shards (the v1 path: cap 15, no probe)
    raw = np.zeros((S, shard_size), np.uint8)
    for i, x in enumerate(shards):
        raw[i, : x.shape[0]] = x
    nraw = np.asarray([x.shape[0] for x in shards], np.int32)
    raw_d = torch.from_numpy(raw).to(dev)
    nraw_d = torch.from_numpy(nraw).to(dev)
    dict1 = torch.from_numpy(dictionary_array(W, 8)).to(dev)
    kw = dict(window_bits=window, cap=v1_cap(window, literal))
    ms, tabs = cuda_ms(lambda: v1_tables(raw_d, nraw_d, dict1, **kw))
    pms, ptabs = cuda_ms(lambda: v1_tables_plain(raw_d, nraw_d, dict1, **kw),
                         reps=1)
    n_raw = int(nraw.astype(np.int64).sum())
    kernels.append(dict(
        name="v1_tables (B5)", route="cuda",
        source="tamp_tpu_torch/csrc/match_ext.cu",
        replaces="tamp_tpu/ops/match_pallas.py:75",
        launches=launches["v1"]["v1_tables"],
        mesh_launches=mesh_launches["search"]["v1_tables"],
        max_abs_err=max_abs_err(zip(tabs, ptabs)), ms=ms, plain_ms=pms,
        bytes=S * shard_size + W + 4 * S + 2 * 4 * S * shard_size,
        ops=n_raw * slot_words))
    del tabs, ptabs
    # the v1 lazy path's call: the probe family's target as well
    pms, ptabs = cuda_ms(lambda: v1_tables_plain(raw_d, nraw_d, dict1,
                                                 probe=True, **kw), reps=1)
    ms, tabs = cuda_ms(lambda: v1_tables(raw_d, nraw_d, dict1, probe=True,
                                         **kw))
    kernels.append(dict(
        name="v1_tables (B5) with the probe", route="cuda",
        source="tamp_tpu_torch/csrc/match_ext.cu",
        replaces="tamp_tpu/ops/match_pallas.py:75",
        launches=launches["v1 lazy"]["v1_tables"],
        max_abs_err=max_abs_err(zip(tabs, ptabs)), ms=ms, plain_ms=pms,
        bytes=S * shard_size + W + 4 * S + 4 * 4 * S * shard_size,
        ops=2 * n_raw * slot_words))
    del ptabs
    # B5 on engine="device" (extended): cap 16 over the model histories
    # against the extended dictionary, one launch a batch
    kw16 = dict(window_bits=window, cap=16)
    ms, dtabs = cuda_ms(lambda: v1_tables(dh_d, npos_d, dict_d, **kw16))
    pms, ptabs = cuda_ms(lambda: v1_tables_plain(dh_d, npos_d, dict_d,
                                                 **kw16), reps=1)
    kernels.append(dict(
        name="v1_tables (B5) on the model history (engine=device)",
        route="cuda", source="tamp_tpu_torch/csrc/match_ext.cu",
        replaces="tamp_tpu/ops/match_pallas.py:75",
        launches=launches["device"]["v1_tables"],
        max_abs_err=max_abs_err(zip(dtabs, ptabs)), ms=ms, plain_ms=pms,
        bytes=S * NP + W + 4 * S + 2 * 4 * S * NP, ops=n_dh * slot_words))
    del dtabs, ptabs

    # B6: the lazy v1 walk over this batch's packed tables
    flen, fidx, plen, pidx = tabs
    packed = (flen << 23) | (fidx << 8) | raw_d.to(torch.int32)
    probe = (plen << 15) | pidx
    del tabs, flen, fidx, plen, pidx
    kw = dict(window=window, literal=literal,
              max_out=shard_size + shard_size // 8 + 64)
    ms, (out, st) = cuda_ms(lambda: commit_v1_lazy(packed, probe, nraw_d,
                                                   **kw))
    h0 = time.perf_counter()
    pout, pst = commit_v1_lazy_plain(packed, probe, nraw_d, **kw)
    pms = (time.perf_counter() - h0) * 1e3
    # the walk reads P and Q at its visited positions, one per token: the
    # tokens of the v1 lazy container (its < 16-byte host tails included)
    _pk, steps = stream_tokens(dev, blobs["v1 lazy"], window, literal, False)
    kernels.append(dict(
        name="commit_v1_lazy (B6)", route="cuda",
        source="tamp_tpu_torch/csrc/encode_commit.cu",
        replaces="tamp_tpu/ops/encode_commit_pallas.py:61",
        launches=launches["v1 lazy"]["commit_v1_lazy"],
        max_abs_err=max_abs_err([(out, pout), (st, pst)]), ms=ms,
        plain_ms=pms, steps=steps,
        bytes=8 * steps + int(st[:, S_NBYTES].sum()) + 4 * S + 64 * S,
        ops=3 * steps))
    del out, st, pout, pst, packed, probe

    # B7: the greedy path's walk over this batch's packed plane (cap-16
    # tables of the raw shards, the extended dictionary)
    pk, _pp = b7_inputs(raw_d, nraw_d, dict_d, window=window, lazy=False)
    kw = dict(NP=shard_size, window=window, literal=literal, lazy=False)
    ms, got = cuda_ms(lambda: greedy_predict_batch(pk, None, nraw_d, **kw))
    h0 = time.perf_counter()
    plain = greedy_predict_plain(pk, None, nraw_d, **kw)
    pms = (time.perf_counter() - h0) * 1e3
    minp = compute_min_pattern_size(window, literal)

    def b7_adv(p):
        ln, run = (p >> 15) & 31, (p >> 20) & 255
        if run >= 2 and not (run <= 6 and ln > run):
            return min(run, 241)
        return ln if ln >= minp else 1

    # the walk reads one plane word per step; it writes the whole bitmap,
    # one word per entry and the state rows
    steps = walk_count(pk.cpu().numpy(), np.maximum(nraw - 15, 0), b7_adv)
    n_ent = int(plain[2][:, 0].sum())
    report(f"  B7 inputs: {steps} walk steps, {n_ent} entries [{card}]")
    kernels.append(dict(
        name="greedy_predict_batch (B7)", route="cuda",
        source="tamp_tpu_torch/csrc/greedy_predict.cu",
        replaces="tamp_tpu/ops/greedy_predict_pallas.py:62",
        launches=launches["greedy"]["greedy_predict_batch"],
        max_abs_err=b7_err(got, plain), ms=ms, plain_ms=pms, steps=steps,
        bytes=4 * steps + S * shard_size // 8 + 4 * n_ent + 36 * S,
        ops=4 * steps))
    del pk, got, plain
    # the greedy lazy path's call: the probe plane as well
    bm, ent, st, plain = b7_pair(raw_d, nraw_d, dict_d, window=window,
                                 literal=literal, lazy=True)
    pk, pp = b7_inputs(raw_d, nraw_d, dict_d, window=window, lazy=True)
    lms, _got = cuda_ms(lambda: greedy_predict_batch(
        pk, pp, nraw_d, NP=shard_size, window=window, literal=literal,
        lazy=True))
    report(f"  greedy_predict_batch (B7) lazy: {lms:.3f} ms, max_abs_err "
           f"{b7_err((bm, ent, st), plain)}, entries "
           f"{int(st[:, 0].sum())} [{card}]")
    if b7_err((bm, ent, st), plain):
        fail("B7 with lazy matching differs from its plain version")
    del pk, pp, bm, ent, st, plain, _got

    # B8: the chase of the main path's parse
    pieces = _parse_frame(blobs["extended"])[2]
    nxt, packed = dw.payload_parse([p[1:] for p in pieces], window=window,
                                   literal=literal, extended=True, device=dev)
    NBP = nxt.shape[1]
    T_max = NBP // (1 + literal) + 2
    ms, tab = cuda_ms(lambda: token_table_chase(nxt, NBP, T_max))
    nxt_h = nxt.cpu()
    h0 = time.perf_counter()
    ptab = token_table_chase_plain(nxt_h, NBP, T_max)
    pms = (time.perf_counter() - h0) * 1e3
    tokens = int(tab[1].sum())
    # the chase reads one jump word per token and writes one start each
    kernels.append(dict(
        name="token_table_chase (B8)", route="cuda",
        source="tamp_tpu_torch/csrc/decode_wavefront.cu",
        replaces="tamp_tpu/ops/token_chase_pallas.py:51",
        launches=dec_launches["extended", "chase"]["token_table_chase"],
        max_abs_err=max_abs_err(zip(tab, ptab)), ms=ms, plain_ms=pms,
        bytes=8 * tokens + 4 * S, ops=2 * tokens))
    xms, _xtab = cuda_ms(lambda: dw._token_table(nxt, NBP, literal, T_max))
    fms, _fin = cuda_ms(lambda: dw.wavefront_finish(
        *tab, packed, dict_d, dict_d, window=window, more=False,
        max_out=dw._pow2_bucket(shard_size, 1024)))
    report(f"  xla token table (tensor ops, the xla mode's B8 stage): "
           f"{xms:.3f} ms; wavefront_finish (tensor ops and X1, both "
           f"modes): {fms:.3f} ms [{card}]")
    del nxt, nxt_h, ptab, _xtab, _fin

    # X5: the per-bit parse of the main path's payloads, as B4's words and
    # as the pair of the chase and xla modes; the plain version is the
    # tensor ops on the card
    payloads = [p[1:] for p in pieces]
    L = dw._pow2_bucket(max(len(p) for p in payloads) + 1, 64)
    blob_h = np.zeros((len(payloads), L + 16), np.uint8)
    for i, p in enumerate(payloads):
        blob_h[i, : len(p)] = np.frombuffer(p, np.uint8)
    pp_d = torch.from_numpy(blob_h).to(dev)
    nb_d = torch.tensor([len(p) for p in payloads], dtype=torch.int32,
                        device=dev)
    pkw = dict(window=window, literal=literal, extended=True)
    ms, words = cuda_ms(lambda: dw.parse_words(pp_d, nb_d, 8 * L,
                                               fused=True, **pkw))
    pair_ms, pair = cuda_ms(lambda: dw.parse_words(pp_d, nb_d, 8 * L,
                                                   fused=False, **pkw))
    sync(dev)
    h0 = time.perf_counter()
    p_nxt, p_kind, p_cnt, p_idx = dw.speculative_parse(
        pp_d.to(torch.int64), nb_d * 8, 8 * L, window, literal, True)
    p_packed = p_kind | (p_cnt << 3) | (p_idx << 11)
    p_words = dc.fuse_parse(p_nxt, p_packed)
    sync(dev)
    pms = (time.perf_counter() - h0) * 1e3
    bits = len(payloads) * 8 * L
    report(f"  X5 as the pair (nxt, packed): {pair_ms:.4f} ms, bound "
           f"{(blob_h.nbytes + 8 * bits) / HBM_BYTES_PER_S * 1e3:.4f} ms by "
           f"bytes, max_abs_err "
           f"{max_abs_err(zip(pair, (p_nxt, p_packed)))} [{card}]")
    # the blob read once, a word written a bit; at least an operation a bit
    kernels.append(dict(
        name="parse_words (X5)", route="cuda",
        source="tamp_tpu_torch/csrc/decode_parse.cu",
        replaces="tamp_tpu/ops/decode_wavefront.py:135",
        launches=dec_launches["extended", "commit"]["parse_words"],
        max_abs_err=max(max_abs_err([(words, p_words)]),
                        max_abs_err(zip(pair, (p_nxt, p_packed)))),
        ms=ms, plain_ms=pms, bytes=blob_h.nbytes + 4 * bits, ops=bits))
    del pp_d, words, pair, p_nxt, p_kind, p_cnt, p_idx, p_packed, p_words

    # X1: the truncation deficits of the main path's token table
    x1_in = dw.fold_inputs(*tab, packed, more=False)
    ms, defs = cuda_ms(lambda: dw.trunc_deficits(*x1_in, W))
    x1_h = [x.cpu() for x in x1_in]
    h0 = time.perf_counter()
    pdefs = dw.trunc_deficits_plain(*x1_h, W)
    pms = (time.perf_counter() - h0) * 1e3
    n_tr = int(x1_in[3].sum())
    split, n_tr_x1, lag_x1 = launch_split(
        lambda: dw.trunc_deficits(*x1_in, W), {"fold": "trunc_deficits"})
    report(f"  X1 inputs: {n_tr} truncating tokens of {tokens}, "
           f"{int((pdefs != 0).sum())} nonzero deficits; the call "
           f"{ms * 1e6 / max(n_tr, 1):.1f} ns a truncating token, its "
           f"kernel alone {split['fold']:.4f} ms, "
           f"{split['fold'] * 1e6 / max(n_tr, 1):.1f} ns ({n_tr_x1} "
           f"traces, lag {lag_x1} us) [{card}]")
    # the fold reads three words and writes one per truncating token
    kernels.append(dict(
        name="trunc_deficits (X1)", route="cuda",
        source="tamp_tpu_torch/csrc/decode_wavefront.cu",
        replaces="tamp_tpu/ops/decode_wavefront.py:358",
        launches=dec_launches["extended", "chase"]["trunc_deficits"],
        mesh_launches=mesh_launches["decode xla"]["trunc_deficits"],
        max_abs_err=max_abs_err([(defs, pdefs)]), ms=ms, plain_ms=pms,
        bytes=16 * n_tr + 4 * S, ops=6 * n_tr, launch_ms=split,
        launch_traces=n_tr_x1, launch_lag_us=lag_x1))
    del tab, packed, x1_in, x1_h, defs, pdefs

    # X2: the serial decode of the main path's payloads
    Lp = max(len(p) - 1 for p in pieces)
    pl = np.zeros((S, Lp), np.uint8)
    for i, p in enumerate(pieces):
        pl[i, : len(p) - 1] = np.frombuffer(p[1:], np.uint8)
    pl_h = torch.from_numpy(pl)
    nb_h = torch.tensor([len(p) - 1 for p in pieces], dtype=torch.int32)
    pl_d, nb_d = pl_h.to(dev), nb_h.to(dev)
    kw = dict(window=window, literal=literal, extended=True, more=False,
              max_out=shard_size)
    ms, got = cuda_ms(lambda: dser.serial_decode(pl_d, nb_d, dict_d, dict_d,
                                                 **kw))
    h0 = time.perf_counter()
    plain = dser.serial_decode_plain(pl_h, nb_h, dict_d.cpu(), dict_d.cpu(),
                                     **kw)
    pms = (time.perf_counter() - h0) * 1e3
    out_bytes = int(got[1].sum())
    # the payload read once, the output written once
    kernels.append(dict(
        name="serial_decode (X2)", route="cuda",
        source="tamp_tpu_torch/csrc/decode_serial.cu",
        replaces="tamp_tpu/ops/decode_jax.py:77",
        launches=dec_launches["extended", "serial"]["serial_decode"],
        max_abs_err=max_abs_err(zip(got, plain)), ms=ms, plain_ms=pms,
        bytes=int(nb_h.sum()) + 2 * W + out_bytes + 12 * S,
        ops=out_bytes))
    del got, plain

    # X3: the optimal v1 path's DP over B5's tables of the raw shards
    minp = compute_min_pattern_size(window, literal)
    kw = dict(window=window, literal=literal)
    flen = v1_tables(raw_d, nraw_d, dict1, window_bits=window,
                     cap=v1_cap(window, literal))[0]
    ms, got = cuda_ms(lambda: opt_v1_choice(flen, raw_d, nraw_d, **kw))
    pms, plain = cuda_ms(lambda: opt_v1_choice_plain(flen, raw_d, nraw_d,
                                                     **kw), reps=1)
    # the serial DP relaxes, per in-shard position, the literal edge and
    # the match sizes minp..min(flen, minp + 13): an add and a min each
    inside = (torch.arange(shard_size, device=dev)[None, :]
              < nraw_d[:, None])
    n_edges = int(torch.where(inside, 1 + torch.clamp_min(torch.clamp_max(
        flen, minp + 13) - minp + 1, 0), 0).sum())
    report(f"  X3 inputs: {n_edges} edges over {n_raw} positions [{card}]")
    split, n_tr_x3, lag_x3 = launch_split(
        lambda: opt_v1_choice(flen, raw_d, nraw_d, **kw), X3_LAUNCHES)
    report("  X3 launches: " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in split.items())
        + f" ({n_tr_x3} traces, lag {lag_x3} us) [{card}]")
    kernels.append(dict(
        name="opt_v1_choice (X3)", route="cuda",
        source="tamp_tpu_torch/csrc/opt_parse.cu",
        replaces="tamp_tpu/ops/opt_parse.py:66",
        launches=launches["optimal v1"]["opt_v1_choice"],
        max_abs_err=max_abs_err(zip(got, plain)), ms=ms, plain_ms=pms,
        edges=n_edges,
        # flen and data read once, the int32 choice plane written once
        bytes=9 * S * shard_size + 12 * S, ops=2 * n_edges,
        launch_ms=split, launch_traces=n_tr_x3, launch_lag_us=lag_x3))
    del flen, got, plain, inside

    # X4: the optimal path's DP over the host prep of the raw shards
    planes = optimal_batch(shards, optimal_prep(shards, **kw), literal=literal)
    args = on_device(dev, planes)
    ms, got = cuda_ms(lambda: opt_ext_choice(*args, **kw))
    split, n_tr_x4, lag_x4 = launch_split(
        lambda: opt_ext_choice(*args, **kw), X4_LAUNCHES)
    report("  X4 launches: " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in split.items())
        + f" ({n_tr_x4} traces, lag {lag_x4} us) [{card}]")
    pms, plain = cuda_ms(lambda: opt_ext_choice_plain(*args, **kw), reps=1)
    pk = args[0]
    MP, C = pk.shape[1], planes[3].shape[1]
    room = ((pk >> 8) & 0x7FFF) + 1
    hi = torch.minimum(torch.minimum(pk & 0xFF, (pk >> 23) & 0xFF),
                       torch.where(room >= minp + 12, room, minp + 11))
    hi = torch.clamp_max(hi, minp + 131)
    inside = torch.arange(MP, device=dev)[None, :] < args[2][:, None]
    n_edges = int(torch.where(inside, torch.where(
        pk < 0, 1, 1 + torch.clamp_min(hi - minp + 1, 0)), 0).sum())
    report(f"  X4 inputs: {n_edges} edges over {n_raw} positions, "
           f"{int((inside & (pk < 0)).sum())} inside forced-RLE regions, "
           f"{int((planes[3] < MP).sum())} chunks [{card}]")
    kernels.append(dict(
        name="opt_ext_choice (X4)", route="cuda",
        source="tamp_tpu_torch/csrc/opt_parse.cu",
        replaces="tamp_tpu/ops/opt_parse_ext.py:57",
        launches=launches["optimal"]["opt_ext_choice"],
        max_abs_err=max_abs_err(zip(got, plain)), ms=ms, plain_ms=pms,
        edges=n_edges,
        # the packed plane and the sideband read once, the uint8 choice
        # plane written once
        bytes=5 * S * MP + 8 * S * C + 12 * S, ops=2 * n_edges,
        launch_ms=split, launch_traces=n_tr_x4, launch_lag_us=lag_x4))
    del args, got, plain, pk, room, hi, inside

    ops_per_s = int_ops_per_s()  # every kernel's work is integer work
    report(f"  integer peak {ops_per_s / 1e12:.2f} T/s [{card}]")
    for k in kernels:
        t_bytes = k.pop("bytes") / HBM_BYTES_PER_S * 1e3
        t_ops = k.pop("ops") / ops_per_s * 1e3
        k["bound_ms"] = max(t_bytes, t_ops)
        k["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        k["library_ms"] = None  # no single PyTorch call computes these
        k["equal_plain"] = k["max_abs_err"] == 0
        # the walks: steps (tokens for B4), and ns a step of a shard
        steps = (f", {k['steps']} steps, {k['ms'] * 1e6 * S / k['steps']:.1f}"
                 " ns a step a shard" if "steps" in k else "")
        if "edges" in k:
            steps = f", {k['edges']} edges"
        if k["name"] in FIRST_PORT_MS:
            steps += f" (first port: {FIRST_PORT_MS[k['name']]} ms)"
        mesh = (f" (mesh step {k['mesh_launches']})" if "mesh_launches" in k
                else "")
        report(f"  {k['name']}: {k['ms']:.3f} ms (plain {k['plain_ms']:.1f} "
               f"ms, bound {k['bound_ms']:.4f} ms by {k['bound_by']}), "
               f"launches {k['launches']}{mesh}, max_abs_err "
               f"{k['max_abs_err']}{steps} [{card}]")
        if not k["equal_plain"]:
            fail(f"{k['name']} differs from its plain version at the main "
                 "path's shapes")
    return kernels


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from tamp_tpu_torch.ops import _build
    from tamp_tpu_torch.parallel.shard import DEFAULT_SHARD_SIZE

    def report(line: str):
        print(line, flush=True)

    dev = torch.device("cuda")
    card = smi()
    report(f"card: {card}")
    report(f"torch {torch.__version__} cuda {torch.version.cuda} "
           f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    _build.build_all()
    report(f"phase 1: kernels built in {time.perf_counter() - t0:.2f} s")
    for name, log in _build.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                report(f"  {name}: {line.strip()}")

    t0 = time.perf_counter()
    phase_kernels_small(dev, report)
    phase_hazards(dev, report)
    phase_optimal_small(dev, report)
    phase_device_small(dev, report)
    report(f"phase 2: kernels equal to their plain versions "
           f"({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    data = corpus(8 * DEFAULT_SHARD_SIZE)
    report(f"phase 3: corpus of {len(data)} bytes, zero-byte share "
           f"{data.count(0) / len(data):.4f}")
    blobs, launches, ratios, rates = {}, {}, {}, {}
    for name, kw, kernels in PATHS:
        blobs[name], launches[name], ratios[name] = phase_main_path(
            dev, report, data, DEFAULT_SHARD_SIZE, card, name, kw, kernels,
            rates)
        if name == "extended":  # the main path: where its time goes
            phase_breakdown(dev, report, data, blobs[name],
                            DEFAULT_SHARD_SIZE, card)
            phase_profile(report, data, blobs[name], DEFAULT_SHARD_SIZE,
                          card)
        if name == "extended lazy":
            phase_breakdown(dev, report, data, blobs[name],
                            DEFAULT_SHARD_SIZE, card, lazy=True)
        if name.startswith("v1"):
            phase_v1_split(dev, report, data, blobs[name], DEFAULT_SHARD_SIZE,
                           card, lazy="lazy" in name)
        if name.startswith("greedy"):
            base = "extended lazy" if "lazy" in name else "extended"
            report(f"  {name}: ratio {ratios[name]:.6f} beside device-commit "
                   f"{base} {ratios[base]:.6f}")
            phase_greedy(dev, report, data, blobs[name], DEFAULT_SHARD_SIZE,
                         card, lazy="lazy" in name)
        if name == "device":
            phase_device_split(dev, report, data, blobs[name],
                               DEFAULT_SHARD_SIZE, card)
    phase_optimal(dev, report, data, blobs, ratios, DEFAULT_SHARD_SIZE, card)
    phase_device(dev, report, data, blobs, launches, DEFAULT_SHARD_SIZE,
                 card)
    for fmt in ("extended", "v1", "greedy"):
        if not ratios[f"{fmt} lazy"] < ratios[fmt]:
            fail(f"{fmt}: lazy matching did not beat the greedy parse on "
                 f"text ({ratios[f'{fmt} lazy']} vs {ratios[fmt]})")
    t1 = time.perf_counter()
    from tamp_tpu_torch.parallel.shard import compress_sharded

    modes_in = {k: v for k, v in blobs.items()
                if not k.startswith(("greedy", "optimal", "device"))}
    modes_in["extended w15"] = compress_sharded(
        data, window=15, shard_size=DEFAULT_SHARD_SIZE, device=dev,
        engine="device-commit")
    report(f"phase 3: extended w15 container encoded in "
           f"{time.perf_counter() - t1:.1f} s, ratio "
           f"{len(modes_in['extended w15']) / len(data):.6f}")
    dec_launches, _rates = phase_decode_modes(
        dev, report, data, modes_in, DEFAULT_SHARD_SIZE, card)
    phase_commit_shapes(dev, report, data, card)
    t1 = time.perf_counter()
    mesh_launches = phase_mesh(dev, report, data, blobs, card)
    phase_distributed(dev, report, data, blobs, card)
    report(f"phase 3: mesh layer done ({time.perf_counter() - t1:.1f} s)")
    t1 = time.perf_counter()
    new_launches = phase_file_entry(dev, report, data, blobs, card)
    report(f"phase 3: file decode and entry points done "
           f"({time.perf_counter() - t1:.1f} s)")
    t1 = time.perf_counter()
    for wrapper, keys in phase_front_door(dev, report, data, blobs, rates,
                                          card).items():
        for key, counts in keys.items():
            new_launches.setdefault(wrapper, {})[key] = counts
    report(f"phase 3: front door done ({time.perf_counter() - t1:.1f} s)")
    t1 = time.perf_counter()
    for wrapper, keys in phase_api_rest(dev, report, data, blobs,
                                        card).items():
        for key, counts in keys.items():
            new_launches.setdefault(wrapper, {})[key] = counts
    report(f"phase 3: the rest of the API done "
           f"({time.perf_counter() - t1:.1f} s)")
    t1 = time.perf_counter()
    for wrapper, keys in phase_bench(dev, report, card).items():
        for key, counts in keys.items():
            new_launches.setdefault(wrapper, {})[key] = counts
    report(f"phase 3: the bench done ({time.perf_counter() - t1:.1f} s)")
    report(f"phase 3: done ({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    kernels = phase_kernel_times(dev, report, data, modes_in, launches,
                                 dec_launches, mesh_launches,
                                 DEFAULT_SHARD_SIZE, card)
    report(f"phase 4: done ({time.perf_counter() - t0:.1f} s)")
    # the file decode's, entry()'s, the dry run's, the front door's, the
    # rest of the API's and the bench's launches join the row of their
    # kernel (B5's first row for v1_tables)
    rows = {}
    for k in kernels:
        rows.setdefault(k["name"].split()[0], k)
    for wrapper, keys in new_launches.items():
        rows[wrapper].update(keys)

    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dist-child"]:
        sys.exit(dist_child(int(sys.argv[2]), sys.argv[3], sys.argv[4]))
    if sys.argv[1:2] == ["--b4-child"]:
        sys.exit(b4_child(sys.argv[2]))
    sys.exit(main())
