#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tamp_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):

1. the card's name and power limit; build the kernels and the host greedy
   committer from ``csrc/``;
2. each kernel against its plain PyTorch version on the same inputs, at a
   reduced size (2 shards x 64 KiB), exactly: B1 and B2 at windows
   8/10/12/15, B3 at windows 10 and 14 plus an excess-bits row, B4, B8, X1
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
   every decode mode and the serial algorithm;
3. six round trips at full size: 8 x 1 MiB shards of a seeded random-word
   text with a run-heavy stretch, window 10 / literal 8, through
   ``compress_sharded`` and ``decompress_sharded_device``: the main path
   (``engine="device-commit"``, extended, no lazy matching), then extended
   with lazy matching, v1, v1 with lazy matching, and
   ``engine="device-greedy"`` without and with lazy matching.  For each:
   the kernel launch counts of that one round trip
   (every count set to 0 just before it), encode and decode rates (CUDA
   events, median of 3 after a warm-up), the ratio, and the card's
   container equal to the plain versions' on a small input.  For the main
   path also the time of each stage of the encode and the decode, and the
   device's busy and idle share in each (torch.profiler).  For the greedy
   paths: the container equal to the table-less committer's (the card-side
   parity check), a stage breakdown with the bytes pulled per input byte,
   the device's idle share, the dense pull's rate and the table-less
   threaded committer's rate (the host-only yardstick).  Then the decode
   modes: those four containers and an extended window-15 one of the same
   corpus, each decoded through ``decompress_sharded_device`` with
   ``TAMP_TPU_DECODE`` set to commit, chase and xla, and with
   ``algorithm="serial"``: the output equal to the input, the launch
   counts of that one decode (B8 and X1 on chase, X1 on xla, X2 on serial,
   B4 on none of the three), and the rate;
4. each kernel at its path's shapes: its time, its plain version's time
   and result, and its bound (the least time the card could take).

The last lines are the ``kernels`` JSON object, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
INT32_LANES_PER_SM = 64    # Hopper SM: 64 INT32 lanes (H100 whitepaper)
SMALL = 1 << 16            # shard size of phase 2
# the round trips of phase 3, the main path first: name, compress_sharded
# options, and the kernels (wrapper names, B1..B7) each must launch
PATHS = (
    ("extended", {}, ("ext_tables", "commit_fields", "commit_decode")),
    ("extended lazy", {"lazy_matching": True},
     ("ext_tables_probe", "commit_fields", "commit_decode")),
    ("v1", {"extended": False},
     ("v1_tables", "commit_fields", "commit_decode")),
    ("v1 lazy", {"extended": False, "lazy_matching": True},
     ("v1_tables", "commit_v1_lazy", "commit_decode")),
    ("greedy", {"engine": "device-greedy"},
     ("v1_tables", "greedy_predict_batch", "commit_decode")),
    ("greedy lazy", {"engine": "device-greedy", "lazy_matching": True},
     ("v1_tables", "greedy_predict_batch", "commit_decode")),
)
GREEDY_B7_CASES = ((10, 8, False), (10, 8, True), (15, 8, False),
                   (14, 6, True))  # window, literal, lazy (w14 l6: minp 3)
# the decode modes of phase 3: name, the kernels (wrapper names, B8, X1,
# X2) each must launch; none of them launches B4
DECODES = (
    ("chase", ("token_table_chase", "trunc_deficits")),
    ("xla", ("trunc_deficits",)),
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


def smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else \
        f"nvidia-smi failed: {r.stderr.strip()}"


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


def corpus(size: int, seed: int = 0x7A3B) -> bytes:
    """Seeded text: 200 000 draws from 512 random lower-case words (2-9
    letters), space-separated and repeated, with a run-heavy stretch of
    1/16 of the size in its middle so forced RLE regions occur."""
    import numpy as np

    rng = np.random.default_rng(seed)
    words = [rng.integers(97, 123, rng.integers(2, 10)).astype(np.uint8)
             .tobytes() for _ in range(512)]
    base = b" ".join(words[int(i) % 512]
                     for i in rng.integers(0, 512, 200_000))
    text = (base * (-(-size // len(base))))[:size]
    runs = b"".join(bytes([int(b)]) * int(c) for b, c in zip(
        rng.integers(0, 256, 4096), rng.integers(1, 400, 4096)))
    mid = size // 2
    stretch = runs[: size // 16]
    return text[:mid] + stretch + text[mid + len(stretch):]


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
        ext_tables_plain, ext_tables_probe, ext_tables_probe_plain,
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
                                device=dev)
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


def counters():
    """Every kernel wrapper of the port, by name: each counts its launches."""
    from tamp_tpu_torch.ops import decode_commit as dc
    from tamp_tpu_torch.ops.decode_serial import serial_decode
    from tamp_tpu_torch.ops.decode_wavefront import trunc_deficits
    from tamp_tpu_torch.ops.encode_commit import commit_fields, commit_v1_lazy
    from tamp_tpu_torch.ops.greedy_predict import greedy_predict_batch
    from tamp_tpu_torch.ops.match_ext import ext_tables, ext_tables_probe
    from tamp_tpu_torch.ops.match_v1 import v1_tables
    from tamp_tpu_torch.ops.token_chase import token_table_chase

    fns = (ext_tables, ext_tables_probe, commit_fields, dc.commit_decode,
           v1_tables, commit_v1_lazy, token_table_chase, trunc_deficits,
           serial_decode, greedy_predict_batch)
    return {fn.__name__: fn for fn in fns}


def phase_main_path(dev, report, data, shard_size: int, card: str,
                    name: str, kw: dict, kernels):
    """Phase 3: one round trip at full size, which must launch each of
    ``kernels``; returns (blob, launches, ratio) with the launch counts of
    that one round trip."""
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
        for mode, kernels in (("commit", ("commit_decode",)),) + DECODES:
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


def phase_breakdown(dev, report, data, blob, shard_size: int, card: str):
    """Where the main path's time goes: each stage of one encode and one
    decode, host clock around work that ends in a synchronize, median of 3
    after a warm-up."""
    import numpy as np
    import torch

    from tamp_tpu_torch.constants import compute_min_pattern_size
    from tamp_tpu_torch.dictionary import dictionary_array
    from tamp_tpu_torch.engine.pipeline_ext import (
        encode_ext_device_commit, ext_fields, prepare_batch,
    )
    from tamp_tpu_torch.ops import decode_commit as dc
    from tamp_tpu_torch.ops import decode_wavefront as dw
    from tamp_tpu_torch.ops.encode_commit import commit_fields
    from tamp_tpu_torch.ops.match_ext import ext_tables
    from tamp_tpu_torch.parallel.shard import _parse_frame

    window, literal = 10, 8
    W = 1 << window
    lext = compute_min_pattern_size(window, literal) + 131
    shards = [np.frombuffer(data[i : i + shard_size], np.uint8)
              for i in range(0, len(data), shard_size)]
    stages: dict[str, list[float]] = {}

    def timed(name, fn):
        sync(dev)
        t = time.perf_counter()
        out = fn()
        sync(dev)
        stages.setdefault(name, []).append((time.perf_counter() - t) * 1e3)
        return out

    for _ in range(4):
        _p, dh, rc, npos = timed("enc host prep (plan, model, chunk counts)",
                                 lambda: prepare_batch(shards, window=window))
        dh_d, rc_d, npos_d, dict_d = timed("enc host->device", lambda: (
            torch.from_numpy(dh).to(dev), torch.from_numpy(rc).to(dev),
            torch.from_numpy(npos).to(dev),
            torch.from_numpy(dictionary_array(W, literal)).to(dev)))
        timed("enc B1 ext_tables alone", lambda: ext_tables(
            dh_d, npos_d, dict_d, window_bits=window, LEXT=lext))
        tabs, A, B = timed(
            "enc planned fields (B1 + region planes + field planner)",
            lambda: ext_fields(dh_d, rc_d, npos_d, dict_d, window=window,
                               literal=literal))
        NP = dh.shape[1]
        timed("enc B3 commit_fields", lambda: commit_fields(
            A, B, npos_d, max_out=NP + NP // 8 + 64, idx_bits=0))
        del A, B, tabs
        timed("enc whole call (prep .. tail, for the rest)",
              lambda: encode_ext_device_commit(shards, window=window,
                                               literal=literal, device=dev))

        _raw, _ss, pieces = _parse_frame(blob)
        payloads = timed("dec host frame", lambda: [p[1:] for p in pieces])
        nxt, packed = timed(
            "dec payload planes + host->device + per-bit parse",
            lambda: dw.payload_parse(payloads, window=window,
                                     literal=literal, extended=True,
                                     device=dev))
        pk = timed("dec fuse parse words",
                   lambda: dc.fuse_parse(nxt, packed))
        del nxt, packed
        di = torch.from_numpy(dictionary_array(W, literal)).to(dev)
        out, lens, _e = timed("dec B4 commit_decode", lambda: dc._launch(
            pk, di, di, W=W, more=False,
            max_out=dw._pow2_bucket(shard_size, 1024)))
        timed("dec device->host", lambda: out[:, : int(lens.max())].cpu())
        del pk, out
    for name, ts in stages.items():
        report(f"  {name}: {statistics.median(ts[1:]):.2f} ms [{card}]")


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

    def timed(stage, fn):
        sync(dev)
        t = time.perf_counter()
        out = fn()
        sync(dev)
        stages.setdefault(stage, []).append((time.perf_counter() - t) * 1e3)
        return out

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
    over the wall time of the call; the decode also in mode chase, and the
    greedy encodes (without and with lazy matching)."""
    import os

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
            ("encode", lambda: compress_sharded(data, shard_size=shard_size)),
            ("decode", lambda: decompress_sharded_device(blob)),
            ("decode (chase)", chase),
            ("greedy encode", lambda: compress_sharded(
                data, shard_size=shard_size, engine="device-greedy")),
            ("greedy lazy encode", lambda: compress_sharded(
                data, shard_size=shard_size, engine="device-greedy",
                lazy_matching=True))):
        fn()  # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3
        rows = [(e.self_device_time_total / 1e3, e.key, e.count)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        busy = sum(r[0] for r in rows)
        if busy <= 0:
            fail(f"the profiler saw no device activity in the {name}")
        report(f"  profile {name}: wall {wall:.1f} ms, device busy "
               f"{busy:.1f} ms, idle share {1 - busy / wall:.3f} [{card}]")
        for ms, key, count in sorted(rows, reverse=True)[:5]:
            report(f"    {ms:8.3f} ms x{count} {key[:80]}")


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
    from tamp_tpu_torch.ops import decode_commit as dc
    from tamp_tpu_torch.ops import decode_wavefront as dw
    from tamp_tpu_torch.parallel.shard import _parse_frame

    _raw, _ss, pieces = _parse_frame(blob)
    nxt, packed = dw.payload_parse([p[1:] for p in pieces], window=window,
                                   literal=literal, extended=extended,
                                   device=dev)
    pk = dc.fuse_parse(nxt, packed)
    # a decode walk reads one parse word per token, jumping by its bits
    tokens = walk_count(pk.cpu().numpy(), [pk.shape[1]] * len(pieces),
                        lambda p: (p >> 11) & 63)
    return pk, tokens


def phase_kernel_times(dev, report, data, blobs, launches, dec_launches,
                       shard_size: int, card: str):
    """Phase 4: each kernel at its path's shapes against its plain
    version: times, results, bounds.  ``blobs`` and ``launches``: the
    containers and launch counts of phase 3, by path; ``dec_launches``:
    those of its decode modes, by (container, mode).  Returns the
    ``kernels`` records."""
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

    # B1: the model bytes in, four int32 planes out; every position
    # compares its W candidates at least once
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
        ops=int(npos.astype(np.int64).sum()) * W))
    del tabs, ptabs

    # B2: B1's work plus the probe family's W candidates per position
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
        ops=2 * int(npos.astype(np.int64).sum()) * W))
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
        plain_ms=pms,
        bytes=8 * steps + int(st[:, S_NBYTES].sum()) + 4 * S + 64 * S,
        ops=3 * steps))

    # B4: the parse of the main path's container
    pk, tokens = stream_tokens(dev, blobs["extended"], window, literal, True)
    max_out = dw._pow2_bucket(shard_size, 1024)
    ms, got = cuda_ms(lambda: dc._launch(pk, dict_d, dict_d, W=W, more=False,
                                         max_out=max_out))
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
        max_abs_err=max_abs_err(zip(got, plain)), ms=ms, plain_ms=pms,
        bytes=4 * tokens + 2 * W + out_bytes + 8 * S, ops=out_bytes))
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
    kernels.append(dict(
        name="v1_tables (B5)", route="cuda",
        source="tamp_tpu_torch/csrc/match_ext.cu",
        replaces="tamp_tpu/ops/match_pallas.py:75",
        launches=launches["v1"]["v1_tables"],
        max_abs_err=max_abs_err(zip(tabs, ptabs)), ms=ms, plain_ms=pms,
        bytes=S * shard_size + W + 4 * S + 2 * 4 * S * shard_size,
        ops=int(nraw.astype(np.int64).sum()) * W))
    del tabs, ptabs
    # the v1 lazy path's call: the probe family as well
    pms, ptabs = cuda_ms(lambda: v1_tables_plain(raw_d, nraw_d, dict1,
                                                 probe=True, **kw), reps=1)
    ms, tabs = cuda_ms(lambda: v1_tables(raw_d, nraw_d, dict1, probe=True,
                                         **kw))
    report(f"  v1_tables (B5) with the probe family: {ms:.3f} ms (plain "
           f"{pms:.1f} ms), max_abs_err "
           f"{max_abs_err(zip(tabs, ptabs))} [{card}]")
    if max_abs_err(zip(tabs, ptabs)):
        fail("B5 with the probe family differs from its plain version")
    del ptabs

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
        plain_ms=pms,
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
        max_abs_err=b7_err(got, plain), ms=ms, plain_ms=pms,
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

    # X1: the truncation deficits of the main path's token table
    x1_in = dw.fold_inputs(*tab, packed, more=False)
    ms, defs = cuda_ms(lambda: dw.trunc_deficits(*x1_in, W))
    x1_h = [x.cpu() for x in x1_in]
    h0 = time.perf_counter()
    pdefs = dw.trunc_deficits_plain(*x1_h, W)
    pms = (time.perf_counter() - h0) * 1e3
    n_tr = int(x1_in[3].sum())
    report(f"  X1 inputs: {n_tr} truncating tokens of {tokens}")
    # the fold reads three words and writes one per truncating token
    kernels.append(dict(
        name="trunc_deficits (X1)", route="cuda",
        source="tamp_tpu_torch/csrc/decode_wavefront.cu",
        replaces="tamp_tpu/ops/decode_wavefront.py:358",
        launches=dec_launches["extended", "chase"]["trunc_deficits"],
        max_abs_err=max_abs_err([(defs, pdefs)]), ms=ms, plain_ms=pms,
        bytes=16 * n_tr + 4 * S, ops=6 * n_tr))
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

    ops_per_s = int_ops_per_s()  # every kernel's work is integer work
    report(f"  integer peak {ops_per_s / 1e12:.2f} T/s [{card}]")
    for k in kernels:
        t_bytes = k.pop("bytes") / HBM_BYTES_PER_S * 1e3
        t_ops = k.pop("ops") / ops_per_s * 1e3
        k["bound_ms"] = max(t_bytes, t_ops)
        k["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        k["library_ms"] = None  # no single PyTorch call computes these
        k["equal_plain"] = k["max_abs_err"] == 0
        report(f"  {k['name']}: {k['ms']:.3f} ms (plain {k['plain_ms']:.1f} "
               f"ms, bound {k['bound_ms']:.4f} ms by {k['bound_by']}), "
               f"launches {k['launches']}, max_abs_err {k['max_abs_err']} "
               f"[{card}]")
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
    report(f"phase 2: kernels equal to their plain versions "
           f"({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    data = corpus(8 * DEFAULT_SHARD_SIZE)
    report(f"phase 3: corpus of {len(data)} bytes, zero-byte share "
           f"{data.count(0) / len(data):.4f}")
    blobs, launches, ratios = {}, {}, {}
    for name, kw, kernels in PATHS:
        blobs[name], launches[name], ratios[name] = phase_main_path(
            dev, report, data, DEFAULT_SHARD_SIZE, card, name, kw, kernels)
        if name == "extended":  # the main path: where its time goes
            phase_breakdown(dev, report, data, blobs[name],
                            DEFAULT_SHARD_SIZE, card)
            phase_profile(report, data, blobs[name], DEFAULT_SHARD_SIZE,
                          card)
        if name.startswith("greedy"):
            base = "extended lazy" if "lazy" in name else "extended"
            report(f"  {name}: ratio {ratios[name]:.6f} beside device-commit "
                   f"{base} {ratios[base]:.6f}")
            phase_greedy(dev, report, data, blobs[name], DEFAULT_SHARD_SIZE,
                         card, lazy="lazy" in name)
    for fmt in ("extended", "v1", "greedy"):
        if not ratios[f"{fmt} lazy"] < ratios[fmt]:
            fail(f"{fmt}: lazy matching did not beat the greedy parse on "
                 f"text ({ratios[f'{fmt} lazy']} vs {ratios[fmt]})")
    t1 = time.perf_counter()
    from tamp_tpu_torch.parallel.shard import compress_sharded

    modes_in = {k: v for k, v in blobs.items()
                if not k.startswith("greedy")}
    modes_in["extended w15"] = compress_sharded(
        data, window=15, shard_size=DEFAULT_SHARD_SIZE, device=dev)
    report(f"phase 3: extended w15 container encoded in "
           f"{time.perf_counter() - t1:.1f} s, ratio "
           f"{len(modes_in['extended w15']) / len(data):.6f}")
    dec_launches, _rates = phase_decode_modes(
        dev, report, data, modes_in, DEFAULT_SHARD_SIZE, card)
    report(f"phase 3: done ({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    kernels = phase_kernel_times(dev, report, data, modes_in, launches,
                                 dec_launches, DEFAULT_SHARD_SIZE, card)
    report(f"phase 4: done ({time.perf_counter() - t0:.1f} s)")

    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
