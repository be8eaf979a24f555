"""The port's bench (``bench_torch.py``) on the CPU: its corpora, its line
in a CPU rehearsal (``--device cpu``, the kernels' plain versions, two 4 KiB
shards at w8), its headline containers against the JAX package's, its exit
without a card and on a corrupted container, and the explicit decode mode
of ``decompress_sharded_device`` that its decode stage passes."""

import json

import numpy as np
import pytest

import bench_torch
import chip_smoke
from tamp_tpu.parallel import shard as jshard
from tamp_tpu_torch.parallel import shard as tshard

TINY = ["--device", "cpu", "--mb", str(8 / 1024), "--device-mb",
        str(8 / 1024), "--shard-kib", "4", "--window", "8", "--reps", "1",
        "--workers", "2"]
# the keys of bench.py's line and its device stages, by the same names
KEYS = ("metric", "value", "unit", "vs_baseline", "pipeline", "corpus_mb",
        "ratio", "decode_mb_s", "decode_vs_baseline", "optimal_ratio",
        "optimal_mb_s", "container_decode_mb_s", "container_decode_chase_mb_s",
        "container_decode_xla_mb_s", "container_decode_serial_mb_s",
        "container_decode_mode", "v1_encode_mb_s", "ext_encode_mb_s",
        "ext_ratio", "greedy_encode_mb_s", "greedy_byte_equal_reference",
        "optimal_encode_mb_s", "optimal_v1_ratio",
        "optimal_byte_equal_host_dp", "decode_commit_compute_ms_mb",
        "encode_commit_compute_ms_mb", "compute_dispatch_ms",
        "device_batch_mb", "setup_s", "workers", "launches", "device")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The plain kernels run many small tensor ops: one intra-op thread
    runs them as fast as eight here and leaves the cores to the other test
    workers (eight threads a worker stalled them ~100x beside five busy
    workers)."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def first_corpus(size: int, seed: int = 0x7A3B) -> bytes:
    """chip_smoke.py's corpus generator as it stood (uint8 words), kept as
    the reference that build_corpus("text") must reproduce."""
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


@pytest.mark.parametrize("seed", [0x7A3B, 2])
def test_text_corpus_is_the_smoke_corpus(seed):
    n = 1_500_000  # past one repeat of the 200 000-draw base
    got = bench_torch.build_corpus(n, seed)
    assert got == first_corpus(n, seed) == chip_smoke.corpus(n, seed)
    # bench.py's fallback wrote int64 letters (7 zero bytes in 8)
    assert got.count(0) / n < 0.01


def test_match_corpus_is_seeded_and_fits_a_1k_window():
    a = bench_torch.build_corpus(300_000, 5, "match")
    assert a == bench_torch.build_corpus(300_000, 5, "match")
    assert a != bench_torch.build_corpus(300_000, 6, "match")
    words = set(a.split(b" ")[:-1])  # the last word may be cut short
    assert len(words) <= 48 and sum(len(w) + 1 for w in words) <= 1024
    assert a.count(0) == 0
    with pytest.raises(ValueError):
        bench_torch.build_corpus(10, kind="enwik8")


def _recording(monkeypatch):
    """Record every container bench_torch's compress_sharded writes:
    (engine, input, container)."""
    seen = []
    real = tshard.compress_sharded

    def record(data, **kw):
        blob = real(data, **kw)
        seen.append((kw.get("engine", "native"), bytes(data), blob))
        return blob
    monkeypatch.setattr(tshard, "compress_sharded", record)
    return seen


def test_cpu_rehearsal_line_and_headline_containers(monkeypatch, capsys):
    seen = _recording(monkeypatch)
    assert bench_torch.main(TINY) == 0
    out = capsys.readouterr().out.strip().splitlines()
    line = json.loads(out[-1])
    assert not [k for k in KEYS if k not in line]
    assert line["device"]["platform"] == "cpu"
    assert "CPU rehearsal" in line["metric"]
    assert line["greedy_byte_equal_reference"] == 1
    assert line["optimal_byte_equal_host_dp"] == 1
    assert line["container_decode_mode"] == "commit"
    rates = [k for k in line if k == "value" or k.endswith("_mb_s")]
    assert len(rates) == 11 and all(line[k] > 0 for k in rates)
    assert line["value_peak_gib"] is None  # not measured on the CPU
    data = bench_torch.build_corpus(8192)
    for engine in ("native", "optimal"):
        want = jshard.compress_sharded(data, window=8, shard_size=4096,
                                       engine=engine)
        got = [b for e, d, b in seen if e == engine and d == data]
        assert got and all(b == want for b in got), engine
        key = "ratio" if engine == "native" else "optimal_ratio"
        assert line[key] == len(want) / len(data)


def test_a_corrupted_container_ends_the_run(monkeypatch, capsys):
    real = tshard.compress_sharded

    def corrupt(data, **kw):
        blob = bytearray(real(data, **kw))
        if kw.get("engine") == "device-commit":
            blob[len(blob) - 700] ^= 0x5A  # inside the last shard's payload
        return bytes(blob)
    monkeypatch.setattr(tshard, "compress_sharded", corrupt)
    with pytest.raises(RuntimeError, match="ext_encode_mb_s"):
        bench_torch.main([*TINY, "--stages", "ext_encode"])
    out = capsys.readouterr().out
    assert "MB/s" not in out and not [ln for ln in out.splitlines()
                                      if ln.startswith("{")]


def test_without_a_card_it_exits_nonzero_and_prints_no_rate(monkeypatch,
                                                            capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench_torch.main(TINY[2:]) != 0
    cap = capsys.readouterr()
    assert cap.out == "" and "MB/s" not in cap.err
    assert "no CUDA device" in cap.err


def test_decode_mode_is_passed_explicitly(monkeypatch):
    from tamp_tpu_torch.ops import decode_wavefront

    data = bench_torch.build_corpus(6000, 3)
    blob = tshard.compress_sharded(data, shard_size=2048, device="cpu")
    modes = []
    real = decode_wavefront.decode_shards_wavefront

    def spy(shards, **kw):
        modes.append(decode_wavefront.resolve_mode(kw.get("mode")))
        return real(shards, **kw)
    monkeypatch.setattr(decode_wavefront, "decode_shards_wavefront", spy)
    monkeypatch.setenv("TAMP_TPU_DECODE", "xla")
    for mode in ("commit", "chase", "xla", None):
        assert tshard.decompress_sharded_device(blob, device="cpu",
                                                mode=mode) == data
    assert modes == ["commit", "chase", "xla", "xla"]
    with pytest.raises(ValueError, match="unknown decode mode"):
        tshard.decompress_sharded_device(blob, device="cpu", mode="fast")
    with pytest.raises(ValueError, match="wavefront"):
        tshard.decompress_sharded_device(blob, algorithm="serial",
                                         device="cpu", mode="commit")
