"""The port's CLI, ``python -m tamp_tpu_torch ... --device cpu`` (the
plain versions of the kernels), against the JAX package's ``python -m
tamp_tpu ...`` on the same arguments: every output byte-equal (compress
from stdin and from files, ``-w 9 --lazy-matching``, ``--no-extended``,
``--sharded --shard-size 256`` in memory and file to file, ``--optimal``
with and without ``--sharded``, ``-d`` with an undersized dictionary,
``build-dictionary``), the JAX CLI's outputs (containers and raw streams,
from files and stdin) decoded back, the window validation, and the
message without a card."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import tamp_tpu_torch
from tamp_tpu_torch.cli.main import main
from tamp_tpu_torch.device import resolve_device
from tamp_tpu_torch.parallel.shard import decompress_sharded_device

ROOT = Path(__file__).resolve().parent.parent


def _text(n: int, seed: int = 4) -> bytes:
    """Seeded word text with a few byte runs (so RLE tokens occur)."""
    rng = np.random.default_rng(seed)
    words = [rng.integers(97, 123, rng.integers(2, 9)).astype(np.uint8)
             .tobytes() for _ in range(80)]
    text = b" ".join(words[i] for i in rng.integers(0, 80, n // 3))
    return (text[: n // 2] + b"=" * 300 + text[n // 2 :])[:n]


DATA = _text(6000)  # 7-bit bytes: every literal width of 7 or 8 takes it


def _cli(module: str, args, data: bytes | None = None):
    extra = ["--device", "cpu"] if module == "tamp_tpu_torch" else []
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-m", module, *args, *extra],
                       input=data, capture_output=True, cwd=ROOT, env=env,
                       timeout=300)
    assert r.returncode == 0, (module, args, r.stderr.decode())
    return r.stdout


def _both(tmp_path, args, data: bytes | None = None, out: str | None = None):
    """Run both CLIs on ``args`` (``{out}`` stands for each one's output
    path); returns (JAX output, port output) from stdout or the files."""
    got = []
    for module in ("tamp_tpu", "tamp_tpu_torch"):
        dst = tmp_path / f"{module}.{out}" if out else None
        argv = [a.format(out=dst) for a in args]
        stdout = _cli(module, argv, data)
        got.append(dst.read_bytes() if dst else stdout)
    return got


@pytest.fixture()
def src(tmp_path):
    p = tmp_path / "in.bin"
    p.write_bytes(DATA)
    return str(p)


# the compress arguments of each case (SRC: the input file)
COMPRESS = {
    "stdio": [],
    "files, -w 9 --lazy-matching": ["SRC", "-w", "9", "--lazy-matching"],
    "files, --no-extended": ["SRC", "--no-extended"],
    "--sharded in memory": ["-i", "SRC", "--sharded", "--shard-size", "256"],
    "--sharded file to file": ["SRC", "--sharded", "--shard-size", "256"],
    "--sharded --no-extended --lazy-matching file to file":
        ["SRC", "--sharded", "--shard-size", "256", "--no-extended",
         "--lazy-matching"],
    "--optimal": ["SRC", "--optimal", "-w", "11", "-l", "7"],
    "--optimal --sharded --no-extended":
        ["SRC", "--optimal", "--sharded", "--shard-size", "256",
         "--no-extended"],
}


@pytest.mark.parametrize("case", list(COMPRESS))
def test_compress_equals_jax_cli(tmp_path, src, case):
    args = [src if a == "SRC" else a for a in COMPRESS[case]]
    data = DATA if not args else None
    to_file = "file to file" in case or "files" in case
    if to_file:
        args += ["-o", "{out}"]
    want, got = _both(tmp_path, ["compress", *args], data,
                      out="tamp" if to_file else None)
    assert got == want
    if want[:4] == b"TTPU":
        assert bytes(decompress_sharded_device(want, device="cpu")) == DATA
    else:
        assert tamp_tpu_torch.decompress(want, device="cpu") == DATA


def test_undersized_dictionary(tmp_path, src):
    d = tmp_path / "short.dict"
    d.write_bytes(DATA[:100])
    want, got = _both(tmp_path, ["compress", src, "-w", "8", "-l", "7",
                                 "-d", str(d), "-o", "{out}"],
                      out="tamp")
    assert got == want
    # the port's decode of the JAX output, a raw stream from stdin to stdout
    back = _cli("tamp_tpu_torch", ["decompress", "-w", "8", "-l", "7", "-d",
                                   str(d)], want)
    assert back == DATA
    too_long = tmp_path / "long.dict"
    too_long.write_bytes(DATA[:300])
    with pytest.raises(SystemExit, match="larger than window size"):
        main(["compress", src, "-w", "8", "-d", str(too_long), "--device",
              "cpu"])


@pytest.mark.parametrize("kind", ["container file to file",
                                  "container stdio", "raw file to file"])
def test_decompress_jax_cli_outputs(tmp_path, src, kind):
    sharded = ["--sharded", "--shard-size", "256"] if "container" in kind \
        else []
    blob = _cli("tamp_tpu", ["compress", src, *sharded])
    if "file" in kind:
        packed = tmp_path / "in.tamp"
        packed.write_bytes(blob)
        want, got = _both(tmp_path, ["decompress", str(packed), "-o",
                                     "{out}"], out="raw")
    else:
        want, got = _both(tmp_path, ["decompress"], blob)
    assert got == want == DATA


def test_build_dictionary_equals_jax_cli(tmp_path):
    corpus = tmp_path / "corpus"
    corpus.mkdir()
    for i in range(6):
        (corpus / f"s{i}").write_bytes(
            b"sensor[%d] status=ok temperature=21.5C\n" % i * (3 + i))
    want, got = _both(tmp_path, ["build-dictionary", str(corpus), "-o",
                                 "{out}", "-w", "8", "--auto-trim"],
                      out="dict")
    assert got == want and len(got) == 256


def test_window_validation(capsys):
    from tamp_tpu.cli.main import main as jax_main

    for fn, extra in ((jax_main, []), (main, ["--device", "cpu"])):
        with pytest.raises(SystemExit) as e:
            fn(["compress", "-w", "16", *extra])
        assert e.value.code == 2
        assert "window must be in [8, 15]" in capsys.readouterr().err


def test_no_card_message(src):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device runs")
    with pytest.raises(RuntimeError) as want:
        resolve_device(None)
    for argv in (["compress", src], ["decompress", src],
                 ["build-dictionary", src, "-o", src + ".dict"]):
        with pytest.raises(SystemExit) as e:
            main(argv)
        assert e.value.code == str(want.value)
    assert not Path(src + ".dict").exists()


def test_stream_limit_message(tmp_path, monkeypatch):
    """An input above the single-stream limit exits with the limit's
    message and writes nothing, where ``--sharded`` still compresses it."""
    monkeypatch.setattr(tamp_tpu_torch, "MAX_STREAM_BYTES", 100)
    src, out = tmp_path / "in", tmp_path / "out"
    src.write_bytes(b"abc" * 40)
    with pytest.raises(SystemExit) as e:
        main(["compress", str(src), "-o", str(out), "--device", "cpu"])
    assert "limited to 100 bytes (120 given); use --sharded" in str(
        e.value.code)
    assert not out.exists()
    assert main(["compress", str(src), "-o", str(out), "--sharded",
                 "--device", "cpu"]) == 0
    assert decompress_sharded_device(out.read_bytes(),
                                     device="cpu") == b"abc" * 40
