"""``tamp-tpu-torch`` command-line interface (``python -m tamp_tpu_torch``).

The JAX package's CLI (``tamp_tpu/cli/main.py``: ``compress`` /
``decompress`` / ``build-dictionary``, stdin/stdout defaults,
undersized-dictionary expansion, ``--sharded`` containers, ``--optimal``)
with every route on the card.  Its output files equal ``python -m
tamp_tpu``'s for the same arguments:

- ``compress``: the one-shot :func:`tamp_tpu_torch.compress` (the
  reference greedy encoder's stream, as the native encoder writes it);
  ``--implementation native`` the port's C++ stream
  (:class:`tamp_tpu_torch.stream.NativeCompressor`), ``engine``
  ``engine.encode_device`` (extended) or ``engine.encode_v1`` on the
  card, ``python`` the Python codec (:mod:`tamp_tpu_torch.compressor`);
- ``compress --sharded``: the TTPU container of
  ``compress_sharded(engine="native")``, the JAX CLI's engine (the
  reference greedy encoder's streams, on the card); file to file,
  ``compress_file_sharded(engine="native")``;
- ``--optimal``: the minimum-bit parse, one stream or
  ``engine="optimal"`` with ``--sharded``;
- ``decompress``: a TTPU container through ``decompress_file_sharded``
  (file to file) or ``decompress_sharded`` (kernel X2), a raw stream
  through :func:`tamp_tpu_torch.decompress`, or with ``--implementation
  native`` / ``python`` the port's C++ or Python stream decoder;
- ``build-dictionary``: :mod:`tamp_tpu_torch.dictbuild`.

``--device {cuda,cpu}`` (default ``cuda``) picks where the card's routes
run: without a card they exit with ``resolve_device``'s message unless
``--device cpu`` is given.  The host streams of ``--implementation native``
and ``python`` need no card.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def _read(input_: Path | None) -> bytes:
    data = sys.stdin.buffer.read() if input_ is None else input_.read_bytes()
    if not data:
        raise SystemExit("No data provided.")
    return data


def _write(output: Path | None, data: bytes) -> None:
    if output is None:
        sys.stdout.buffer.write(data)
        sys.stdout.buffer.flush()
    else:
        output.write_bytes(bytes(data))


def get_compress_implementation(impl_name: str | None):
    """The one-shot compress of the JAX CLI's ``--implementation`` choice,
    as the JAX module's function of this name returns it: ``fn(data, *,
    window, literal, extended, lazy_matching, dictionary, device=None)``
    returning the stream.  ``"native"`` (also for None) the port's C++
    stream (:class:`tamp_tpu_torch.stream.NativeCompressor`), ``"engine"``
    ``engine.encode_device`` (extended) or ``engine.encode_v1`` on
    ``device`` (None: the card), ``"python"`` the Python codec
    (:mod:`tamp_tpu_torch.compressor`); the host routes take no device.
    SystemExit for another name, as in the JAX package."""
    impl_name = "native" if impl_name is None else impl_name.lower()
    if impl_name == "native":
        import io

        from tamp_tpu_torch.stream import NativeCompressor

        def fn(data, *, device=None, **kw):
            buf = io.BytesIO()
            with NativeCompressor(buf, **kw) as c:
                c.write(data)
            return buf.getvalue()
    elif impl_name == "engine":
        from tamp_tpu_torch.engine import encode_device, encode_v1

        def fn(data, *, extended=True, device=None, **kw):
            if extended:
                return encode_device(data, device=device, **kw)
            return encode_v1(data, device=device, **kw)
    elif impl_name == "python":
        from tamp_tpu_torch.compressor import compress

        def fn(data, *, device=None, **kw):
            return compress(data, **kw)
    else:
        raise SystemExit(
            f"Unknown implementation: {impl_name}. "
            "Valid options are 'native', 'engine' or 'python'.")
    return fn


def get_decompress_implementation(impl_name: str | None):
    """The one-shot decompress of ``--implementation``: ``fn(data, *,
    dictionary=None)``; ``"native"`` (also for None) the C++ stream, which
    raises OutOfBoundsError as the native decoder does, ``"python"`` the
    Python codec.  SystemExit for another name, as in the JAX package."""
    impl_name = "native" if impl_name is None else impl_name.lower()
    if impl_name == "native":
        from tamp_tpu_torch.stream import NativeDecompressor

        def fn(data, *, dictionary=None):
            with NativeDecompressor(data, dictionary=dictionary) as d:
                return bytes(d.read())
    elif impl_name == "python":
        from tamp_tpu_torch.decompressor import decompress

        def fn(data, *, dictionary=None):
            return bytes(decompress(data, dictionary=None if dictionary is None
                                    else bytearray(dictionary)))
    else:
        raise SystemExit(
            f"Unknown implementation: {impl_name}. "
            "Valid options are 'native' or 'python'.")
    return fn


def load_dictionary(path: Path, window: int, literal: int,
                    extended: bool) -> bytes:
    """Load a dictionary file, expanding undersized files onto the default
    initialized window (reference semantics: main.py:90-105)."""
    from tamp_tpu_torch import initialize_dictionary

    raw = path.read_bytes()
    window_size = 1 << window
    if len(raw) == window_size:
        return raw
    if len(raw) > window_size:
        raise SystemExit(
            f"Dictionary file ({len(raw)} bytes) is larger than window size "
            f"({window_size} bytes)."
        )
    dictionary = initialize_dictionary(
        window_size, literal=literal if extended else 8
    )
    dictionary[-len(raw):] = raw
    return bytes(dictionary)


def _add_io_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("input", nargs="?", type=Path, default=None,
                   help="input file (default: stdin)")
    p.add_argument("--input", "-i", dest="input_opt", type=Path, default=None)
    p.add_argument("--output", "-o", type=Path, default=None,
                   help="output file (default: stdout)")


def _add_device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="run on the CUDA card (default) or, with cpu, the "
                        "kernels' plain versions")


def _window(v: str) -> int:
    w = int(v)
    if not 8 <= w <= 15:
        raise argparse.ArgumentTypeError("window must be in [8, 15]")
    return w


def _literal(v: str) -> int:
    x = int(v)
    if not 5 <= x <= 8:
        raise argparse.ArgumentTypeError("literal must be in [5, 8]")
    return x


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="tamp-tpu-torch",
        description="Compress/Decompress data in Tamp format on the card.")
    sub = ap.add_subparsers(dest="command", required=True)

    c = sub.add_parser("compress", help="Compress an input file or stream.")
    _add_io_args(c)
    c.add_argument("--window", "-w", type=_window, default=10)
    c.add_argument("--literal", "-l", type=_literal, default=8)
    c.add_argument("--dictionary", "-d", type=Path, default=None)
    c.add_argument("--lazy-matching", action="store_true")
    c.add_argument("--no-extended", dest="extended", action="store_false")
    c.add_argument("--sharded", action="store_true",
                   help="emit a TTPU container of independent streams")
    c.add_argument("--shard-size", type=int, default=1 << 20)
    c.add_argument("--optimal", action="store_true",
                   help="minimum-bit parse (smaller than the reference "
                        "encoder's output, still spec-conforming; combine "
                        "with --no-extended for the v1 format)")
    c.add_argument("--implementation", choices=("native", "engine", "python"),
                   default=None,
                   help="one-shot encoder: the C++ stream (native), the "
                        "table engine on the card (engine) or the Python "
                        "codec (python); default: the card's one-shot")
    _add_device_arg(c)

    d = sub.add_parser("decompress", help="Decompress an input file or stream.")
    _add_io_args(d)
    d.add_argument("--dictionary", "-d", type=Path, default=None)
    d.add_argument("--window", "-w", type=_window, default=10)
    d.add_argument("--literal", "-l", type=_literal, default=8)
    d.add_argument("--no-extended", dest="extended", action="store_false")
    d.add_argument("--implementation", choices=("native", "python"),
                   default=None,
                   help="stream decoder: the C++ stream (native) or the "
                        "Python codec (python); default: the card's X2")
    _add_device_arg(d)

    b = sub.add_parser("build-dictionary",
                       help="Build a shared dictionary from a corpus.")
    b.add_argument("corpus", type=Path,
                   help="directory of sample files, or a single delimited file")
    b.add_argument("--output", "-o", type=Path, required=True)
    b.add_argument("--window", "-w", type=_window, default=10)
    b.add_argument("--size", type=int, default=None,
                   help="dictionary size in bytes (default: 1 << window)")
    b.add_argument("--delimiter", type=str, default=None,
                   help="treat corpus as one file split on this delimiter")
    b.add_argument("--trim-threshold", "--min-saved-bits", type=int, default=8,
                   dest="trim_threshold",
                   help="minimum length for common-substring extraction")
    b.add_argument("--target-fill", type=float, default=1.0,
                   help="max fraction of the window filled with corpus content")
    b.add_argument("--auto-trim", action="store_true",
                   help="sweep trim thresholds for the best compressed size")
    b.add_argument("--auto-size", action="store_true",
                   help="sweep fill levels and pick the marginal-return knee")
    _add_device_arg(b)
    return ap


def _dictionary(args) -> bytes | None:
    if args.dictionary is None:
        return None
    return load_dictionary(args.dictionary, args.window, args.literal,
                           args.extended)


def _compress(args, dev) -> int:
    import tamp_tpu_torch as tt
    from tamp_tpu_torch.parallel.shard import (
        compress_file_sharded, compress_sharded,
    )

    cfg = dict(window=args.window, literal=args.literal,
               extended=args.extended)
    inp = args.input_opt or args.input
    if (args.sharded and not args.optimal and inp is not None
            and args.output is not None):
        # file-to-file container: bounded memory (shard-streamed),
        # byte-identical to the in-memory container
        compress_file_sharded(
            inp, args.output, lazy_matching=args.lazy_matching,
            dictionary=_dictionary(args), shard_size=args.shard_size,
            engine="native", device=dev(), **cfg)
        return 0
    data = _read(inp)
    dictionary = _dictionary(args)
    if args.sharded:
        out = compress_sharded(
            data, lazy_matching=args.lazy_matching, dictionary=dictionary,
            shard_size=args.shard_size,
            engine="optimal" if args.optimal else "native", device=dev(),
            **cfg)
    elif args.implementation is not None and not args.optimal:
        out = get_compress_implementation(args.implementation)(
            data, lazy_matching=args.lazy_matching, dictionary=dictionary,
            device=dev() if args.implementation == "engine" else None, **cfg)
    else:
        if len(data) > tt.MAX_STREAM_BYTES:
            raise SystemExit(
                f"one stream on the card is limited to {tt.MAX_STREAM_BYTES}"
                f" bytes ({len(data)} given); use --sharded")
        out = tt.compress(data, lazy_matching=args.lazy_matching,
                          dictionary=dictionary,
                          parse="optimal" if args.optimal else "greedy",
                          device=dev(), **cfg)
    _write(args.output, out)
    return 0


def _decompress(args, dev) -> int:
    from tamp_tpu_torch import decompress
    from tamp_tpu_torch.parallel.shard import (
        decompress_file_sharded, decompress_sharded,
    )

    inp = args.input_opt or args.input
    if inp is not None and args.output is not None:
        with open(str(inp), "rb") as f:
            magic = f.read(4)
        if magic == b"TTPU":  # file-to-file container: bounded memory
            decompress_file_sharded(inp, args.output,
                                    dictionary=_dictionary(args),
                                    device=dev())
            return 0
    data = _read(inp)
    dictionary = _dictionary(args)
    if data[:4] == b"TTPU":
        out = decompress_sharded(data, dictionary=dictionary, device=dev())
    elif args.implementation is not None:
        out = get_decompress_implementation(args.implementation)(
            data, dictionary=dictionary)
    else:
        out = decompress(data, dictionary=dictionary, device=dev())
    _write(args.output, bytes(out))
    return 0


def main(argv=None) -> int:
    from tamp_tpu_torch.device import resolve_device

    args = build_parser().parse_args(argv)

    def dev():
        """The card (or ``--device cpu``), resolved where a route needs it:
        the host streams of ``--implementation`` need none."""
        try:
            return resolve_device(args.device)
        except RuntimeError as e:
            raise SystemExit(str(e)) from None

    if args.command == "compress":
        return _compress(args, dev)
    if args.command == "decompress":
        return _decompress(args, dev)
    if args.command == "build-dictionary":
        from tamp_tpu_torch.dictbuild import build_dictionary_from_path

        dictionary = build_dictionary_from_path(
            args.corpus, window=args.window, size=args.size,
            delimiter=args.delimiter, trim_threshold=args.trim_threshold,
            target_fill=args.target_fill, auto_trim=args.auto_trim,
            auto_size=args.auto_size, device=dev(),
        )
        args.output.write_bytes(bytes(dictionary))
        print(f"Wrote {len(dictionary)}-byte dictionary to {args.output}",
              file=sys.stderr)
        return 0
    return 1


def run_app() -> None:
    raise SystemExit(main())


if __name__ == "__main__":
    run_app()
