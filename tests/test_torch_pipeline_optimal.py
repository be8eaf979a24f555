"""The port's optimal encodes (``engine="device-optimal"``, v1 and
extended; the plain versions of kernels B5, X3, B3 and X4 on the CPU)
against the JAX package: every stream byte-equal to its host optimal
encoder (``encode_v1(parse="optimal")``, ``encode_extended_optimal``) and
to its device encoder (``encode_v1_device_optimal``, Pallas in interpret
mode; ``encode_ext_device_optimal``), the ExcessBitsError paths, and the
TTPU containers."""

import numpy as np
import pytest
import torch

from tamp_tpu import _native
from tamp_tpu.engine.encode import encode_extended_optimal, encode_v1
from tamp_tpu.engine.pipeline import encode_v1_device_optimal as j_v1
from tamp_tpu.engine.pipeline_ext import encode_ext_device_optimal as j_ext
from tamp_tpu.exceptions import ExcessBitsError as JExcessBitsError
from tamp_tpu.parallel import shard as jshard
from tamp_tpu_torch.dictionary import dictionary_array
from tamp_tpu_torch.engine.greedy import host_v1_tables
from tamp_tpu_torch.engine.pipeline import encode_v1_device_optimal as t_v1
from tamp_tpu_torch.engine.pipeline_ext import (
    encode_ext_device_optimal as t_ext,
)
from tamp_tpu_torch.exceptions import ExcessBitsError
from tamp_tpu_torch.ops.opt_parse import INF, opt_v1_choice
from tamp_tpu_torch.parallel import shard as tshard

from test_torch_cuda import hazard_opt_shards

pytestmark = pytest.mark.skipif(not _native.available(),
                                reason="native engine needed")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The plain DPs run thousands of small tensor ops: one intra-op thread
    runs them as fast as eight here and leaves the cores to the other test
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _host(extended, shard, **kw):
    if extended:
        return encode_extended_optimal(shard, **kw)
    return encode_v1(shard, parse="optimal", **kw)


def _custom(window: int, literal: int) -> bytes:
    """A full window of seeded text, masked to the literal width."""
    text = b"".join(hazard_opt_shards(99, window, literal)[4:9])
    return (text * 8)[: 1 << window]


@pytest.mark.parametrize("custom", [False, True])
@pytest.mark.parametrize("extended", [False, True])
def test_streams_equal_host_and_jax_device_encoders(extended, custom):
    # the hazard shards, an empty and a tiny one (literal 6: the excess-bits
    # and default-window tests below)
    window, literal = 10, 8
    shards = [b"", b"\x05"] + hazard_opt_shards(5, window, literal)[1:]
    kw = dict(window=window, literal=literal,
              dictionary=_custom(window, literal) if custom else None)
    got = (t_ext if extended else t_v1)(shards, device="cpu", **kw)
    assert got == [_host(extended, s, **kw) for s in shards]
    assert got == (j_ext if extended else j_v1)(shards, **kw)


def _bad_only_case():
    """(dictionary, shard) at w11 l6 where one byte fits no literal and no
    match starting at it, but the match before it covers it: the optimal
    walk skips it (cost0 < INF), yet the native DP raises (``bad``)."""
    window = 11
    dictionary = bytearray(_custom(window, 6))
    dictionary[500:502] = b"\x21\xff"
    dictionary[502] = 0x22
    head = hazard_opt_shards(3, window, 6)[4][:300]
    return bytes(dictionary), head + b"\x21\xff\x23" + head[:200]


@pytest.mark.parametrize("path", ["cost0", "bad"])
@pytest.mark.parametrize("extended", [False, True])
def test_excess_bits_paths_match_jax(extended, path):
    window, literal = 11, 6
    if path == "cost0":  # a byte that no token can code, on the walk
        dictionary = None
        shard = hazard_opt_shards(5, window, literal)[12]
    else:
        dictionary, shard = _bad_only_case()
        if not extended:  # the DP alone: bad, though cost0 < INF
            arr = np.frombuffer(shard, np.uint8)
            flen = np.zeros((1, 1024), np.int32)
            data = np.zeros((1, 1024), np.uint8)
            flen[0, : len(shard)] = host_v1_tables(
                arr, window=window, literal=literal, cap=16,
                dictionary=dictionary)[0]
            data[0, : len(shard)] = arr
            _ch, cost0, bad = opt_v1_choice(
                torch.from_numpy(flen), torch.from_numpy(data),
                torch.tensor([len(shard)], dtype=torch.int32),
                window=window, literal=literal)
            assert bool(bad[0]) and int(cost0[0]) < INF
    kw = dict(window=window, literal=literal, dictionary=dictionary)
    shards = [shard, hazard_opt_shards(5, window, literal)[4]]
    with pytest.raises(ExcessBitsError):
        (t_ext if extended else t_v1)(shards, device="cpu", **kw)
    with pytest.raises(JExcessBitsError):
        (j_ext if extended else j_v1)(shards, **kw)
    with pytest.raises(JExcessBitsError):
        _host(extended, shard, **kw)


@pytest.mark.parametrize("extended", [False, True])
def test_container_equals_jax_and_round_trips(extended):
    parts = hazard_opt_shards(8, 10, 8)
    data = b"".join(parts[4:12]) + parts[8]
    blob = tshard.compress_sharded(data, shard_size=4096, extended=extended,
                                   engine="device-optimal", device="cpu")
    assert blob == jshard.compress_sharded(data, shard_size=4096,
                                           extended=extended,
                                           engine="device-optimal")
    # lazy matching does not apply to the optimal parse
    assert blob == tshard.compress_sharded(
        data, shard_size=4096, extended=extended, engine="device-optimal",
        lazy_matching=True, device="cpu")
    assert bytes(tshard.decompress_sharded_device(blob, device="cpu")) == data
    assert bytes(jshard.decompress_sharded(blob)) == data
    if not extended:  # minimum bits over the greedy parse's token family
        assert len(blob) <= len(tshard.compress_sharded(
            data, shard_size=4096, extended=False, device="cpu",
            engine="device-commit"))


def test_default_windows_of_the_two_formats():
    # v1 seeds its window at literal 8, extended at the real literal width
    window, literal = 10, 6
    shard = hazard_opt_shards(6, window, literal)[6]
    for extended, lit in ((False, 8), (True, literal)):
        d = dictionary_array(1 << window, literal=lit).tobytes()
        kw = dict(window=window, literal=literal)
        got = (t_ext if extended else t_v1)([shard], device="cpu", **kw)[0]
        assert got[1:] == _host(extended, shard, dictionary=d, **kw)[1:]
