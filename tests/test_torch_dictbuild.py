"""The port's dictionary builder (``tamp_tpu_torch.dictbuild``, its sweeps
one batch of the greedy encode a measurement, here the plain versions of
kernels B5 and B7) against the JAX package's ``tamp_tpu.dictbuild``
(native encodes a sample) on seeded small corpora: the totals, the chosen
threshold and every dictionary byte-equal."""

import random

import pytest
import torch

from tamp_tpu import dictbuild as jdb
from tamp_tpu_torch import dictbuild as tdb
from tamp_tpu_torch.engine import pipeline_ext


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The plain tables run many small tensor ops: one intra-op thread runs
    them as fast as eight here and leaves the cores to the other test
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _corpus(n_samples: int, seed: int):
    """Text-like samples sharing a few heavy phrases (the JAX package's
    tests/test_dictbuild.py corpus)."""
    rng = random.Random(seed)
    phrases = [
        b"GET /api/v1/sensors/temperature HTTP/1.1\r\n",
        b"Content-Type: application/json\r\n",
        b'{"device_id": "node-',
        b'", "status": "ok"}',
    ]
    samples = []
    for _ in range(n_samples):
        parts = []
        for _ in range(rng.randint(3, 8)):
            parts.append(rng.choice(phrases))
            parts.append(bytes(rng.randrange(97, 123)
                               for _ in range(rng.randint(0, 6))))
        samples.append(b"".join(parts))
    return samples


@pytest.fixture()
def batches(monkeypatch):
    """The batch sizes of the port's measurements: one device call each."""
    sizes = []
    real = pipeline_ext.encode_ext_device_greedy

    def spy(shards, **kw):
        sizes.append(len(shards))
        return real(shards, **kw)

    monkeypatch.setattr(pipeline_ext, "encode_ext_device_greedy", spy)
    return sizes


@pytest.mark.parametrize("window,literal", ((8, 8), (10, 8), (9, 7)))
def test_evaluate_dictionary_tradeoff_equals_jax(window, literal, batches):
    samples = _corpus(20, window) + [b""]
    samples = [bytes(b & ((1 << literal) - 1) for b in s) for s in samples]
    d = tdb.build_dictionary(samples, window=window, literal=literal,
                             device="cpu")
    for dic in (bytes(d), bytes(d)[-100:], bytes(d)[:1]):
        kw = dict(window=window, literal=literal)
        assert tdb.evaluate_dictionary_tradeoff(
            samples, dic, device="cpu", **kw) \
            == jdb.evaluate_dictionary_tradeoff(samples, dic, **kw)
    assert batches == [len(samples)] * 3


@pytest.mark.parametrize("seed", (7, 11))
def test_build_dictionary_equals_jax(seed, batches):
    samples = _corpus(24, seed)
    for kw in ({"window": 8}, {"window": 10, "trim_threshold": 12},
               {"window": 9, "size": 300, "target_fill": 0.5},
               {"window": 8, "literal": 7, "extended": False}):
        assert tdb.build_dictionary(samples, device="cpu", **kw) \
            == jdb.build_dictionary(samples, **kw)
    assert batches == []  # no sweep: nothing compressed


def test_find_best_trim_threshold_equals_jax(batches):
    samples = _corpus(24, 5)
    kw = dict(window=8, thresholds=(6, 8, 12, 16))
    th, d = tdb.find_best_trim_threshold(samples, device="cpu", **kw)
    assert (th, d) == jdb.find_best_trim_threshold(samples, **kw)
    assert batches == [24] * 4  # one batch a threshold
    assert tdb.build_dictionary(samples, window=8, auto_trim=True,
                                device="cpu") \
        == jdb.build_dictionary(samples, window=8, auto_trim=True)


def test_auto_size_equals_jax(batches):
    samples = _corpus(16, 3)
    assert tdb.build_dictionary(samples, window=8, auto_size=True,
                                device="cpu") \
        == jdb.build_dictionary(samples, window=8, auto_size=True)
    assert batches == [16] * 5  # one batch a fill level


def test_build_dictionary_from_path_equals_jax(tmp_path):
    samples = _corpus(8, 2)
    (tmp_path / "corpus").mkdir()
    for i, s in enumerate(samples):
        (tmp_path / "corpus" / f"s{i}").write_bytes(s)
    (tmp_path / "joined").write_bytes(b"\n--\n".join(samples))
    for path, kw in ((tmp_path / "corpus", {}),
                     (tmp_path / "joined", {"delimiter": "\n--\n"}),
                     (tmp_path / "joined", {})):
        assert tdb.build_dictionary_from_path(path, window=8, device="cpu",
                                              **kw) \
            == jdb.build_dictionary_from_path(path, window=8, **kw)
    (tmp_path / "empty").mkdir()
    with pytest.raises(SystemExit, match="empty"):
        tdb.build_dictionary_from_path(tmp_path / "empty", device="cpu")
    with pytest.raises(ValueError, match="exceed"):
        tdb.build_dictionary(samples, window=8, size=300, device="cpu")
