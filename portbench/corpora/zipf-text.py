"""Seeded Zipf text, the benchmark's stand-in for enwik8 (English Wikipedia
XML): the language made with NumPy, the documents in bulk with PyTorch on
the run's device.

A configuration's ``assumed.corpus`` names every parameter.  The
vocabulary (the "language") comes from its own fixed seed, so every run
speaks the same language; the documents come from the run's ``--seed``.

- Words are made of syllables: a syllable inventory of strings of 1-4
  letters (English letter frequencies), drawn with Zipf weights, and 1-4
  of them to a word.  The shorter words hold the higher ranks, as in
  English.
- Each word slot of a document is ``[open] word [close] [punct] sep``: the
  word drawn by Zipf's law over the vocabulary (rank ``r`` with weight
  ``r ** -zipf_exponent``), capitalised with probability
  ``capital_share``; ``open``/``close`` a wiki link (``[[``, ``]]``) or bold
  markup (``'''``) with their shares, else nothing; ``punct`` ``,`` or
  ``.`` with their shares; ``sep`` a space, or a line break, a blank line or
  a list item (the short markup lines) with their shares.
- Every shard of every input then carries one run-heavy stretch of
  ``run_share`` of its bytes at a seeded offset: byte values uniform over
  0..255, run lengths uniform over ``run_lengths``, so that the extended
  format's forced-RLE regions occur in every shard.

Draws by weight go through a table of ``2**TABLE_BITS`` entries, each
outcome holding its share of them (at least one), so that a draw is one
random integer and one gather.  Every input is drawn afresh: nothing is
repeated.  A seed gives the same inputs on every run on one kind of
device (the card's generator is not the CPU's).
"""

from __future__ import annotations

import itertools

import numpy as np

__all__ = ["Vocabulary", "make_inputs"]

TABLE_BITS = 20
_OPEN = (b"", b"[[", b"'''")
_CLOSE = (b"", b"]]", b"'''")
_PUNCT = (b"", b",", b".")
_SEPS = (b" ", b"\n", b"\n\n", b"\n* ")


def _table(p: np.ndarray) -> np.ndarray:
    """A draw table of ``2**TABLE_BITS`` outcome ids in proportion to ``p``
    (every outcome at least once)."""
    n = 1 << TABLE_BITS
    counts = np.maximum(1, np.floor(p / p.sum() * (n - p.size)).astype(
        np.int64))
    counts[np.argmax(counts)] += n - counts.sum()
    return np.repeat(np.arange(p.size, dtype=np.int32), counts)


def _shares(shares) -> np.ndarray:
    """Probabilities of outcome 0 (what is left) and of each share."""
    p = np.asarray(shares, np.float64)
    return np.concatenate([[1 - p.sum()], p])


class Vocabulary:
    """The piece table of one language: every word lower-case and
    capitalised, then one piece for each opener and one for each
    (closer, punctuation, separator), as one byte buffer with each piece's
    start and length."""

    def __init__(self, spec: dict):
        rng = np.random.default_rng(int(spec["vocabulary_seed"]))
        letters_p = np.asarray(spec["letter_freq"], np.float64)

        def draw(p, size):
            p = np.asarray(p, np.float64)
            return rng.choice(p.size, size=size, p=p / p.sum())

        def joined(lens, part_bytes):
            """Rows of the (len(lens), 16) zero-padded matrix whose row i
            holds ``lens[i]`` bytes taken in order from ``part_bytes``."""
            rows = np.repeat(np.arange(lens.size), lens)
            cols = np.arange(rows.size) - np.repeat(np.cumsum(lens) - lens,
                                                    lens)
            mat = np.zeros((lens.size, 16), np.uint8)
            mat[rows, cols] = part_bytes
            return mat

        n_syl = int(spec["syllables"])
        syl_len = 1 + draw(spec["syllable_lengths"], n_syl)
        syl = joined(syl_len, (97 + draw(letters_p, int(syl_len.sum())))
                     .astype(np.uint8))
        syl_w = np.arange(1, n_syl + 1, dtype=np.float64) ** -float(
            spec["syllable_zipf"])
        n = int(spec["vocabulary"])
        m = 4 * n  # candidates; only distinct words are kept
        k = 1 + draw(spec["word_syllables"], m)
        ids = draw(syl_w, int(k.sum()))
        lens = np.add.reduceat(syl_len[ids], np.cumsum(k) - k)
        part = syl[ids][np.arange(16)[None, :] < syl_len[ids][:, None]]
        mat = joined(lens, part)
        _, first = np.unique(mat.view(f"V16").ravel(), return_index=True)
        first = np.sort(first)[:n]
        if first.size < n:
            raise ValueError("the syllables make too few distinct words")
        mat, lens = mat[first], lens[first]
        # the frequent words are the short ones: rank by length plus noise
        order = np.argsort(lens + rng.uniform(0, spec["rank_noise"], n),
                           kind="stable")
        mat, lens = mat[order], lens[order]
        caps = mat.copy()
        caps[:, 0] -= 32
        inside = np.arange(16)[None, :] < lens[:, None]
        words = [mat[inside], caps[inside]]
        combos = list(itertools.product(range(len(_CLOSE)), range(len(_PUNCT)),
                                        range(len(_SEPS))))
        extra = list(_OPEN) + [_CLOSE[c] + _PUNCT[p] + _SEPS[s]
                               for c, p, s in combos]
        self.buf = np.concatenate(
            words + [np.frombuffer(b"".join(extra), np.uint8)])
        self.len = np.concatenate(
            [lens, lens, [len(p) for p in extra]]).astype(np.int32)
        self.start = np.concatenate([[0], np.cumsum(self.len)[:-1]]).astype(
            np.int32)
        self.n = n
        self.open_id = 2 * n
        w = np.arange(1, n + 1, dtype=np.float64) ** -float(
            spec["zipf_exponent"])
        self.words = _table(w)
        # a slot's decoration: (open kind, punct, sep), the closer following
        # the opener
        kind_p = _shares([spec["link_share"], spec["bold_share"]])
        punct_p, sep_p = _shares(spec["punct_shares"]), _shares(
            spec["sep_shares"])
        kinds = np.arange(len(_OPEN))
        deco = [(k, k * len(_PUNCT) * len(_SEPS) + p * len(_SEPS) + s)
                for k in kinds for p in range(len(_PUNCT))
                for s in range(len(_SEPS))]
        deco_p = np.asarray([kind_p[k] * punct_p[(i // len(_SEPS))
                                                  % len(_PUNCT)]
                             * sep_p[i % len(_SEPS)] for k, i in deco])
        self.deco_open = np.asarray([self.open_id + k for k, _ in deco],
                                    np.int32)
        self.deco_suffix = np.asarray([self.open_id + len(_OPEN) + i
                                       for _, i in deco], np.int32)
        self.decos = _table(deco_p)
        self.capital_share = float(spec["capital_share"])
        self.spec = spec
        # a slot's mean length, which sizes each batch of draws
        lens = self.len
        self.slot_bytes = float(lens[self.words].mean()
                                + lens[self.deco_open[self.decos]].mean()
                                + lens[self.deco_suffix[self.decos]].mean())


# output bytes drawn in one go: the device's draws follow this, never the
# device's size, so a seed gives the same inputs on every card
CHUNK_BYTES = 1 << 23


def _chunk(gen, voc: dict, rows: int, nbytes: int, spec: dict):
    """``rows`` shards of ``nbytes`` on ``gen``'s device, as a
    ``(rows, nbytes)`` uint8 tensor: word slots (the last one cut), then in
    each row its run-heavy stretch of ``run_share`` at a seeded offset."""
    import torch

    dev = gen.device
    n = int(nbytes / voc["slot_bytes"] * 1.1) + 256  # slots a row
    pieces = torch.empty((rows, 0), dtype=torch.int64, device=dev)
    while True:
        r = torch.randint(0, 1 << TABLE_BITS, (2, rows, n), generator=gen,
                          device=dev)
        deco = voc["decos"][r[1]]
        word = voc["words"][r[0]] + voc["n"] * (
            torch.rand((rows, n), generator=gen, device=dev)
            < voc["capital_share"])
        pieces = torch.cat([pieces, torch.stack(
            [voc["deco_open"][deco], word, voc["deco_suffix"][deco]],
            dim=-1).reshape(rows, 3 * n)], dim=1)
        lens = voc["len"][pieces]
        ends = torch.cumsum(lens, dim=1)
        if bool((ends[:, -1] >= nbytes).all()):  # rare: a row came out short
            break
    # each output byte: its piece's start plus its offset in the piece
    pos = torch.arange(nbytes, device=dev).repeat(rows, 1)
    k = torch.searchsorted(ends, pos, right=True)
    at = voc["start"][pieces.gather(1, k)] + pos - ends.gather(1, k) \
        + lens.gather(1, k)
    data = voc["buf"][at]
    m = int(nbytes * spec["run_share"])
    if m:
        lo, hi = spec["run_lengths"]
        count = 2 * m // (lo + hi) + 64
        vals = torch.randint(0, 256, (rows, count), generator=gen,
                             device=dev, dtype=torch.uint8)
        runs = torch.randint(lo, hi + 1, (rows, count), generator=gen,
                             device=dev)
        while not bool((runs.sum(dim=1) >= m).all()):  # rare: short draws
            vals, runs = vals.repeat(1, 2), runs.repeat(1, 2)
        q = torch.arange(m, device=dev).repeat(rows, 1)
        j = torch.searchsorted(torch.cumsum(runs, dim=1), q, right=True)
        off = torch.randint(0, nbytes - m + 1, (rows, 1), generator=gen,
                            device=dev)
        data.scatter_(1, off + q, vals.gather(1, j))
    return data


def make_inputs(spec: dict, seed: int, count: int, shards: int,
                shard_bytes: int, device: str = "cpu") -> list[bytes]:
    """``count`` inputs of ``shards`` shards of ``shard_bytes`` each, drawn
    with PyTorch on ``device`` ("cuda": on the card, in a few large calls)
    from one generator seeded with ``seed``, in chunks of
    ``CHUNK_BYTES``."""
    import torch

    v = Vocabulary(spec)
    dev = torch.device(device)
    voc = {name: torch.as_tensor(getattr(v, name), dtype=torch.int64,
                                 device=dev)
           for name in ("len", "start", "words", "decos", "deco_open",
                        "deco_suffix")}
    voc["buf"] = torch.as_tensor(v.buf, device=dev)
    voc.update(n=v.n, capital_share=v.capital_share,
               slot_bytes=v.slot_bytes)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % (1 << 64))
    total = count * shards
    out = torch.empty((total, shard_bytes), dtype=torch.uint8)
    step = max(1, CHUNK_BYTES // shard_bytes)
    for r0 in range(0, total, step):
        rows = min(step, total - r0)
        out[r0:r0 + rows] = _chunk(gen, voc, rows, shard_bytes, spec).cpu()
    del voc
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    flat = out.numpy()
    return [flat[i * shards:(i + 1) * shards].tobytes() for i in range(count)]
