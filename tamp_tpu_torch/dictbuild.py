"""Dictionary-building toolchain (the port's copy of ``tamp_tpu.dictbuild``).

Builds custom initialization dictionaries from a sample corpus, with the
full capability set of the reference toolchain (BrianPugh/tamp
tamp/cli/build_dictionary.py + tamp/_c_build_dictionary.pyx):

- per-sample substring scoring with the real token cost model (basic +
  extended match encodings), Apriori prefix pruning;
- phase 1: greedy long-substring selection with shifted-duplicate
  rejection (shared (minp+1)-gram filter) and corpus *fragment splitting*
  so later phases never double-count covered occurrences;
- phase 2: re-score the remaining fragments and fill with short
  high-frequency patterns (simple containment check — " to " is useful
  even inside a longer phase-1 phrase);
- shared-substring deduplication: iteratively extract the longest
  substring shared by >= 2 entries, replacing containers with remainders;
- phase 3: backfill the space dedup freed, with the phase-1 overlap rule;
- packing ordered by Q3 corpus position then score density, right-to-left
  (late-appearing, high-value bytes survive longest at the window's end);
- trim-threshold sweep measuring real compressed sizes, and knee-driven
  effective-size selection (``auto_size``) over a target-fill sweep.

The scoring, selection, dedup, packing and knee code is host Python, as in
the JAX package.  The sweeps' measurement,
:func:`evaluate_dictionary_tradeoff`, compresses the whole corpus as one
batch of the reference greedy encode on the card (kernels B5 and B7 once,
then the host greedy committer a thread a sample:
engine/pipeline_ext.encode_ext_device_greedy), whose streams equal the
native encoder's that the JAX package sums, so every total, the chosen
threshold and the dictionary are the JAX package's.

The cost model: replacing one occurrence of an ``L``-byte string with a
match token saves ``L*(1+literal) - match_cost(L)`` bits, where
``match_cost`` uses the format's huffman table (and the extended-match
encoding for long patterns).
"""

from __future__ import annotations

from pathlib import Path

from .constants import (
    HUFFMAN_LENGTHS,
    compute_min_pattern_size,
)
from .dictionary import initialize_dictionary

__all__ = [
    "build_dictionary",
    "build_dictionary_from_path",
    "pack_dictionary",
    "score_substrings",
    "select_candidates",
    "evaluate_dictionary_tradeoff",
    "find_best_trim_threshold",
    "find_knee",
]

_MAX_LEN = 64          # candidate substring length cap
_SAMPLE_CAP = 1 << 20  # corpus bytes examined for scoring
_CANDIDATE_CAP = 50_000


def _match_cost_bits(length: int, window: int, literal: int, extended: bool) -> int:
    """Bits to encode one match of ``length`` bytes (format token costs)."""
    minp = compute_min_pattern_size(window, literal)
    if length < minp:
        return length * (1 + literal)  # literals
    idx = length - minp
    if idx <= 13:
        return HUFFMAN_LENGTHS[idx] + window  # lengths include the flag bit
    if extended and idx <= 131:
        # extended match: EXT huffman (flag incl.) + secondary huffman
        # (no flag) + 3 trailing bits + window index.
        sym = min(max((length - minp - 12) >> 3, 0), 14)
        return HUFFMAN_LENGTHS[13] + (HUFFMAN_LENGTHS[sym] - 1) + 3 + window
    # longer strings are encoded as multiple tokens; approximate greedily
    best = HUFFMAN_LENGTHS[13] + window
    return best + _match_cost_bits(length - (minp + 13), window, literal, extended)


def _saved_bits(length: int, window: int, literal: int, extended: bool) -> int:
    return length * (1 + literal) - _match_cost_bits(length, window, literal, extended)


def _clip_samples(samples: list[bytes], window: int) -> list[bytes]:
    W = 1 << window
    budget = _SAMPLE_CAP // max(1, len(samples))
    return [bytes(s[: max(min(budget, W), 256)]) for s in samples if s]


def score_substrings(
    samples: list[bytes],
    *,
    window: int = 10,
    literal: int = 8,
    extended: bool = True,
    min_count: int = 2,
    max_len: int = _MAX_LEN,
    multi_frag_min_length: int | None = None,
):
    """(scores, multi_frag): per-sample-count scores and the set of
    substrings appearing in >= 2 samples with length >= the threshold.

    Apriori expansion on PER-SAMPLE counts (a substring can appear in 2+
    samples only if its one-shorter prefix does): score = samples
    containing it x bits saved at its length.
    """
    minp = compute_min_pattern_size(window, literal)
    if multi_frag_min_length is None:
        multi_frag_min_length = minp
    samples = [s for s in samples if s]
    scores: dict[bytes, float] = {}
    multi_frag: set[bytes] = set()
    if not samples:
        return scores, multi_frag

    def sample_counts(length: int, freq: set | None):
        counts: dict[bytes, int] = {}
        for s in samples:
            subs = set()
            for i in range(len(s) - length + 1):
                g = s[i : i + length]
                if freq is not None and g[:-1] not in freq:
                    continue
                subs.add(g)
            for g in subs:
                counts[g] = counts.get(g, 0) + 1
        return counts

    freq: set | None = None
    for length in range(minp, max_len + 1):
        counts = sample_counts(length, freq)
        freq = set()
        saved = _saved_bits(length, window, literal, extended)
        for g, c in counts.items():
            if c >= min_count:
                freq.add(g)
                if saved > 0:
                    scores[g] = c * saved
                if length >= multi_frag_min_length:
                    multi_frag.add(g)
        if not freq:
            break
    return scores, multi_frag


def select_candidates(
    candidates: list[tuple[bytes, float]],
    multi_frag: set[bytes],
    budget: int,
    overlap_threshold: int,
) -> list[bytes]:
    """Greedy selection with shifted-duplicate rejection: accept the best
    remaining candidate that appears in >= 2 fragments and shares no
    ``overlap_threshold``-gram with an accepted entry."""
    used_grams: set[bytes] = set()
    out: list[bytes] = []
    used = 0
    for g, _score in candidates:
        if used >= budget:
            break
        if g not in multi_frag:
            continue
        L = len(g)
        if any(g[k : k + overlap_threshold] in used_grams
               for k in range(L - overlap_threshold + 1)):
            continue
        out.append(g)
        used += L
        for k in range(L - overlap_threshold + 1):
            used_grams.add(g[k : k + overlap_threshold])
    return out


def _split_fragments(fragments: list[bytes], pattern: bytes,
                     min_length: int) -> list[bytes]:
    return [part for f in fragments for part in f.split(pattern)
            if len(part) >= min_length]


def _dedup_shared(entries: list[bytes], min_shared: int) -> list[bytes]:
    """Iteratively extract the longest substring shared by >= 2 entries,
    replacing each container with its unique remainders."""
    entries = list(entries)
    for _ in range(len(entries)):
        counts: dict[bytes, int] = {}
        for e in entries:
            seen: set[bytes] = set()
            for length in range(min_shared, len(e)):
                for k in range(len(e) - length + 1):
                    sub = e[k : k + length]
                    if sub != e and sub not in seen:
                        seen.add(sub)
                        counts[sub] = counts.get(sub, 0) + 1
        best = None
        best_key = (0, 0)
        for sub, c in counts.items():
            if c >= 2 and (len(sub), c) > best_key:
                best, best_key = sub, (len(sub), c)
        if best is None:
            break
        nxt: list[bytes] = []
        added = False
        for e in entries:
            if best in e and best != e:
                i = e.index(best)
                for part in (e[:i], e[i + len(best):]):
                    if len(part) >= min_shared:
                        nxt.append(part)
                if not added:
                    nxt.append(best)
                    added = True
            else:
                nxt.append(e)
        entries = nxt
    return [e for e in entries
            if not any(e in o and e != o for o in entries)]


def _q3_positions(entries: list[bytes], samples: list[bytes],
                  window: int) -> dict[bytes, float]:
    """75th-percentile normalized end position of each entry's corpus
    occurrences (late-appearing entries belong at the window's end)."""
    W = 1 << window
    pos: dict[bytes, list[float]] = {e: [] for e in entries}
    for s in samples:
        s = s[:W]
        for e in entries:
            start = 0
            while True:
                i = s.find(e, start)
                if i < 0:
                    break
                pos[e].append((i + len(e)) / W)
                start = i + 1
    out = {}
    for e, ps in pos.items():
        if ps:
            ps.sort()
            out[e] = ps[min(int(len(ps) * 0.75), len(ps) - 1)]
        else:
            out[e] = 0.5
    return out


def pack_dictionary(
    scored_entries, size: int, *, literal: int = 8
) -> tuple[bytearray, int]:
    """Pack entries right-to-left onto the default-initialized window.

    ``scored_entries``: (entry, score, q3_position) triples — sorted so
    the rightmost (newest, cheapest-offset, longest-surviving) bytes are
    the late-appearing, highest-density entries.  Returns (dictionary,
    effective bytes used).  Also accepts legacy (score, entry) pairs.
    """
    norm = []
    for t in scored_entries:
        if isinstance(t[0], (bytes, bytearray)):
            norm.append((bytes(t[0]), float(t[1]),
                         float(t[2]) if len(t) > 2 else 0.5))
        else:  # legacy (score, entry)
            norm.append((bytes(t[1]), float(t[0]), 0.5))
    ranked = sorted(
        norm, key=lambda t: (t[2], t[1] / max(1, len(t[0])), t[0]))
    out = initialize_dictionary(size, literal=literal)
    picked = []
    used = 0
    for e, score, _p in reversed(ranked):
        if score <= 0 or used + len(e) > size:
            continue
        picked.append(e)
        used += len(e)
    pos = size
    for e in picked:
        pos -= len(e)
        out[pos : pos + len(e)] = e
    return out, used


def _build_pipeline(
    samples: list[bytes],
    *,
    window: int,
    literal: int,
    extended: bool,
    trim_threshold: int,
    target_fill: float,
    size: int,
    scored=None,
):
    """Phases 1-3 + dedup + packing; returns (dictionary, effective_size)."""
    minp = compute_min_pattern_size(window, literal)
    budget = int(size * max(0.0, min(1.0, target_fill)))
    if scored is None:
        scored = score_substrings(
            samples, window=window, literal=literal, extended=extended,
            multi_frag_min_length=min(trim_threshold, minp + 1))
    scores, multi_frag = scored
    if not scores or budget <= 0:
        return initialize_dictionary(
            size, literal=literal if extended else 8), 0

    ranked_all = sorted(scores.items(), key=lambda t: (-t[1], -len(t[0]), t[0]))

    # phase 1: long substrings, overlap-filtered, then split the corpus
    cands = [(g, sc) for g, sc in ranked_all
             if len(g) >= trim_threshold][:_CANDIDATE_CAP]
    entries = select_candidates(cands, multi_frag, budget, minp + 1)
    fragments = list(samples)
    for e in entries:
        fragments = _split_fragments(fragments, e, minp)
    total = sum(len(e) for e in entries)

    # phase 2: re-score the fragments; short fillers by containment only
    if total < budget and fragments:
        f_scores, f_multi = score_substrings(
            fragments, window=window, literal=literal, extended=extended,
            multi_frag_min_length=minp)
        entry_set = set(entries)
        for g, _sc in sorted(f_scores.items(),
                             key=lambda t: (-t[1], -len(t[0]), t[0])):
            if g not in f_multi or g in entry_set:
                continue
            entries.append(g)
            entry_set.add(g)
            total += len(g)
            if total >= budget:
                break

    # dedup shared substrings across entries
    entries = _dedup_shared(entries, trim_threshold)

    # phase 3: backfill freed space with the phase-1 overlap rule
    ov = minp + 1
    covered: set[bytes] = set()
    for e in entries:
        for k in range(len(e) - ov + 1):
            covered.add(e[k : k + ov])
    entry_set = set(entries)
    total = sum(len(e) for e in entries)
    if total < budget:
        for g, _sc in ranked_all:
            if total >= budget:
                break
            if g in entry_set:
                continue
            if any(g[k : k + ov] in covered for k in range(len(g) - ov + 1)):
                continue
            entries.append(g)
            entry_set.add(g)
            for k in range(len(g) - ov + 1):
                covered.add(g[k : k + ov])
            total += len(g)

    positions = _q3_positions(entries, samples, window)
    triples = [(e, scores.get(e, 1.0), positions.get(e, 0.5))
               for e in entries]
    return pack_dictionary(triples, size,
                           literal=literal if extended else 8)


def build_dictionary(
    samples: list[bytes],
    *,
    window: int = 10,
    size: int | None = None,
    literal: int = 8,
    extended: bool = True,
    trim_threshold: int = 8,
    target_fill: float = 1.0,
    auto_trim: bool = False,
    auto_size: bool = False,
    min_saved_bits: int | None = None,  # legacy alias for trim_threshold
    device=None,
) -> bytearray:
    """Build a ``size``-byte dictionary from corpus ``samples``.

    ``auto_trim`` sweeps trim thresholds measuring real compressed sizes;
    ``auto_size`` additionally sweeps target-fill levels and picks the
    marginal-return knee (:func:`find_knee`) — more corpus content is
    only kept while it still pays for the window bytes it occupies.
    Each measurement is one batch on ``device`` (None: the CUDA card;
    ``"cpu"``: the plain versions).
    """
    size = size or (1 << window)
    if size > (1 << window):
        raise ValueError("dictionary size cannot exceed the window size")
    if min_saved_bits is not None:
        trim_threshold = max(trim_threshold, min_saved_bits)
    samples = _clip_samples(samples, window)
    if auto_size:
        scored = score_substrings(
            samples, window=window, literal=literal, extended=extended,
            multi_frag_min_length=compute_min_pattern_size(window, literal))
        results = []
        builds = {}
        for tf in (0.125, 0.25, 0.5, 0.75, 1.0):
            d, eff = _build_pipeline(
                samples, window=window, literal=literal, extended=extended,
                trim_threshold=trim_threshold, target_fill=tf, size=size,
                scored=scored)
            tot = evaluate_dictionary_tradeoff(
                samples, bytes(d), window=window, literal=literal,
                device=device)
            results.append((eff, tot))
            builds[eff] = d
        knee_eff = find_knee(results)
        return builds[knee_eff]
    if auto_trim:
        return find_best_trim_threshold(
            samples, window=window, size=size, literal=literal,
            extended=extended, target_fill=target_fill, device=device)[1]
    d, _eff = _build_pipeline(
        samples, window=window, literal=literal, extended=extended,
        trim_threshold=trim_threshold, target_fill=target_fill, size=size)
    return d


def evaluate_dictionary_tradeoff(
    samples: list[bytes], dictionary: bytes, *, window: int = 10,
    literal: int = 8, device=None,
) -> int:
    """Total compressed corpus size (bytes) using ``dictionary``: every
    sample's extended greedy stream, the whole corpus one batch on the
    card.  ``device``: None for the CUDA card, ``"cpu"`` for the plain
    versions."""
    from .engine.pipeline_ext import encode_ext_device_greedy

    if len(dictionary) != (1 << window):
        base = initialize_dictionary(1 << window, literal=literal)
        base[-len(dictionary):] = dictionary
        dictionary = bytes(base)
    return sum(len(b) for b in encode_ext_device_greedy(
        samples, window=window, literal=literal, dictionary=bytes(dictionary),
        device=device))


def find_best_trim_threshold(
    samples: list[bytes],
    *,
    window: int = 10,
    size: int | None = None,
    literal: int = 8,
    extended: bool = True,
    target_fill: float = 1.0,
    thresholds: tuple = (6, 8, 10, 12, 14, 16),
    device=None,
) -> tuple[int, bytearray]:
    """Sweep trim thresholds, measuring the real compressed corpus size
    for each dictionary (the reference's zstd-style sweep,
    build_dictionary.py:426-490); returns (best_threshold, dictionary).
    The expensive corpus scoring pass is shared across the sweep."""
    size = size or (1 << window)
    samples = _clip_samples(samples, window)
    minp = compute_min_pattern_size(window, literal)
    scored = score_substrings(
        samples, window=window, literal=literal, extended=extended,
        multi_frag_min_length=min(min(thresholds), minp + 1))
    best = None
    for th in thresholds:
        d, _eff = _build_pipeline(
            samples, window=window, literal=literal, extended=extended,
            trim_threshold=th, target_fill=target_fill, size=size,
            scored=scored)
        total = evaluate_dictionary_tradeoff(
            samples, bytes(d), window=window, literal=literal, device=device)
        if best is None or total < best[0]:
            best = (total, th, d)
    return best[1], best[2]


def find_knee(results, marginal_fraction: float = 0.5) -> int:
    """Marginal-return knee of a (effective_bytes, compressed_total)
    curve: the last fill level whose compressed-bytes-saved per
    dictionary byte stays above ``marginal_fraction`` of the average
    rate (reference analogue: build_dictionary.py:545-610).  Accepts
    either (size, total) pairs or the legacy two-list form.

    Returns the effective-bytes value at the knee.
    """
    if isinstance(results, tuple):
        results = list(zip(*results))
    if results and not isinstance(results[0], tuple):
        raise TypeError("find_knee takes [(effective_bytes, total), ...]")
    results = sorted(results)
    if len(results) <= 2:
        return results[-1][0]
    xs = [r[0] for r in results]
    ys = [r[1] for r in results]
    total_improvement = ys[0] - ys[-1]
    total_range = xs[-1] - xs[0]
    if total_range <= 0 or total_improvement <= 0:
        return results[-1][0]
    threshold = (total_improvement / total_range) * marginal_fraction
    min_segment = (total_range / (len(results) - 1)) * 0.5
    knee = 0
    for i in range(1, len(results)):
        dx = xs[i] - xs[i - 1]
        if dx < min_segment:
            continue
        if (ys[i - 1] - ys[i]) / dx >= threshold:
            knee = i
    return results[knee][0]


def build_dictionary_from_path(
    corpus: Path,
    *,
    window: int = 10,
    size: int | None = None,
    delimiter: str | None = None,
    trim_threshold: int = 8,
    target_fill: float = 1.0,
    auto_trim: bool = False,
    auto_size: bool = False,
    device=None,
) -> bytearray:
    """CLI helper: corpus directory (one sample per file) or delimited file."""
    corpus = Path(corpus)
    if corpus.is_dir():
        samples = [p.read_bytes() for p in sorted(corpus.iterdir()) if p.is_file()]
    elif delimiter is not None:
        samples = corpus.read_bytes().split(delimiter.encode())
    else:
        samples = [corpus.read_bytes()]
    samples = [s for s in samples if s]
    if not samples:
        raise SystemExit("corpus is empty")
    return build_dictionary(
        samples, window=window, size=size, trim_threshold=trim_threshold,
        target_fill=target_fill, auto_trim=auto_trim, auto_size=auto_size,
        device=device,
    )
