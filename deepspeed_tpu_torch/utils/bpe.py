"""Byte-level BPE tokenizer — trainer + encoder for the real-data
convergence tier (a copy of ``deepspeed_tpu/utils/bpe.py``: the two
packages train the same merges and read each other's saved files).

The reference framework trains its convergence models on pre-tokenized
WebText-style corpora produced by external Megatron tooling; this repo has
zero egress, so it carries its own small tokenizer.  Byte-level (GPT-2
style base alphabet: every byte is a token, so any UTF-8 text round-trips
exactly) with learned merges on top.

Trainer: classic pair-merge BPE over a word-frequency table, but with
*incremental* pair-count maintenance — an inverted index pair -> words
means each merge touches only the words containing that pair, so training
a 4k vocab over a multi-MB corpus takes seconds, not the O(merges x
corpus) of the naive loop.

Encoder: per-word merge-by-rank with an LRU-less dict cache (natural text
repeats words heavily, so the cache hit rate is ~95%+).

No code or vocab is taken from any existing tokenizer; the pre-tokenizer
regex is deliberately simpler than GPT-2's (letters / digits /
punctuation runs, each optionally space-prefixed).
"""
from __future__ import annotations

import json
import re
from collections import Counter
from typing import Dict, Iterable, List, Tuple

# runs of letters, digits, or other-non-space, each absorbing one
# preceding space (the leading-space convention keeps word identity
# stable mid-sentence); bare whitespace runs survive as their own words
_PRETOK = re.compile(r" ?[A-Za-z]+| ?[0-9]+| ?[^ A-Za-z0-9\s]+|\s+")


def _pretokenize(text: str) -> List[bytes]:
    return [m.group(0).encode("utf-8") for m in _PRETOK.finditer(text)]


class ByteBPE:
    """ids 0..255 are raw bytes; id 256+i is the result of ``merges[i]``."""

    def __init__(self, merges: List[Tuple[int, int]]):
        self.merges = [tuple(m) for m in merges]
        self.ranks: Dict[Tuple[int, int], int] = {
            tuple(m): i for i, m in enumerate(self.merges)}
        self._cache: Dict[bytes, Tuple[int, ...]] = {}

    @property
    def vocab_size(self) -> int:
        return 256 + len(self.merges)

    # ---------------- training ----------------

    @classmethod
    def train(cls, text: str, vocab_size: int,
              max_unique_words: int = 200_000) -> "ByteBPE":
        if vocab_size < 257:
            raise ValueError("vocab_size must exceed the 256 byte alphabet")
        word_freq = Counter(_pretokenize(text))
        if len(word_freq) > max_unique_words:
            word_freq = Counter(dict(word_freq.most_common(max_unique_words)))

        words: List[List[int]] = []   # symbol sequence per unique word
        freqs: List[int] = []
        for w, f in word_freq.items():
            words.append(list(w))
            freqs.append(f)

        pair_counts: Counter = Counter()
        pair_words: Dict[Tuple[int, int], set] = {}
        for wi, syms in enumerate(words):
            f = freqs[wi]
            for a, b in zip(syms, syms[1:]):
                pair_counts[(a, b)] += f
                pair_words.setdefault((a, b), set()).add(wi)

        merges: List[Tuple[int, int]] = []
        n_merges = vocab_size - 256
        for step in range(n_merges):
            if not pair_counts:
                break
            # deterministic tie-break on the pair ids themselves
            best = max(pair_counts.items(), key=lambda kv: (kv[1], kv[0]))[0]
            if pair_counts[best] < 2:
                break
            new_id = 256 + len(merges)
            merges.append(best)
            affected = pair_words.pop(best, set())
            pair_counts.pop(best, None)
            for wi in affected:
                syms = words[wi]
                f = freqs[wi]
                out: List[int] = []
                i = 0
                changed = False
                while i < len(syms):
                    if (i + 1 < len(syms)
                            and (syms[i], syms[i + 1]) == best):
                        # retire neighbor pair counts around the merge site
                        if out:
                            _dec(pair_counts, pair_words,
                                 (out[-1], syms[i]), f, wi)
                            _inc(pair_counts, pair_words,
                                 (out[-1], new_id), f, wi)
                        if i + 2 < len(syms):
                            _dec(pair_counts, pair_words,
                                 (syms[i + 1], syms[i + 2]), f, wi)
                            _inc(pair_counts, pair_words,
                                 (new_id, syms[i + 2]), f, wi)
                        out.append(new_id)
                        i += 2
                        changed = True
                    else:
                        out.append(syms[i])
                        i += 1
                if changed:
                    words[wi] = out
        return cls(merges)

    # ---------------- encoding ----------------

    def _bpe_word(self, word: bytes) -> Tuple[int, ...]:
        cached = self._cache.get(word)
        if cached is not None:
            return cached
        syms = list(word)
        while len(syms) > 1:
            best_rank = None
            best_i = -1
            for i in range(len(syms) - 1):
                r = self.ranks.get((syms[i], syms[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_i = r, i
            if best_rank is None:
                break
            syms[best_i:best_i + 2] = [256 + best_rank]
        out = tuple(syms)
        if len(self._cache) < 1 << 20:
            self._cache[word] = out
        return out

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for word in _pretokenize(text):
            ids.extend(self._bpe_word(word))
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        # expand merge ids back to byte sequences
        expand: Dict[int, bytes] = {}

        def to_bytes(i: int) -> bytes:
            if i < 256:
                return bytes([i])
            got = expand.get(i)
            if got is None:
                a, b = self.merges[i - 256]
                got = to_bytes(a) + to_bytes(b)
                expand[i] = got
            return got

        return b"".join(to_bytes(int(i)) for i in ids).decode(
            "utf-8", errors="replace")

    # ---------------- persistence ----------------

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"format": "deepspeed_tpu-bytebpe-v1",
                       "merges": [list(m) for m in self.merges]}, f)

    @classmethod
    def load(cls, path: str) -> "ByteBPE":
        with open(path) as f:
            blob = json.load(f)
        if blob.get("format") != "deepspeed_tpu-bytebpe-v1":
            raise ValueError(f"{path} is not a ByteBPE vocab file")
        return cls([tuple(m) for m in blob["merges"]])


def _inc(counts, index, pair, f, wi):
    counts[pair] += f
    index.setdefault(pair, set()).add(wi)


def _dec(counts, index, pair, f, wi):
    left = counts.get(pair)
    if left is None:
        return
    left -= f
    if left <= 0:
        counts.pop(pair, None)
        # the word may still contain the pair elsewhere; cheap to keep the
        # index entry — a stale wi is skipped naturally when re-scanned
    else:
        counts[pair] = left
