"""Seeded edge-case slot tables for the consensus DP and the backtrack.

Small synthetic chunks (W <= 256) that reach what chunks of real windows do
not: slot counts K that are no tier, window counts B that fill no warp and no
block, widths and spans that are no multiple of a staged tile (span 0 and
span = W among them, different spans side by side), columns full to K live
slots, same-column (insertion) chains several levels deep, ties between gap
and non-gap predecessors, chains that sink below NEG_INF - 1, invalid slots
whose query does match a predecessor (their besti is part of the kernels'
output), invalid slots whose query decodes to the -7 sentinel, invalid same-column
slots that sit before their target (which the _pick reduction of the base and
dynamic-K formulations matches and the running pick does not), seeded and
unseeded windows at every lead. numpy and a seed only: the CPU tests hold the
plain twins to the JAX package on these tables, and the smoke run on the card
holds the kernels to the twins on the same tables.

A table is made the way real ones are: reads (token sequences over a few
bases, with substitutions and insertion runs) are cut into 3-mers, each 3-mer
is filed under the column of its last token, and a column's distinct 3-mers
become its slots, ordered by the insertion level of that token, with their
read counts. Key layout (pipeline.windows): delta<<16 | flags<<12 | q1<<8 |
q2<<4 | q3, flag bit 0 = b2 and b3 share a column, bit 2 = b1 and b2 do; -1
is an empty slot, any negative key an invalid one.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

HEAD_Q = 15
GAP = 4
F23, F12 = 0b0001, 0b0100


class DpCase(NamedTuple):
    name: str
    key: np.ndarray       # int32 [B, W, K]
    cnt: np.ndarray       # int32 [B, W, K]
    cov: np.ndarray       # int32 [B, W]
    lead: np.ndarray      # int32 [B]
    seed: np.ndarray      # bool [B]
    span: np.ndarray      # int32 [B]; every key at or past it is -1
    last_col: np.ndarray  # int32 [B]: span - 1, and past W where asked


def pack_key(delta: int, flags: int, q1: int, q2: int, q3: int) -> int:
    """The packed 3-mer key as a Python int in int32 range."""
    k = (delta << 16) | (flags << 12) | (q1 << 8) | (q2 << 4) | q3
    return k - (1 << 32) if k >= (1 << 31) else k


def key_level(k: int) -> int:
    """Insertion level of a key's last base (b3-delta): slots of a column
    are ordered by it."""
    flags = (k >> 12) & 0xF
    if flags & (F23 | F12) == (F23 | F12):
        return ((k >> 16) & 0xFFFF) + 2
    return flags & F23


def _kmer_key(t1, t2, t3) -> tuple:
    """Tokens (column, level, base) of one 3-mer -> (column, key). A missing
    token (None) is the head marker."""
    c, d3, q3 = t3
    q2 = HEAD_Q if t2 is None else t2[2]
    q1 = HEAD_Q if t1 is None else t1[2]
    if t2 is None or t1 is None:
        # a read's first two 3-mers: plain flags, no delta
        return c, pack_key(0, 0, q1, q2, q3)
    d2, d1 = t2[1], t1[1]
    if d3 >= 2:
        return c, pack_key(d3 - 2, F23 | F12, q1, q2, q3)
    if d3 == 1:
        return c, pack_key(d1, F23, q1, q2, q3)
    if d2 > 0:
        return c, pack_key(d2 - 1, F12, q1, q2, q3)
    return c, pack_key(d1, 0, q1, q2, q3)


def _window(rng, W: int, K: int, span: int, *, reads: int, err: float,
            p_ins: float, max_ins: int, bases: int, p_gap: float,
            p_late: float, cold: bool, count_max: int):
    """Slot tables of one window: key, cnt int32 [W, K], cov int32 [W]."""
    cols = [dict() for _ in range(W)]       # key -> count
    truth = rng.integers(0, bases, size=span)
    ins_truth = [tuple(rng.integers(0, bases, size=rng.integers(1, max_ins + 1)))
                 if rng.random() < p_ins else () for _ in range(span)]
    for _ in range(reads):
        start = int(rng.integers(1, max(span - 2, 2))) \
            if span > 4 and rng.random() < p_late else 0
        tokens = []
        for c in range(start, span):
            base = int(truth[c])
            r = rng.random()
            if r < err:
                base = int(rng.integers(0, bases))
            elif r < err + p_gap:
                base = GAP
            tokens.append((c, 0, base))
            run = ins_truth[c]
            if run and rng.random() < err:
                run = run[: int(rng.integers(0, len(run) + 1))]
            elif not run and rng.random() < err * p_ins:
                run = (int(rng.integers(0, bases)),)
            tokens += [(c, d + 1, int(q)) for d, q in enumerate(run)]
        weight = int(rng.integers(1, count_max + 1))
        # a late read starts cold (its first 3-mer has no predecessor and no
        # head marker) or with the head markers of a read's true start
        skip = 2 if (cold and start > 0) else 0
        for n in range(skip, len(tokens)):
            t1 = tokens[n - 2] if n >= 2 else None
            t2 = tokens[n - 1] if n >= 1 else None
            c, k = _kmer_key(t1, t2, tokens[n])
            cols[c][k] = cols[c].get(k, 0) + weight
    key = np.full((W, K), -1, np.int32)
    cnt = np.zeros((W, K), np.int32)
    for c, col in enumerate(cols):
        slots = sorted(col.items(), key=lambda kv: (key_level(kv[0]), kv[0]))
        for i, (k, n) in enumerate(slots[:K]):
            key[c, i] = k
            cnt[c, i] = n
    return key, cnt


def _plant_invalid(rng, key, cnt, span: int, later: bool = False) -> None:
    """Invalid (negative) keys in free slots of one window, in place.

    prev-pool trap: a valid f12 key of delta 0x7FFF in column c-1 and an
    invalid plain key of delta 0x8000 in column c whose (b1, b2) equal the
    former's (b2, b3): the invalid slot's pick matches, so its besti is the
    former's slot. same-column trap: the same pair inside one column, the
    invalid key carrying flag bit 0; with `later` the invalid key takes the
    slot BEFORE its target, which then matches only in the formulations
    whose same-column pool holds all K slots. sentinel: an invalid key whose b1 decodes
    to -7 (column 0 with f12, column 1 with plain flags). noise: random
    negative keys."""
    W, K = key.shape
    free = lambda c: np.nonzero(key[c] == -1)[0]  # noqa: E731

    def put(c, k, n=0):
        i = free(c)[0]
        key[c, i], cnt[c, i] = k, n

    for c in range(3, span):
        r = rng.random()
        a, b, q = (int(x) for x in rng.integers(0, 4, size=3))
        if r < 0.15 and len(free(c - 1)) >= 1 and len(free(c)) >= 1:
            put(c - 1, pack_key(0x7FFF, F12, a, b, q), 1)
            put(c, pack_key(0x8000, 0, b, q, a))
        elif r < 0.30 and len(free(c)) >= 2:
            pair = [(pack_key(0x7FFF, F12, a, b, q), 1),
                    (pack_key(0x8000, F23, b, q, a), 0)]
            for k, n in pair[::-1] if later else pair:
                put(c, k, n)
        elif r < 0.45 and len(free(c)) >= 1:
            put(c, int(rng.integers(-(1 << 31), 0)))
    if span > 1:
        if len(free(0)):
            put(0, pack_key(0xFFFF, F12, 9, 1, 2))
        if len(free(1)):
            put(1, pack_key(0xFFFF, 0, 9, 2, 3))


def _coverage(key, cnt):
    """Per-column coverage as the chunk program counts it: the counts of the
    slots whose flag bit 0 is clear."""
    return np.where(((key >> 12) & 1) == 0, cnt, 0).sum(-1).astype(np.int32)


def make_case(name: str, seed: int, K: int, B: int, W: int, spans, *,
              reads: int = 6, err: float = 0.15, p_ins: float = 0.1,
              max_ins: int = 2, bases: int = 4, p_gap: float = 0.05,
              p_late: float = 0.2, cold: bool = False, count_max: int = 3,
              invalid: bool = False, later: bool = False,
              past_w: bool = False) -> DpCase:
    """One chunk. `spans` (one per window, cycled) are clamped to [0, W];
    window b has lead b % 4 and is seeded when (b // 4) % 2 == 1, so every
    lead meets both."""
    rng = np.random.default_rng(seed)
    span = np.array([min(max(int(spans[b % len(spans)]), 0), W)
                     for b in range(B)], np.int32)
    key = np.full((B, W, K), -1, np.int32)
    cnt = np.zeros((B, W, K), np.int32)
    for b in range(B):
        if span[b] == 0:
            continue
        key[b], cnt[b] = _window(
            rng, W, K, int(span[b]), reads=reads, err=err, p_ins=p_ins,
            max_ins=max_ins, bases=bases, p_gap=p_gap, p_late=p_late,
            cold=cold, count_max=count_max)
        if invalid or later:
            _plant_invalid(rng, key[b], cnt[b], int(span[b]), later)
    lead = (np.arange(B) % 4).astype(np.int32)
    seeded = (np.arange(B) // 4) % 2 == 1
    last_col = span - 1
    if past_w:
        last_col = last_col.copy()
        last_col[0] = W + 50
    return DpCase(name, key, cnt, _coverage(key, cnt), lead, seeded, span,
                  last_col.astype(np.int32))


# the walks are taken at each of these step limits; None stands for W + 128
BACKTRACK_MAX_STEPS = (0, 1, 7, None)

_CASES = {
    # K, B, W, spans, options
    "k1_odd_width": (1, 5, 37, [37, 0, 20, 36, 1],
                     dict(reads=3, err=0.05, p_ins=0.0)),
    "k5_three_windows": (5, 3, 70, [70, 33, 64], dict(reads=8, err=0.2)),
    "k8_130_windows": (8, 130, 40, [40, 0, 17, 32, 33, 1, 39, 8, 25],
                       dict(reads=4, past_w=True)),
    "k8_unaligned_rows": (8, 5, 45, [45, 31, 0, 44, 12], dict(reads=6)),
    "k8_deep_insertions": (8, 5, 96, [96, 90, 65, 96, 7],
                           dict(reads=10, err=0.1, p_ins=0.35, max_ins=6)),
    "k8_full_columns": (8, 3, 48, [48, 47, 40],
                        dict(reads=40, err=0.5, p_ins=0.3, max_ins=3)),
    "k16_gap_ties": (16, 3, 64, [64, 50, 63],
                     dict(reads=12, err=0.2, bases=2, p_gap=0.3,
                          count_max=1)),
    "k8_below_neg_inf": (8, 5, 80, [80, 77, 80, 33, 80],
                         dict(reads=8, p_late=0.6, cold=True, count_max=1)),
    "k8_invalid_slots": (8, 6, 64, [64, 60, 64, 31, 64, 2],
                         dict(reads=3, err=0.1, invalid=True)),
    "k8_wide": (8, 5, 256, [256, 200, 129, 255, 64], dict(reads=5)),
    "k33_two_slots_a_lane": (33, 3, 33, [33, 32, 20],
                             dict(reads=60, err=0.5, p_ins=0.3, max_ins=4,
                                  invalid=True)),
    "k48_full_columns": (48, 2, 24, [24, 23],
                         dict(reads=150, err=0.6, p_ins=0.4, max_ins=5,
                              bases=4, p_gap=0.15)),
    "k64_full_columns": (64, 1, 20, [20],
                         dict(reads=220, err=0.6, p_ins=0.4, max_ins=5,
                              bases=4, p_gap=0.15)),
    "k8_later_targets": (8, 6, 72, [72, 65, 72, 30, 72, 3],
                         dict(reads=3, err=0.1, later=True)),
}
CASE_NAMES = tuple(_CASES)


def edge_case(name: str) -> DpCase:
    """The named case; the same table on every call (the seed is the case's
    place in CASE_NAMES)."""
    K, B, W, spans, opts = _CASES[name]
    return make_case(name, 1000 + CASE_NAMES.index(name), K, B, W, spans,
                     **opts)


def edge_cases() -> list:
    return [edge_case(name) for name in CASE_NAMES]


def step_limits(W: int) -> list:
    return [W + 128 if m is None else m for m in BACKTRACK_MAX_STEPS]


def case_tensors(case: DpCase, device="cpu") -> tuple:
    """(key, cnt, cov, lead, seed u8, span, last_col) of a case as tensors
    on `device`."""
    import torch

    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (case.key, case.cnt, case.cov, case.lead,
                           case.seed.astype(np.uint8), case.span,
                           case.last_col))


def exact_n_slots(key: np.ndarray) -> np.ndarray:
    """The slot bound of every column, int32 [B, W], as the host aggregation
    would give it: the count of valid keys; where a valid key sits behind an
    invalid one (k8_later_targets) no count of valid keys bounds the slots,
    and the bound is the index of the column's last non-empty slot plus one.
    With it a per-window bound and a bound shared by several windows compute
    the same slots."""
    K = key.shape[-1]
    valid = key >= 0
    count = valid.sum(-1)
    leading = valid[..., ::-1].argmax(-1) == K - count  # valid keys come first
    nonempty = key != -1
    last = np.where(nonempty.any(-1), K - nonempty[..., ::-1].argmax(-1), 0)
    return np.where(leading | (count == 0), count, last).astype(np.int32)


def mangled_n_slots(case: DpCase) -> np.ndarray:
    """A seeded n_slots that is wrong column by column: exact, short by one,
    0, negative, or above K. The dynamic-K kernel takes it as given."""
    K = case.key.shape[-1]
    exact = exact_n_slots(case.key)
    rng = np.random.default_rng(5000 + CASE_NAMES.index(case.name)
                                if case.name in CASE_NAMES else 4999)
    how = rng.integers(0, 5, size=exact.shape)
    wrong = np.stack([exact, exact - 1, np.zeros_like(exact),
                      -rng.integers(1, 1 << 20, size=exact.shape),
                      K + rng.integers(1, 1 << 20, size=exact.shape)])
    return np.take_along_axis(wrong, how[None], 0)[0].astype(np.int32)


def check_kernels(case: DpCase, device) -> dict:
    """All four kernels against their plain twins on one case on `device` (a
    CUDA device), every output bit: consensus_dp_v2, consensus_dp_base,
    consensus_dp_dynk under the exact and under a mangled n_slots, and
    backtrack_packed at every step limit; raises AssertionError on a
    difference or a missing launch. Returns what the case held."""
    import torch

    from ..ops import consensus_cuda as cc

    B, W, K = case.key.shape
    key, cnt, cov, lead, seed8, span, last_col = case_tensors(case, device)
    before = dict(cc.LAUNCHES)

    def same(what, got, want):
        torch.cuda.synchronize(device)
        for part, g, w in zip(("scores", "besti"), got, want):
            if not torch.equal(g, w):
                raise AssertionError(f"{case.name}: {what} {part} differ from "
                                     f"the twin's ({int((g != w).sum())} "
                                     "elements)")

    sk, bk = cc.consensus_dp_v2(key, cnt, cov, lead, seed8, span)
    same("DP", (sk, bk), cc.consensus_dp_plain(key, cnt, cov, lead, seed8,
                                               span))
    same("base DP", cc.consensus_dp_base(key, cnt, cov, lead, seed8),
         cc.consensus_dp_base_plain(key, cnt, cov, lead, seed8))
    for what, ns in (("exact", exact_n_slots(case.key)),
                     ("mangled", mangled_n_slots(case))):
        ns = torch.from_numpy(ns).to(device)
        same(f"dynamic-K DP ({what} n_slots)",
             cc.consensus_dp_dynk(key, cnt, cov, ns, lead, seed8),
             cc.consensus_dp_dynk_plain(key, cnt, cov, ns, lead, seed8))
    limits = step_limits(W)
    steps_max = alive_at_limit = died_at_once = 0
    for max_steps in limits:
        ok = cc.backtrack_packed(key, cnt, cov, sk, bk, last_col, seed8,
                                 max_steps)
        op = cc.backtrack_plain(key, cnt, cov, sk, bk, last_col, seed8,
                                max_steps)
        torch.cuda.synchronize(device)
        if not torch.equal(ok, op):
            raise AssertionError(f"{case.name}: packed walk differs from the "
                                 f"twin's at max_steps={max_steps}")
        n_steps = ok[:, max_steps + 2].to(torch.int32) & 0xFFFF
        steps_max = max(steps_max, int(n_steps.max()))
        alive_at_limit += int(ok[:, max_steps + 4].sum())
        if max_steps > 1:
            died_at_once += int((n_steps == 1).sum())
    for name, n in (("consensus_dp_v2", 1), ("consensus_dp_base", 1),
                    ("consensus_dp_dynk", 2),
                    ("backtrack_packed", len(limits))):
        if cc.LAUNCHES[name] != before.get(name, 0) + n:
            raise AssertionError(f"{case.name}: {name} was not launched")
    return {"case": case.name, "K": K, "B": B, "W": W,
            "span_max": int(case.span.max()), "walk_steps_max": steps_max,
            "walks_alive_at_limit": alive_at_limit,
            "walks_dead_at_step_1": died_at_once}
