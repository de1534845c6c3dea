"""Hand-written CUDA kernels of the chunk program, their plain PyTorch
twins, and the loader and launch counters of every kernel of the package
(the k-mer table kernels' wrappers live in ops/kmer_table.py and
ops/kmer_score.py).

consensus_dp_v2 replaces the Pallas kernel
nextpolish2_tpu/ops/consensus_pallas.py::_dp_kernel_v2 (span-bounded,
launched at consensus_dp_pallas), source csrc/consensus_dp.cu.
consensus_dp_base replaces _dp_kernel (the reference formulation, a _pick
reduction per slot), source csrc/consensus_dp_base.cu; consensus_dp_dynk
replaces _dp_kernel_dynk (the same reduction with the slot loop bounded by
n_slots), source csrc/consensus_dp_dynk.cu. Neither has a span bound.
backtrack_packed replaces the XLA scan
nextpolish2_tpu/ops/consensus.py::_backtrack_scan_packed (with
_backtrack_state_tables, _backtrack_start and pack_backtrack_out), source
csrc/backtrack.cu.

Build: `nvcc -gencode arch=compute_90a,code=sm_90a -shared` of each source
into a plain-C shared library under the package's _build/ directory at first
use (all sources compiled in parallel), loaded with ctypes; pointers and the
current stream go in as integers. No PyTorch headers, so a build takes
seconds.

Dispatch: a wrapper given CPU tensors runs the plain twin; given CUDA
tensors it launches the kernel or raises. It never falls back. Every launch
adds one to LAUNCHES[name] (and SHAPE_LAUNCHES[(name, *shape)]), so a run
can prove which path it took. The counters are shared by every thread of the
process and are updated under one lock.
"""

from __future__ import annotations

import collections
import ctypes
import os
import shutil
import subprocess
import threading
import time

import torch

from ..utils.timing import stage
from .consensus import (HEAD_Q, NEG_INF, backtrack_start,
                        backtrack_state_tables, decode_keys,
                        pack_backtrack_out)

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = {"consensus_dp": "consensus_dp.cu",
           "consensus_dp_base": "consensus_dp_base.cu",
           "consensus_dp_dynk": "consensus_dp_dynk.cu",
           "backtrack": "backtrack.cu",
           "kmer_lookup": "kmer_lookup.cu",    # wrapper: ops/kmer_table.py
           "kmer_score": "kmer_score.cu"}      # wrapper: ops/kmer_score.py
# a change to one rebuilds every source
HEADERS = ("dp_common.cuh", "kmer_common.cuh")
# C entry point np2t_<name>: (pointer arguments, int arguments) before the
# stream pointer
_ARGS = {"consensus_dp": (8, 3), "consensus_dp_base": (7, 3),
         "consensus_dp_dynk": (8, 3), "backtrack": (8, 4),
         "kmer_lookup": (5, 4), "kmer_lookup_sharded": (6, 5),
         "kmer_score": (4, 7)}
# entry points beyond a library's own np2t_<source name>: their library
_LIB_OF = {"kmer_lookup_sharded": "kmer_lookup"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
K_MAX = 64  # the kernels' slot bound (uint64 slot masks, two slots a lane)

LAUNCHES: dict = collections.Counter()
SHAPE_LAUNCHES: dict = collections.Counter()
BUILD_INFO: dict = {}  # name -> {"seconds", "log"} of this process's builds

_libs: dict = {}
_fns: dict = {}                 # name -> the C entry point, resolved once
_lock = threading.Lock()        # builds and library loads
_count_lock = threading.Lock()  # LAUNCHES, SHAPE_LAUNCHES


def reset_counts() -> None:
    with _count_lock:
        LAUNCHES.clear()
        SHAPE_LAUNCHES.clear()


def _count(name: str, shape=None) -> None:
    with _count_lock:
        LAUNCHES[name] += 1
        if shape is not None:
            SHAPE_LAUNCHES[(name, *shape)] += 1


def _launch(name: str, shape, fn, *args) -> None:
    """Launch through the C entry point `fn`, raise on a refused launch,
    count it, per shape too: (K, B, W) for the chunk kernels, the
    power-of-two bucket of the work size (floor 4096) for the k-mer ones."""
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    _count(name, shape)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME)")
    return found


def _so_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"libnp2t_{name}.so")


def _stale(name: str) -> bool:
    try:
        built = os.path.getmtime(_so_path(name))
        return any(os.path.getmtime(os.path.join(CSRC, f)) > built
                   for f in (SOURCES[name], *HEADERS))
    except OSError:
        return True


def build_kernels(force: bool = False) -> dict:
    """Compile every kernel source that is missing or stale, one nvcc
    process per source, all started together. Returns BUILD_INFO. Raises
    with the compiler's output when a build fails."""
    with _lock:
        names = [n for n in SOURCES if force or _stale(n)]
        if not names:
            return BUILD_INFO
        os.makedirs(BUILD_DIR, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        t0 = time.time()
        for n in names:
            tmp = f"{_so_path(n)}.{os.getpid()}.tmp"
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, SOURCES[n])]
            procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                              stderr=subprocess.STDOUT))
        failed = []
        for n, (tmp, p) in procs.items():
            log = p.communicate()[0].decode(errors="replace")
            if p.returncode != 0:
                failed.append(f"{SOURCES[n]}:\n{log}")
                continue
            os.replace(tmp, _so_path(n))
            BUILD_INFO[n] = {"seconds": time.time() - t0, "log": log}
            _libs.pop(n, None)
            for entry in [e for e in _fns if _LIB_OF.get(e, e) == n]:
                del _fns[entry]
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
        return BUILD_INFO


def _lib(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with stage("kernel_build." + name):  # the load, and a build it needs
        build_kernels()
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = _libs[name] = ctypes.CDLL(_so_path(name))
    return lib


def _fn(name: str):
    """The C entry point np2t_<name>, built and loaded at first use."""
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_lib(_LIB_OF.get(name, name)), f"np2t_{name}")
        fn.restype = ctypes.c_int
        n_ptr, n_int = _ARGS[name]
        fn.argtypes = [ctypes.c_void_p] * n_ptr \
            + [ctypes.c_int] * n_int + [ctypes.c_void_p]
        _fns[name] = fn
    return fn


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


# --------------------------------------------------------------------------
# consensus DP


def _check_dp(name: str, key, cnt, cov, lead, seed):
    """Shared argument checks of the DP wrappers (CUDA tensors only).
    Returns (B, W, K, device)."""
    if key.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {key.device}")
    B, W, K = key.shape
    if not 1 <= K <= K_MAX:
        raise ValueError(f"{name}: K={K} outside 1..{K_MAX}")
    dev = key.device
    _check(key, "key", torch.int32, (B, W, K), dev)
    _check(cnt, "cnt", torch.int32, (B, W, K), dev)
    _check(cov, "cov", torch.int32, (B, W), dev)
    _check(lead, "lead", torch.int32, (B,), dev)
    _check(seed, "seed", torch.uint8, (B,), dev)
    return B, W, K, dev


def _dp_outputs(B: int, W: int, K: int, dev):
    return (torch.empty((B, W, K), dtype=torch.int32, device=dev),
            torch.empty((B, W, K), dtype=torch.int8, device=dev))


def consensus_dp_v2(key, cnt, cov, lead, seed, span):
    """Windowed Viterbi DP: key/cnt int32 [B, W, K], cov int32 [B, W],
    lead/span int32 [B], seed uint8 [B] -> (scores int32 [B, W, K], besti
    int8 [B, W, K]). Columns at or past a window's span hold NEG_INF / 0.
    CPU tensors: the plain twin; CUDA tensors: the kernel."""
    if key.device.type == "cpu":
        return consensus_dp_plain(key, cnt, cov, lead, seed, span)
    B, W, K, dev = _check_dp("consensus_dp_v2", key, cnt, cov, lead, seed)
    _check(span, "span", torch.int32, (B,), dev)
    scores, besti = _dp_outputs(B, W, K, dev)
    fn = _fn("consensus_dp")
    with torch.cuda.device(dev):
        _launch("consensus_dp_v2", (K, B, W), fn, key.data_ptr(),
                cnt.data_ptr(), cov.data_ptr(), lead.data_ptr(),
                seed.data_ptr(), span.data_ptr(), scores.data_ptr(),
                besti.data_ptr(), B, W, K,
                torch.cuda.current_stream(dev).cuda_stream)
    return scores, besti


def _pick(m, s_j, nongap_j):
    """Vectorized form of the kernel's running pick over predecessors j
    (ascending): take = m & (cand > best | cand == best & nongap_j), best
    starting at NEG_INF-1 and j at 0. m [B, Ki, Kj]; s_j, nongap_j [B, Kj].
    Returns (best, j, has) over [B, Ki]."""
    neg1 = NEG_INF - 1
    K = m.shape[-1]
    cand = torch.where(m, s_j[:, None, :], neg1)
    best = cand.amax(-1)
    ismax = m & (cand == best[..., None])
    nonmax = ismax & nongap_j[:, None, :]
    jlast = (K - 1) - nonmax.flip(-1).to(torch.uint8).argmax(-1)
    jfirst = ismax.to(torch.uint8).argmax(-1)
    # the first strict improvement wins; at best == NEG_INF-1 only non-gap
    # ties ever take, so the pick keeps its initial 0
    jfirst = torch.where(best > neg1, jfirst, 0)
    j = torch.where(nonmax.any(-1), jlast, jfirst)
    has = m.any(-1)
    return best, torch.where(has, j, 0), has


def consensus_dp_plain(key, cnt, cov, lead, seed, span):
    """Plain twin of the consensus_dp_v2 kernel, vectorized over windows
    and the predecessor axis, one Python step per column. Same-column
    predecessors are resolved level by level (a slot of insertion level l
    matches only level l-1 slots, which precede it in slot order) up to the
    column's actual max level, so no level cap applies; invalid same-column
    slots get their (never followed) besti from a final pass, as the kernel's
    in-order pick gives them."""
    _count("consensus_dp_plain")
    B, W, K = key.shape
    dev = key.device
    i32 = torch.int32
    col = torch.arange(W, dtype=i32, device=dev).view(1, W, 1)
    b1key, b2key, b3key, q1, q2, _q3, b3d = decode_keys(key, col)
    valid = key >= 0
    b2m = torch.where(valid, b2key, -7)
    b3m = torch.where(valid, b3key, -8)
    b1head = q1 == HEAD_Q
    b1nongap = q1 != 4
    b2head = q2 == HEAD_Q
    same = ((key >> 12) & 1) != 0
    gains = 10 * cnt - 4 * cov[:, :, None]
    cols = torch.arange(W, dtype=i32, device=dev)
    colge3 = (lead.to(i32)[:, None] + cols[None, :]) >= 3          # [B, W]
    active = cols[None, :] < span.to(i32)[:, None]                 # [B, W]
    seeded = seed.to(torch.bool)
    lvl = torch.where(valid & same, b3d, 0)
    n_cols = int(min(W, max(int(span.max()), 0))) if B else 0
    lvl_max = lvl[:, :n_cols].amax(dim=(0, 2)).tolist() if n_cols else []
    jlt = torch.ones((K, K), dtype=torch.bool, device=dev).tril(-1)  # j < i

    scores = torch.full((B, W, K), NEG_INF, dtype=i32, device=dev)
    besti = torch.zeros((B, W, K), dtype=torch.int8, device=dev)
    p_sc = torch.full((B, K), NEG_INF, dtype=i32, device=dev)
    p_b2 = torch.full((B, K), -7, dtype=i32, device=dev)
    p_b3 = torch.full((B, K), -8, dtype=i32, device=dev)
    p_head = torch.zeros((B, K), dtype=torch.bool, device=dev)
    p_nongap = torch.zeros((B, K), dtype=torch.bool, device=dev)
    neg = torch.full((B, K), NEG_INF, dtype=i32, device=dev)
    for c in range(n_cols):
        g = colge3[:, c, None]
        b1, b2 = b1key[:, c], b2key[:, c]
        v_c, use_c, gain = valid[:, c], same[:, c], gains[:, c]
        h2 = b2head[:, c]

        def score(best, has):
            s = torch.where(h2, gain, torch.where(has, best + gain, neg))
            return torch.where(v_c, s, neg)

        # prev-column predecessors (slots without the same-column flag)
        m = ((p_b2[:, None, :] == b1[:, :, None])
             & (p_b3[:, None, :] == b2[:, :, None])
             & ~(p_head & g)[:, None, :])
        best, j, has = _pick(m, p_sc, p_nongap)
        s = torch.where(use_c, neg, score(best, has))
        bi = torch.where(use_c, 0, j)
        # same-column predecessors: earlier slots of this column
        mc = ((b2m[:, c][:, None, :] == b1[:, :, None])
              & (b3m[:, c][:, None, :] == b2[:, :, None])
              & ~(b1head[:, c] & g)[:, None, :] & jlt)
        nongap_c = b1nongap[:, c]
        for level in range(1, int(lvl_max[c]) + 1):
            best, j, has = _pick(mc, s, nongap_c)
            sel = use_c & v_c & (lvl[:, c] == level)
            s = torch.where(sel, score(best, has), s)
            bi = torch.where(sel, j, bi)
        _best, j, _has = _pick(mc, s, nongap_c)
        bi = torch.where(use_c & ~v_c, j, bi)
        out = torch.where(seeded[:, None] & v_c & (c == 2), 0, s)
        act = active[:, c, None]
        scores[:, c] = torch.where(act, out, neg)
        besti[:, c] = torch.where(act, bi, 0).to(torch.int8)
        p_sc, p_b2, p_b3 = out, b2m[:, c], b3m[:, c]
        p_head, p_nongap = b1head[:, c], nongap_c
    return scores, besti


# --------------------------------------------------------------------------
# consensus DP, base and dynamic-K formulations (the _pick reduction)


def consensus_dp_base(key, cnt, cov, lead, seed):
    """The DP in its base formulation (Pallas _dp_kernel): per slot a _pick
    reduction over the predecessor pool, all W columns, no span bound. Same
    arguments and outputs as consensus_dp_v2 without span. CPU tensors: the
    plain twin; CUDA tensors: the kernel."""
    if key.device.type == "cpu":
        return consensus_dp_base_plain(key, cnt, cov, lead, seed)
    B, W, K, dev = _check_dp("consensus_dp_base", key, cnt, cov, lead, seed)
    scores, besti = _dp_outputs(B, W, K, dev)
    fn = _fn("consensus_dp_base")
    with torch.cuda.device(dev):
        _launch("consensus_dp_base", (K, B, W), fn, key.data_ptr(),
                cnt.data_ptr(), cov.data_ptr(), lead.data_ptr(),
                seed.data_ptr(), scores.data_ptr(), besti.data_ptr(),
                B, W, K, torch.cuda.current_stream(dev).cuda_stream)
    return scores, besti


def consensus_dp_dynk(key, cnt, cov, n_slots, lead, seed):
    """The DP in its dynamic-K formulation (Pallas _dp_kernel_dynk): the
    base formulation with each column's slot loop bounded by the window's
    own n_slots[b, c] (int32 [B, W]); slots from the bound on keep NEG_INF /
    0. n_slots is taken as given. CPU tensors: the plain twin; CUDA
    tensors: the kernel."""
    if key.device.type == "cpu":
        return consensus_dp_dynk_plain(key, cnt, cov, n_slots, lead, seed)
    B, W, K, dev = _check_dp("consensus_dp_dynk", key, cnt, cov, lead, seed)
    _check(n_slots, "n_slots", torch.int32, (B, W), dev)
    scores, besti = _dp_outputs(B, W, K, dev)
    fn = _fn("consensus_dp_dynk")
    with torch.cuda.device(dev):
        _launch("consensus_dp_dynk", (K, B, W), fn, key.data_ptr(),
                cnt.data_ptr(), cov.data_ptr(), n_slots.data_ptr(),
                lead.data_ptr(), seed.data_ptr(), scores.data_ptr(),
                besti.data_ptr(), B, W, K,
                torch.cuda.current_stream(dev).cuda_stream)
    return scores, besti


def _pick_reduce(m, s_j, nongap_j):
    """The _pick reduction of consensus_pallas.py (:53-66) over the last
    axis (the predecessor rows j): rows that do not match enter the max as
    NEG_INF-1; ismax = m & (score == max); the pick is the LAST max whose
    predecessor is a non-gap, else the FIRST max; has = any(ismax), NOT
    any(m): a pool whose matching scores all lie below NEG_INF-1 reports
    has = False. Returns (max, j, has) over the leading axes."""
    K = m.shape[-1]
    cand = torch.where(m, s_j, NEG_INF - 1)
    maxv = cand.amax(-1)
    ismax = m & (cand == maxv[..., None])
    jidx = torch.arange(K, device=m.device)
    jfirst = torch.where(ismax, jidx, K).amin(-1)
    jlastn = torch.where(ismax & nongap_j, jidx, -1).amax(-1)
    has = ismax.any(-1)
    j = torch.where(jlastn >= 0, jlastn, jfirst)
    return maxv, torch.where(has, j, 0), has


def _dp_reduce_columns(key, cnt, cov, lead, seed, n_slots):
    """The column scan shared by the base and dynamic-K twins, vectorized
    over windows, one Python step per column. Slot i reduces the previous
    column's pool, or with the same-column flag the pool of ALL slots of
    this column at their scores as of step i (final before i, NEG_INF from
    i on). The previous-column picks do not depend on the step and are
    taken for every slot at once; the same-column picks run in slot order
    over the slots some window needs; invalid same-column slots, whose
    scores stay NEG_INF whatever they pick, take their besti from one last
    pass. n_slots (dynamic-K) bounds the computed slots of each column:
    slots from the bound on keep NEG_INF / 0. A column whose keys are all
    the empty-slot key -1 only hands on its carry: a key of -1 has the
    same-column flag and a query (q1 = 15) that no target of -7 can equal,
    so every pick there is empty."""
    B, W, K = key.shape
    dev = key.device
    i32 = torch.int32
    col = torch.arange(W, dtype=i32, device=dev).view(1, W, 1)
    b1key, b2key, b3key, q1, q2, _q3, _b3d = decode_keys(key, col)
    valid = key >= 0
    b2m = torch.where(valid, b2key, -7)
    b3m = torch.where(valid, b3key, -8)
    b1head = q1 == HEAD_Q
    b1nongap = q1 != 4
    b2head = q2 == HEAD_Q
    same = ((key >> 12) & 1) != 0
    gains = 10 * cnt - 4 * cov[:, :, None]
    cols = torch.arange(W, dtype=i32, device=dev)
    colge3 = (lead.to(i32)[:, None] + cols[None, :]) >= 3          # [B, W]
    seeded = seed.to(torch.bool)
    jidx = torch.arange(K, device=dev)
    if n_slots is None:
        computed = torch.ones((B, W, K), dtype=torch.bool, device=dev)
    else:
        computed = jidx.view(1, 1, K) < n_slots.clamp(0, K)[:, :, None]
    any_key = (key != -1).any(2).any(0).tolist() if B else [False] * W
    live_all = same & valid & computed
    live_slots = live_all.any(0)                                   # [W, K]

    scores = torch.full((B, W, K), NEG_INF, dtype=i32, device=dev)
    besti = torch.zeros((B, W, K), dtype=torch.int8, device=dev)
    neg = torch.full((B, K), NEG_INF, dtype=i32, device=dev)

    p_sc = neg
    p_b2 = torch.full((B, K), -7, dtype=i32, device=dev)
    p_b3 = torch.full((B, K), -8, dtype=i32, device=dev)
    p_head = torch.zeros((B, K), dtype=torch.bool, device=dev)
    p_nongap = torch.zeros((B, K), dtype=torch.bool, device=dev)
    for c in range(W):
        if not any_key[c]:
            p_sc, p_b2, p_b3 = neg, b2m[:, c], b3m[:, c]
            p_head, p_nongap = b1head[:, c], b1nongap[:, c]
            continue
        g = colge3[:, c, None]
        b1, b2 = b1key[:, c], b2key[:, c]
        v_c, use_c, gain = valid[:, c], same[:, c], gains[:, c]
        h2, comp, nongap_c = b2head[:, c], computed[:, c], b1nongap[:, c]

        m = ((p_b2[:, None, :] == b1[:, :, None])
             & (p_b3[:, None, :] == b2[:, :, None])
             & ~(p_head & g)[:, None, :])
        best, j, has = _pick_reduce(m, p_sc[:, None, :], p_nongap[:, None, :])
        s = torch.where(h2, gain, torch.where(has, best + gain, neg))
        take = ~use_c & comp
        s = torch.where(take & v_c, s, neg)
        bi = torch.where(take, j, 0)

        mc = ((b2m[:, c][:, None, :] == b1[:, :, None])
              & (b3m[:, c][:, None, :] == b2[:, :, None])
              & ~(b1head[:, c] & g)[:, None, :])                   # [B, i, j]
        for i in live_slots[c].nonzero()[:, 0].tolist():
            pool = torch.where(jidx < i, s, neg)
            best, j, has = _pick_reduce(mc[:, i], pool, nongap_c)
            s_i = torch.where(h2[:, i], gain[:, i],
                              torch.where(has, best + gain[:, i], neg[:, 0]))
            sel = live_all[:, c, i]
            s[:, i] = torch.where(sel, s_i, s[:, i])
            bi[:, i] = torch.where(sel, j, bi[:, i])
        pool = torch.where(jidx[None, :] < jidx[:, None], s[:, None, :],
                           neg[:, None, :])                        # [B, i, j]
        _best, j, _has = _pick_reduce(mc, pool, nongap_c[:, None, :])
        bi = torch.where(use_c & ~v_c & comp, j, bi)

        out = torch.where(seeded[:, None] & v_c & (c == 2), 0, s)
        scores[:, c] = out
        besti[:, c] = bi.to(torch.int8)
        p_sc, p_b2, p_b3 = out, b2m[:, c], b3m[:, c]
        p_head, p_nongap = b1head[:, c], nongap_c
    return scores, besti


def consensus_dp_base_plain(key, cnt, cov, lead, seed):
    """Plain twin of the consensus_dp_base kernel."""
    _count("consensus_dp_base_plain")
    return _dp_reduce_columns(key, cnt, cov, lead, seed, None)


def consensus_dp_dynk_plain(key, cnt, cov, n_slots, lead, seed):
    """Plain twin of the consensus_dp_dynk kernel."""
    _count("consensus_dp_dynk_plain")
    return _dp_reduce_columns(key, cnt, cov, lead, seed, n_slots)


# --------------------------------------------------------------------------
# backtrack


def backtrack_packed(key, cnt, cov, scores, besti, last_col, seed,
                     max_steps: int):
    """Backtrack walk + output pack: -> int16 [B, max_steps + 8] (u16 bits
    of pack_backtrack_out; lvl_over is always 0, since the DP has no level
    cap). CPU tensors: the plain twin; CUDA tensors: the kernel."""
    if key.device.type == "cpu":
        return backtrack_plain(key, cnt, cov, scores, besti, last_col, seed,
                               max_steps)
    if key.device.type != "cuda":
        raise ValueError(f"backtrack_packed: unsupported device {key.device}")
    B, W, K = key.shape
    if not 1 <= K <= K_MAX:
        raise ValueError(f"backtrack_packed: K={K} outside 1..{K_MAX}")
    dev = key.device
    _check(key, "key", torch.int32, (B, W, K), dev)
    _check(cnt, "cnt", torch.int32, (B, W, K), dev)
    _check(cov, "cov", torch.int32, (B, W), dev)
    _check(scores, "scores", torch.int32, (B, W, K), dev)
    _check(besti, "besti", torch.int8, (B, W, K), dev)
    _check(last_col, "last_col", torch.int32, (B,), dev)
    _check(seed, "seed", torch.uint8, (B,), dev)
    out = torch.empty((B, max_steps + 8), dtype=torch.int16, device=dev)
    fn = _fn("backtrack")
    with torch.cuda.device(dev):
        _launch("backtrack_packed", (K, B, W), fn, key.data_ptr(),
                cnt.data_ptr(), cov.data_ptr(), scores.data_ptr(),
                besti.data_ptr(), last_col.data_ptr(), seed.data_ptr(),
                out.data_ptr(), B, W, K, int(max_steps),
                torch.cuda.current_stream(dev).cuda_stream)
    return out


def backtrack_plain(key, cnt, cov, scores, besti, last_col, seed,
                    max_steps: int):
    """Plain twin of the backtrack kernel: the packed state table, then one
    gather per step (the JAX _backtrack_scan_packed)."""
    _count("backtrack_plain")
    B, W, K = key.shape
    info = backtrack_state_tables(key, cnt, cov, besti, seed.to(torch.bool))
    s, best = backtrack_start(scores, last_col, K)
    alive = torch.ones(B, dtype=torch.bool, device=key.device)
    n_steps = torch.zeros(B, dtype=torch.int64, device=key.device)
    words = torch.empty((B, max_steps), dtype=torch.int64, device=key.device)
    for t in range(max_steps):
        inf = info.gather(1, s[:, None])[:, 0]
        word = inf & 0x7FFF
        nxt = inf >> 15
        words[:, t] = torch.where(alive, word, word & ~0x10)
        n_steps += alive
        alive = alive & (nxt != s)
        s = nxt
    return pack_backtrack_out(words, best, n_steps, alive,
                              torch.zeros_like(alive))
