"""Device mesh of the port, and the helpers that place work on it.

The polishing workload shards two ways, as in the JAX package
(nextpolish2_tpu/parallel/mesh.py):
  - the 'win' axis: each chunk of windows splits its batch rows over the
    axis's positions, which assemble, score and walk their own rows
    (ops/consensus.py, pipeline/engine.py::MeshRunner);
  - the 'kmer' axis: a large yak table splits into hash-prefix shards, one
    on each position, and a lookup adds the positions' disjoint hits
    (parallel/sharded_kmer.py).

A Mesh is a 2-D numpy array of torch.device with the axis names
("win", "kmer"). A device may repeat: a mesh of one device eight times runs
its positions' work in turn on that device, which is how the tests (on the
CPU) and chip_smoke.py (on one card) drive a 4x2 mesh. JAX's NamedSharding
has no counterpart: win_rows gives each 'win' position its row range, and
axis_devices the device of each position along an axis. The mesh spans one
process's own devices; processes share no mesh (parallel/distributed.py
stripes contigs over them instead).

POSITION_RUNS counts, per (axis, position), the times a position did its
share of a sharded program, so that a run can show every position worked.
"""

from __future__ import annotations

import collections
import os
import threading
from typing import Optional, Sequence

import numpy as np
import torch

AXES = ("win", "kmer")

POSITION_RUNS: dict = collections.Counter()
_runs_lock = threading.Lock()


class Mesh:
    """devices: numpy object array [n_win, n_kmer] of torch.device."""

    def __init__(self, devices: np.ndarray):
        if devices.ndim != 2:
            raise ValueError("a mesh is a 2-D array of devices")
        self.devices = devices
        self.axis_names = AXES
        self.shape = dict(zip(AXES, devices.shape))

    def __repr__(self) -> str:
        return (f"Mesh({self.shape['win']}x{self.shape['kmer']}, "
                f"{sorted({str(d) for d in self.devices.flat})})")


def visible_devices() -> list:
    """The CUDA cards this process sees, one device each."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_win: Optional[int] = None, n_kmer: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """An n_win x n_kmer mesh over `devices` (default: every visible card),
    which may repeat a device."""
    devices = [torch.device(d) for d in (devices if devices is not None
                                         else visible_devices())]
    n = len(devices)
    if n == 0:
        raise RuntimeError("make_mesh: no CUDA device visible; pass devices=")
    if n_win is None:
        n_win = n // n_kmer
    assert n_win * n_kmer == n, f"mesh {n_win}x{n_kmer} != {n} devices"
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(n_win, n_kmer))


def axis_size(mesh: Optional[Mesh], axis: str) -> int:
    if mesh is None or axis not in mesh.axis_names:
        return 1
    return int(mesh.shape[axis])


def axis_devices(mesh: Mesh, axis: str) -> list:
    """The device of each position along `axis`, at position 0 of the other
    axis: the 'win' positions' devices hold a chunk's rows, the 'kmer'
    positions' devices the table's shards. (The other positions along the
    second axis would hold replicas, which compute the same values.)"""
    if axis == "win":
        return list(mesh.devices[:, 0])
    if axis == "kmer":
        return list(mesh.devices[0, :])
    raise ValueError(f"unknown mesh axis {axis!r} (expected one of {AXES})")


def win_rows(mesh: Mesh, B: int) -> list:
    """Row range [i*Bl, (i+1)*Bl) of each 'win' position of a batch of B
    rows, Bl = B / n_win."""
    n_win = axis_size(mesh, "win")
    if B % n_win:
        raise ValueError(f"a batch of {B} rows does not split over "
                         f"{n_win} 'win' positions")
    Bl = B // n_win
    return [(i * Bl, (i + 1) * Bl) for i in range(n_win)]


def per_position(mesh: Mesh, x) -> list:
    """x once per 'win' position, on that position's device: a list of one
    tensor a position passes as it is (the caller has placed them); a tensor
    or numpy array is copied to each position's device."""
    devs = axis_devices(mesh, "win")
    if isinstance(x, (list, tuple)):
        if len(x) != len(devs):
            raise ValueError(f"{len(x)} inputs for {len(devs)} 'win' "
                             "positions")
        return list(x)
    t = torch.from_numpy(x) if isinstance(x, np.ndarray) else x
    return [t.to(d) for d in devs]


def count_position(axis: str, index: int) -> None:
    with _runs_lock:
        POSITION_RUNS[(axis, index)] += 1


def reset_position_counts() -> None:
    with _runs_lock:
        POSITION_RUNS.clear()


# ---- active mesh: opt-in sharding for the production engine ----
# When set, pipeline/engine.py and pipeline/batcher.py shard chunks over
# 'win' and io/yak.py routes batched k-mer lookups through the
# 'kmer'-sharded table.

_active_mesh: Optional[Mesh] = None


def set_active_mesh(mesh: Optional[Mesh]) -> None:
    global _active_mesh
    _active_mesh = mesh


def get_active_mesh() -> Optional[Mesh]:
    return _active_mesh


def auto_mesh(n_kmer: int = 0, yak_bytes: int = 0) -> Optional[Mesh]:
    """Mesh over all visible cards (None with one card or none).

    n_kmer = 0 picks the kmer-axis width from the loaded tables' footprint:
    a replicated table must fit each card's budget, so the axis doubles
    until the per-card shard fits. The budget is NP2_KMER_DEVICE_BUDGET_GB
    (GB of 10^9 bytes) or, by default, half the memory card 0 has free
    (the rule KmerTable.device_fits routes by). yak_bytes is the summed
    .yak file size; resident cost is about 1.25 times that. With
    yak_bytes = 0 (unknown) the kmer axis stays 1."""
    n = torch.cuda.device_count()
    if n <= 1:
        return None
    if n_kmer <= 0:
        n_kmer = 1
        if yak_bytes:
            env = os.environ.get("NP2_KMER_DEVICE_BUDGET_GB")
            budget = (float(env) * 1e9 if env is not None
                      else torch.cuda.mem_get_info(0)[0] / 2)
            need = yak_bytes * 1.25
            while n_kmer < n and need / n_kmer > budget:
                n_kmer *= 2
    if n % n_kmer:
        n_kmer = 1
    return make_mesh(n_win=n // n_kmer, n_kmer=n_kmer)
