"""Standalone Louvain harness: read an edge list, print communities, self-check.

Usage: python -m nextpolish2_tpu_torch.tools.louvain_check EDGES

Mirrors the reference's embedded module test (louvain.rs:358-426): file lines are
`<ignored> <node1> <node2> <weight>`; community weights are verified against the
raw graph.
"""

from __future__ import annotations

import sys

from ..models.louvain import Louvain, insert_data, new_data, phase_communities


def init_graph(path):
    data = new_data()
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 4:
                continue
            insert_data(data, int(parts[1]), int(parts[2]), float(parts[3]))
    return data


def check(path, data, communities):
    raw = init_graph(path)
    for node in communities:
        w = 0.0
        for n1 in node.nodes:
            for n2 in node.nodes:
                w += raw.get(n1, {}).get(n2, 0.0)
        if abs(w - node.weight * 2.0) >= 1e-6:
            raise AssertionError("failed check of the community weights")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    path = argv[0]
    lv = Louvain(init_graph(path))
    data, communities = lv.execute()
    check(path, data, communities)
    for p, c in enumerate(communities):
        print(p, c.weight, len(c.nodes), sorted(c.nodes))
    invalid = phase_communities(init_graph(path), {})
    print(sorted(invalid))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
