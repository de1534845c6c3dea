"""Louvain community detection + phasing community selection.

Reimplements the reference phasing graph machinery (src/utils/louvain.rs) with
deterministic orderings: the reference iterates FxHashMap/FxHashSet (arbitrary but
deterministic order); we canonicalize to sorted-by-id iteration everywhere it could
matter. Weight sums are integers (+/-1 edges) accumulated in f64 — exact, so the
float-order sensitivity noted in SURVEY §7 does not arise.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

Graph = Dict[int, Dict[int, float]]


def new_data() -> Graph:
    return {}


def insert_data(data: Graph, k1: int, k2: int, v: float) -> None:
    """Accumulate edge weight (louvain.rs:272-279)."""
    row = data.setdefault(k1, {})
    row[k2] = row.get(k2, 0.0) + v


def assign_data(data: Graph, k1: int, k2: int, v: float) -> None:
    """Overwrite edge weight (louvain.rs:281-288)."""
    data.setdefault(k1, {})[k2] = v


class Node:
    __slots__ = ("id", "weight", "nodes")

    def __init__(self, id_: int, weight: float, nodes):
        self.id = id_
        self.weight = weight
        self.nodes: Set[int] = set(nodes)


class Louvain:
    """louvain.rs:29-257. data: vertex -> {vertex: weight}."""

    def __init__(self, data: Graph):
        self.data = data
        self.communities: Dict[int, Set[int]] = {}
        self.node: Dict[int, Node] = {}
        for vid in data:
            self.communities[vid] = {vid}
            self.node[vid] = Node(vid, 0.0, [vid])

    def first_stage(self) -> bool:
        """Local moving phase (louvain.rs:72-117): visit vertices in sorted
        order, move each to the neighboring community with max positive
        connection weight (ties -> smaller community id), repeat until
        stable. The pair-loop form of the upstream code."""
        mod_inc = False
        visit_ids = sorted(self.data.keys())
        while True:
            can_stop = True
            for v_id in visit_ids:
                v_nid = self.node[v_id].id
                node_ids: Dict[int, float] = {}
                for w_id in self.data[v_id]:
                    w_nid = self.node[w_id].id
                    if w_nid in node_ids:
                        continue
                    comm = self.communities[w_nid]
                    node_ids[w_nid] = sum(
                        v for k, v in self.data[v_id].items() if k in comm
                    )
                if node_ids:
                    # max by (weight, Reverse(id)) (louvain.rs:99-102)
                    best_id, best_w = max(
                        node_ids.items(), key=lambda kv: (kv[1], -kv[0])
                    )
                    if best_w > 0.0 and best_id != v_nid:
                        self.node[v_id].id = best_id
                        self.communities[best_id].add(v_id)
                        self.communities[v_nid].discard(v_id)
                        can_stop = False
                        mod_inc = True
            if can_stop:
                break
        return mod_inc

    def second_stage(self) -> "Louvain":
        """Aggregation phase (louvain.rs:119-195): communities become super-nodes;
        communities with negative internal weight are de-clustered back into their
        member super-nodes."""
        node: Dict[int, Node] = {}
        communities: Dict[int, Set[int]] = {}
        decluster_ids: List[int] = []
        for cid in sorted(self.communities):
            nodes = self.communities[cid]
            if not nodes:
                continue
            new_node = Node(cid, 0.0, [])
            for nid in sorted(nodes):
                vertex = self.node[nid]
                new_node.nodes |= vertex.nodes
                new_node.weight += vertex.weight
                row = self.data.get(nid)
                if row:
                    for k, v in row.items():
                        if k in nodes:
                            new_node.weight += v / 2.0
            if new_node.weight < 0.0:
                decluster_ids.append(cid)
            else:
                communities[cid] = {cid}
                node[cid] = new_node

        for cid in decluster_ids:
            nodes = self.communities.pop(cid)
            for nid in sorted(nodes):
                new_nid = nid
                while new_nid in communities or new_nid in node:
                    new_nid += 1
                communities[new_nid] = {new_nid}
                node[new_nid] = Node(
                    new_nid, self.node[nid].weight, set(self.node[nid].nodes)
                )
                self.communities[new_nid] = {nid}

        data: Graph = {}
        live = sorted(k for k, v in self.communities.items() if v)
        for i, nid1 in enumerate(live):
            nodes1 = self.communities[nid1]
            for nid2 in live:
                if nid2 <= nid1:
                    continue
                nodes2 = self.communities[nid2]
                w = 0.0
                for vid in nodes1:
                    row = self.data.get(vid)
                    if row:
                        for k, v in row.items():
                            if k in nodes2:
                                w += v
                if w != 0.0:
                    insert_data(data, nid1, nid2, w)
                    insert_data(data, nid2, nid1, w)

        out = Louvain({})
        out.data = data
        out.communities = communities
        out.node = node
        return out

    def get_communities(self) -> Tuple[Graph, List[Node]]:
        """Final community list + inter-community (conflict) graph
        (louvain.rs:197-245)."""
        communities: List[Node] = []
        for cid in sorted(self.communities):
            nodes = self.communities[cid]
            if not nodes:
                continue
            weight = 0.0
            new_nodes: Set[int] = set()
            for vid in sorted(nodes):
                v = self.node[vid]
                new_nodes |= v.nodes
                weight += v.weight
                row = self.data.get(vid)
                if row:
                    for k, w in row.items():
                        if k in nodes:
                            weight += w / 2.0
            communities.append(Node(cid, weight, new_nodes))

        data: Graph = {}
        for c1 in communities:
            for c2 in communities:
                if c2.id <= c1.id:
                    continue
                w = 0.0
                for n1 in self.communities[c1.id]:
                    row = self.data.get(n1)
                    if row:
                        for n2 in self.communities[c2.id]:
                            w += row.get(n2, 0.0)
                if w != 0.0:
                    assert w < 0.0, (
                        "cross-community edge weight must be negative"
                    )
                    insert_data(data, c1.id, c2.id, w)
                    insert_data(data, c2.id, c1.id, w)
        return data, communities

    def execute(self) -> Tuple[Graph, List[Node]]:
        lv = self
        while True:
            if lv.first_stage():
                lv = lv.second_stage()
            else:
                return lv.get_communities()


def phase_communities(data: Graph, ref_weight: Optional[Dict[int, float]]) -> List[int]:
    """Pick kept communities, return node ids of the discarded ones
    (louvain.rs:290-356).

    model=ref: sort by (ref-agreement count, ref weight) desc; model=len: by weight.
    Greedy: a community conflicting (any negative edge) with an earlier-kept one is
    invalidated; its reads are returned for removal from the MSA.
    """

    def stat_ref_weight(nodes: Set[int]) -> Tuple[int, float]:
        count = 0
        weight = 0.0
        for node in nodes:
            v = ref_weight.get(node)  # type: ignore[union-attr]
            if v is not None:
                if v > 0:
                    count += 1
                elif v < 0:
                    count -= 1
                weight += v
        return count, weight

    lv = Louvain(data)
    data2, communities = lv.execute()

    if ref_weight is not None:
        communities.sort(key=lambda x: stat_ref_weight(x.nodes), reverse=True)
    else:
        communities.sort(key=lambda x: x.weight, reverse=True)

    invalid_ids: Set[int] = set()
    for p, community in enumerate(communities):
        if community.id in invalid_ids:
            continue
        id_vs = data2.get(community.id)
        if id_vs:
            for check in communities[p + 1 :]:
                if check.id in invalid_ids:
                    continue
                if check.id in id_vs:
                    invalid_ids.add(check.id)

    invalid_nodes: List[int] = []
    for community in communities:
        if community.id in invalid_ids:
            invalid_nodes.extend(community.nodes)
    return invalid_nodes
