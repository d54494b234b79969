"""Smallest set of smallest rings of a small molecular graph (BFS
smallest-ring search over the 2-core of the graph)."""

from __future__ import annotations

from collections import deque
from typing import List, Sequence, Set, Tuple


def _trim_tree_nodes(n: int, adj: List[Set[int]]) -> Set[int]:
    """Iteratively remove degree<=1 nodes; what remains carries all rings."""
    deg = [len(a) for a in adj]
    queue = deque(i for i in range(n) if deg[i] <= 1)
    removed = set()
    while queue:
        u = queue.popleft()
        if u in removed:
            continue
        removed.add(u)
        for v in adj[u]:
            if v not in removed:
                deg[v] -= 1
                if deg[v] <= 1:
                    queue.append(v)
    return set(range(n)) - removed


def _smallest_ring_through(root: int, core: Set[int],
                           adj: List[Set[int]]) -> Tuple[int, ...]:
    """Smallest cycle through ``root`` restricted to core nodes (BFS)."""
    parent = {root: -1}
    depth = {root: 0}
    q = deque([root])
    best: Tuple[int, ...] = ()
    while q:
        u = q.popleft()
        for v in adj[u]:
            if v not in core:
                continue
            if v not in parent:
                parent[v] = u
                depth[v] = depth[u] + 1
                q.append(v)
            elif parent[u] != v and parent[v] != u:
                # two BFS branches meet: reconstruct both paths to root
                pu, pv = [], []
                a, b = u, v
                while a != -1:
                    pu.append(a)
                    a = parent[a]
                while b != -1:
                    pv.append(b)
                    b = parent[b]
                if len(set(pu) & set(pv)) != 1:
                    continue  # paths must only share the root
                ring = tuple(pu + pv[:-1][::-1]) if pu[-1] == pv[-1] else ()
                if ring and (not best or len(ring) < len(best)):
                    best = ring
        if best and depth[u] > len(best):
            break
    return best


def find_rings(n: int, bonds: Sequence[Tuple[int, int]]) -> List[List[int]]:
    adj: List[Set[int]] = [set() for _ in range(n)]
    for i, j in bonds:
        adj[i].add(j)
        adj[j].add(i)
    core = _trim_tree_nodes(n, adj)
    if not core:
        return []
    # cyclomatic number of the core subgraph
    e_core = sum(1 for i, j in bonds if i in core and j in core)
    seen: Set[int] = set()
    n_comp = 0
    for s in core:
        if s in seen:
            continue
        n_comp += 1
        stack = [s]
        seen.add(s)
        while stack:
            u = stack.pop()
            for v in adj[u]:
                if v in core and v not in seen:
                    seen.add(v)
                    stack.append(v)
    n_rings = e_core - len(core) + n_comp
    if n_rings <= 0:
        return []

    candidates: Set[frozenset] = set()
    rings: List[Tuple[int, ...]] = []
    for v in sorted(core):
        ring = _smallest_ring_through(v, core, adj)
        if ring and frozenset(ring) not in candidates:
            candidates.add(frozenset(ring))
            rings.append(ring)
    rings.sort(key=len)
    # keep a subset of size n_rings, each adding a new edge
    out: List[List[int]] = []
    covered_edges: Set[frozenset] = set()
    for ring in rings:
        if len(out) >= n_rings:
            break
        edges = {frozenset((ring[k], ring[(k + 1) % len(ring)]))
                 for k in range(len(ring))}
        if edges - covered_edges:
            out.append(list(ring))
            covered_edges |= edges
    # if the greedy pass under-collected (rare fused systems), fill up
    for ring in rings:
        if len(out) >= n_rings:
            break
        if list(ring) not in out:
            out.append(list(ring))
    return out
