"""Deterministic maximum-cardinality matching (Edmonds' blossom, O(V^3)).

Used to kekulize aromatic rings.  It augments from the vertices in index
order and scans neighbours in edge insertion order, so a tie resolves the
same way every time (and the same way as the JAX package's native
scorer, which implements the same search)."""

from __future__ import annotations

from typing import List, Sequence, Tuple


def max_matching(n: int, edges: Sequence[Tuple[int, int]]) -> List[int]:
    """Returns match[v] (the partner of v, or -1)."""
    g: List[List[int]] = [[] for _ in range(n)]
    for u, v in edges:
        g[u].append(v)
        g[v].append(u)
    match = [-1] * n
    p = [-1] * n
    base = list(range(n))

    def lca(a: int, b: int) -> int:
        seen = [False] * n
        while True:
            a = base[a]
            seen[a] = True
            if match[a] == -1:
                break
            a = p[match[a]]
        while True:
            b = base[b]
            if seen[b]:
                return b
            b = p[match[b]]

    def mark_path(v: int, b: int, child: int, blossom: List[bool]) -> None:
        while base[v] != b:
            blossom[base[v]] = True
            blossom[base[match[v]]] = True
            p[v] = child
            child = match[v]
            v = p[match[v]]

    def find_path(root: int) -> int:
        used = [False] * n
        for i in range(n):
            p[i] = -1
            base[i] = i
        used[root] = True
        q = [root]
        qi = 0
        while qi < len(q):
            v = q[qi]
            qi += 1
            for to in g[v]:
                if base[v] == base[to] or match[v] == to:
                    continue
                if to == root or (match[to] != -1 and p[match[to]] != -1):
                    curbase = lca(v, to)
                    blossom = [False] * n
                    mark_path(v, curbase, to, blossom)
                    mark_path(to, curbase, v, blossom)
                    for i in range(n):
                        if blossom[base[i]]:
                            base[i] = curbase
                            if not used[i]:
                                used[i] = True
                                q.append(i)
                elif p[to] == -1:
                    p[to] = v
                    if match[to] == -1:
                        return to
                    used[match[to]] = True
                    q.append(match[to])
        return -1

    for v in range(n):
        if match[v] != -1:
            continue
        u = find_path(v)
        while u != -1:
            pv = p[u]
            ppv = match[pv]
            match[u] = pv
            match[pv] = u
            u = ppv
    return match
