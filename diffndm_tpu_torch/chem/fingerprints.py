"""Graph fingerprints: Morgan/ECFP-style hashing, linear-path bits,
Tanimoto similarity, mean pairwise diversity and a Weisfeiler-Lehman
canonical key.

They stand in for the RDKit fingerprints of the reference's diversity,
uniqueness and novelty.  The hashes are blake2b over the same strings as
the JAX package's ``chem/fingerprints.py``, so bits and keys are equal to
its own (not to RDKit's; Tanimoto diversity behaves the same way).
"""

from __future__ import annotations

import hashlib
from typing import Set

from diffndm_tpu_torch.chem.mol import Molecule


def _h64(data: str) -> int:
    return int.from_bytes(hashlib.blake2b(
        data.encode(), digest_size=8).digest(), "little")


def _initial_invariants(mol: Molecule):
    return [_h64(f"{mol.symbols[i]}|{mol.degree(i)}|{mol.implicit_h(i)}|"
                 f"{int(mol.is_aromatic_atom(i))}|"
                 f"{int(mol.ring_membership[i])}")
            for i in range(mol.n_atoms)]


def _refine(mol: Molecule, inv):
    """One round of neighbourhood hashing: each atom's invariant with the
    sorted (bond order, neighbour invariant) pairs."""
    out = []
    for i in range(mol.n_atoms):
        nb = sorted((int(mol.adjacency[i, j]), inv[j])
                    for j in mol.neighbors[i])
        out.append(_h64(f"{inv[i]}|{nb}"))
    return out


def morgan_bits(mol: Molecule, radius: int = 2, n_bits: int = 2048
                ) -> Set[int]:
    """ECFP-style bit set: iterated neighbourhood hashing."""
    inv = _initial_invariants(mol)
    bits = {v % n_bits for v in inv}
    for _ in range(radius):
        inv = _refine(mol, inv)
        bits |= {v % n_bits for v in inv}
    return bits


def path_bits(mol: Molecule, max_len: int = 5, n_bits: int = 2048
              ) -> Set[int]:
    """Linear-path fingerprint in the spirit of RDKit's RDKFingerprint:
    hashes of every simple path of up to max_len bonds, each read in the
    lesser of its two directions."""
    bits: Set[int] = set()
    for start in range(mol.n_atoms):
        stack = [(start, [start])]
        while stack:
            u, path = stack.pop()
            if len(path) > 1:
                labels = [f"{mol.symbols[a]}{int(mol.adjacency[a, b])}"
                          for a, b in zip(path[:-1], path[1:])]
                labels.append(mol.symbols[path[-1]])
                key = "".join(labels)
                rkey = "".join(reversed(labels))
                bits.add(_h64(min(key, rkey)) % n_bits)
            if len(path) <= max_len:
                for v in mol.neighbors[u]:
                    if v not in path:
                        stack.append((v, path + [v]))
    return bits


def tanimoto(a: Set[int], b: Set[int]) -> float:
    if not a and not b:
        return 1.0
    inter = len(a & b)
    return inter / (len(a) + len(b) - inter)


def similarity(mol_a: Molecule, mol_b: Molecule) -> float:
    return tanimoto(path_bits(mol_a), path_bits(mol_b))


def diversity(mols) -> float:
    """Mean pairwise (1 - Tanimoto) of the path fingerprints; 0 for fewer
    than two molecules."""
    if len(mols) < 2:
        return 0.0
    fps = [path_bits(m) for m in mols]
    tot, cnt = 0.0, 0
    for i in range(len(fps)):
        for j in range(i + 1, len(fps)):
            tot += 1.0 - tanimoto(fps[i], fps[j])
            cnt += 1
    return tot / cnt


def wl_canonical_key(mol: Molecule, iterations: int = 4) -> str:
    """Weisfeiler-Lehman canonical hash of the heavy-atom graph: the
    identity key used where the reference uses canonical SMILES."""
    inv = _initial_invariants(mol)
    for _ in range(iterations):
        inv = _refine(mol, inv)
    return hashlib.blake2b(
        str(sorted(inv)).encode(), digest_size=16).hexdigest()
