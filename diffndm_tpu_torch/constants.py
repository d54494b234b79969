"""Chemistry tables and the dataset encodings.

A self-contained copy of the subset of the JAX package's ``constants.py``
that bond perception, molecule building and the pocket encodings read:
bond-length tables (pm), OpenBabel covalent radii and bond caps, allowed
valences, masses, the backbone geometry of the CA frames, the atom and
amino-acid decoders, the standard amino acids that pocket extraction from
a PDB file keeps, and the Lennard-Jones r_m table of the training loss's
auxiliary term.  ``dataset_params`` holds the three encodings of the
committed configurations: ``crossdock_full`` (full-atom CrossDocked),
``crossdock`` (CrossDocked with CA pockets) and ``bindingmoad``.
"""

from __future__ import annotations

import numpy as np

# bond-order perception margins (pm)
MARGIN1, MARGIN2, MARGIN3 = 3.0, 2.0, 1.0

# OpenBabel element data: single-bond covalent radii (pm) and maximum bond
# counts, used by the ConnectTheDots connectivity rule in chem/bonds.py
OB_COVALENT_RADII = {
    "H": 31.0, "B": 84.0, "C": 76.0, "N": 71.0, "O": 66.0, "F": 57.0,
    "Al": 121.0, "Si": 111.0, "P": 107.0, "S": 105.0, "Cl": 102.0,
    "As": 119.0, "Br": 120.0, "I": 139.0, "Hg": 132.0, "Bi": 148.0,
}
OB_MAX_BONDS = {
    "H": 1, "B": 4, "C": 4, "N": 4, "O": 2, "F": 1, "Al": 6, "Si": 6,
    "P": 6, "S": 6, "Cl": 1, "As": 5, "Br": 1, "I": 3, "Hg": 2, "Bi": 5,
}

# allowed valences per element (tuple = several allowed states)
ALLOWED_BONDS = {
    "H": 1, "C": 4, "N": 3, "O": 2, "F": 1, "B": 3, "Al": 3, "Si": 4,
    "P": (3, 5), "S": 4, "Cl": 1, "As": 3, "Br": 1, "I": 1, "Hg": (1, 2),
    "Bi": (3, 5),
}

# single-bond equilibrium lengths (pm) between element symbols
BONDS1 = {
    "H": {"H": 74, "C": 109, "N": 101, "O": 96, "F": 92, "B": 119, "Si": 148,
          "P": 144, "As": 152, "S": 134, "Cl": 127, "Br": 141, "I": 161},
    "C": {"H": 109, "C": 154, "N": 147, "O": 143, "F": 135, "Si": 185,
          "P": 184, "S": 182, "Cl": 177, "Br": 194, "I": 214},
    "N": {"H": 101, "C": 147, "N": 145, "O": 140, "F": 136, "Cl": 175,
          "Br": 214, "S": 168, "I": 222, "P": 177},
    "O": {"H": 96, "C": 143, "N": 140, "O": 148, "F": 142, "Br": 172,
          "S": 151, "P": 163, "Si": 163, "Cl": 164, "I": 194},
    "F": {"H": 92, "C": 135, "N": 136, "O": 142, "F": 142, "S": 158,
          "Si": 160, "Cl": 166, "Br": 178, "P": 156, "I": 187},
    "B": {"H": 119, "Cl": 175},
    "Si": {"Si": 233, "H": 148, "C": 185, "O": 163, "S": 200, "F": 160,
           "Cl": 202, "Br": 215, "I": 243},
    "Cl": {"Cl": 199, "H": 127, "C": 177, "N": 175, "O": 164, "P": 203,
           "S": 207, "B": 175, "Si": 202, "F": 166, "Br": 214},
    "S": {"H": 134, "C": 182, "N": 168, "O": 151, "S": 204, "F": 158,
          "Cl": 207, "Br": 225, "Si": 200, "P": 210, "I": 234},
    "Br": {"Br": 228, "H": 141, "C": 194, "O": 172, "N": 214, "Si": 215,
           "S": 225, "F": 178, "Cl": 214, "P": 222},
    "P": {"P": 221, "H": 144, "C": 184, "O": 163, "Cl": 203, "S": 210,
          "F": 156, "N": 177, "Br": 222},
    "I": {"H": 161, "C": 214, "Si": 243, "N": 222, "O": 194, "S": 234,
          "F": 187, "I": 266},
    "As": {"H": 152},
}

BONDS2 = {
    "C": {"C": 134, "N": 129, "O": 120, "S": 160},
    "N": {"C": 129, "N": 125, "O": 121},
    "O": {"C": 120, "N": 121, "O": 121, "P": 150},
    "P": {"O": 150, "S": 186},
    "S": {"P": 186, "C": 160},
}

BONDS3 = {
    "C": {"C": 120, "N": 116, "O": 113},
    "N": {"C": 116, "N": 110},
    "O": {"C": 113},
}

# monoisotopic masses (Descriptors.ExactMolWt convention)
MONOISOTOPIC_MASS = {
    "H": 1.00782503, "B": 11.00930536, "C": 12.0, "N": 14.0030740,
    "O": 15.9949146, "F": 18.9984032, "Al": 26.98153853, "Si": 27.97692653,
    "P": 30.97376199, "S": 31.97207117, "Cl": 34.96885268, "As": 74.92159457,
    "Br": 78.9183376, "I": 126.9044719, "Hg": 201.9706434, "Bi": 208.9803991,
}

ATOMIC_NUMBER = {
    "H": 1, "B": 5, "C": 6, "N": 7, "O": 8, "F": 9, "Al": 13, "Si": 14,
    "P": 15, "S": 16, "Cl": 17, "As": 33, "Br": 35, "I": 53, "Hg": 80,
    "Bi": 83,
}

# backbone geometry (Bhagavan & Ha 2015) of the CA frames (utils/geometry)
N_CA_DIST = 1.47
CA_C_DIST = 1.53
N_CA_C_ANGLE = 110.0 * np.pi / 180.0

AA_3TO1 = {
    "ALA": "A", "ARG": "R", "ASN": "N", "ASP": "D", "CYS": "C", "GLN": "Q",
    "GLU": "E", "GLY": "G", "HIS": "H", "ILE": "I", "LEU": "L", "LYS": "K",
    "MET": "M", "PHE": "F", "PRO": "P", "SER": "S", "THR": "T", "TRP": "W",
    "TYR": "Y", "VAL": "V",
}
STANDARD_AA = set(AA_3TO1)


def _sym_table(pairs: dict, decoder: list) -> np.ndarray:
    """Symmetric [K, K] bond-length table (pm); absent pairs are 0."""
    k = len(decoder)
    out = np.zeros((k, k), dtype=np.float32)
    for i, a in enumerate(decoder):
        for j, b in enumerate(decoder):
            v = pairs.get(a, {}).get(b, 0.0)
            if v:
                out[i, j] = v
    return np.maximum(out, out.T)


_LIG_DECODER_10 = ["C", "N", "O", "S", "B", "Br", "Cl", "P", "I", "F"]
_LIG_DECODER_11 = _LIG_DECODER_10 + ["others"]
_AA_DECODER_20 = list("ACDEFGHIKLMNPQRSTVWY")


# pm, multi-bond covalent radii (the Lennard-Jones table's fallback)
COVALENT_RADII = {
    "H": 32, "C": 60, "N": 54, "O": 53, "F": 53, "B": 73, "Al": 111,
    "Si": 102, "P": 94, "S": 94, "Cl": 93, "As": 106, "Br": 109, "I": 125,
    "Hg": 133, "Bi": 135,
}


def _lj_table(decoder: list) -> np.ndarray:
    """Lennard-Jones r_m (pm): the shortest tabulated bond length of a
    bondable pair, else the sum of covalent radii."""
    k = len(decoder)
    tables = [_sym_table(t, decoder) for t in (BONDS1, BONDS2, BONDS3)]
    out = np.zeros((k, k), dtype=np.float32)
    for i in range(k):
        for j in range(k):
            cands = [t[i, j] for t in tables if t[i, j] > 0]
            if cands:
                out[i, j] = min(cands)
            else:
                ri = COVALENT_RADII.get(decoder[i], 0)
                rj = COVALENT_RADII.get(decoder[j], 0)
                out[i, j] = ri + rj if (ri and rj) else 0.0
    return out


def _make_params(atom_decoder, aa_decoder, atom_hist):
    bond_decoder = [a for a in atom_decoder if a != "others"]

    def padded(tab):
        full = np.zeros((len(atom_decoder),) * 2, dtype=np.float32)
        full[: len(bond_decoder), : len(bond_decoder)] = tab
        return full

    return {
        "atom_encoder": {a: i for i, a in enumerate(atom_decoder)},
        "atom_decoder": list(atom_decoder),
        "aa_encoder": {a: i for i, a in enumerate(aa_decoder)},
        "aa_decoder": list(aa_decoder),
        "bonds1": padded(_sym_table(BONDS1, bond_decoder)),
        "bonds2": padded(_sym_table(BONDS2, bond_decoder)),
        "bonds3": padded(_sym_table(BONDS3, bond_decoder)),
        "lennard_jones_rm": padded(_lj_table(bond_decoder)),
        # ligand atom counts of the training set (the dashboard's type KL)
        "atom_hist": dict(atom_hist),
        # trailing decoder entries that are padding types, not elements
        "_pad_types": len(atom_decoder) - len(bond_decoder),
    }


# the encodings of the committed configurations: full-atom CrossDocked
# (ligand and pocket share the 11-type decoder, whose last "others" column
# is dropped at model level), CrossDocked with CA pockets (20 amino acids)
# and Binding MOAD (10 ligand types; CA or full-atom pockets)
dataset_params = {
    "bindingmoad": _make_params(
        _LIG_DECODER_10, _AA_DECODER_20,
        {"C": 545542, "N": 90205, "O": 132965, "S": 9342, "B": 109,
         "Br": 1424, "Cl": 5516, "P": 5154, "I": 445, "F": 9742}),
    "crossdock_full": _make_params(
        _LIG_DECODER_11, _LIG_DECODER_11,
        {"C": 1570767, "N": 273858, "O": 396837, "S": 26352, "B": 0,
         "Br": 0, "Cl": 15058, "P": 25994, "I": 0, "F": 30687, "others": 0}),
    "crossdock": _make_params(
        _LIG_DECODER_10, _AA_DECODER_20,
        {"C": 1570032, "N": 273792, "O": 396623, "S": 26339, "B": 0,
         "Br": 0, "Cl": 15055, "P": 25975, "I": 0, "F": 30673}),
}
