"""Native docking: a batched pose search over the Vina scoring function.

No docking binary is needed: a pose is (translation, orientation
quaternion, torsion angles), and the search optimises many random
restarts in parallel with Adam on the piecewise-smooth Vina terms of
chem/scoring.py, then runs basin-hopping rounds (perturb, re-refine, keep
what improved), the batch-parallel analogue of qvina2's Monte Carlo +
BFGS per pose.  The energy is plain torch over [molecules x restarts x
ligand atoms x receptor atoms] pair tensors on the device, and its
gradient comes from autograd.

Scoring matches chem/scoring.py (published Trott-Olson weights,
uncalibrated against smina), plus the intramolecular terms over flexible
pairs and a quadratic search-box penalty (qvina2 enforces the box through
its grid bounds).

Torsions: rotatable bonds by the rule of descriptors.num_rotatable_bonds
(single, acyclic, both ends non-terminal, no triple-bond neighbour); each
bond rotates its root-distal side, applied root to leaf so that nested
axes follow earlier rotations (the rigid-group tree of AutoDock).

The semantics, the order of the Adam update (optax's ``adam`` on a
``cosine_decay_schedule``) and the layout of the random draws are those of
the JAX package's ``chem/dock.py`` (tests/test_torch_dock.py).  Every
function that draws takes its draws as an optional argument
(``PoseDraws``); without them it draws from a ``torch.Generator`` seeded
by ``seed`` on the device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from diffndm_tpu_torch.chem.mol import Molecule
from diffndm_tpu_torch.chem.scoring import (W_GAUSS1, W_GAUSS2, W_HBOND,
                                            W_HYDROPHOBIC, W_NROT,
                                            W_REPULSION, VinaScorer,
                                            _atom_properties,
                                            hbond_direction_weight_torch,
                                            ligand_hbond_types,
                                            neighbor_mean_operator)
from diffndm_tpu_torch.device import resolve_device

_CUTOFF = 8.0
# optax.adam's scale_by_adam defaults, and the schedule's floor
B1, B2, EPS = 0.9, 0.999, 1e-8
LR_ALPHA = 0.05


# ---------------------------------------------------------------------------
# torsion tree (host-side prep, pure graph work)
# ---------------------------------------------------------------------------

def _rotatable_bonds(mol: Molecule) -> List[Tuple[int, int]]:
    """The rule of descriptors.num_rotatable_bonds."""
    triple = set()
    for i, j, o in mol.bonds:
        if o == 3:
            triple.add(i)
            triple.add(j)
    out = []
    for i, j, o in mol.bonds:
        if o != 1:
            continue
        if mol.degree(i) < 2 or mol.degree(j) < 2:
            continue
        if i in triple or j in triple:
            continue
        if mol.in_ring_bond(i, j):
            continue
        out.append((i, j))
    return out


def _graph_distances(n: int, bonds: Sequence[Tuple[int, int, int]]
                     ) -> np.ndarray:
    """All-pairs BFS hop counts (ligands are small); 127 = unreachable."""
    adj = [[] for _ in range(n)]
    for i, j, _ in bonds:
        adj[i].append(j)
        adj[j].append(i)
    dist = np.full((n, n), 127, np.int32)
    for s in range(n):
        dist[s, s] = 0
        frontier = [s]
        d = 0
        while frontier:
            d += 1
            nxt = []
            for u in frontier:
                for v in adj[u]:
                    if dist[s, v] > d:
                        dist[s, v] = d
                        nxt.append(v)
            frontier = nxt
    return dist


@dataclass
class TorsionTree:
    """Host-side pose parameterisation for one ligand.

    axes: [K, 2] atom indices (a on the root side, b on the moving side);
    move: [K, N] bool — atoms rotated by torsion k (everything beyond b);
    ordered root to leaf so that axis coordinates are current when each
    torsion is applied.  intra_pairs: [P, 2] ligand atom pairs scored
    intramolecularly (different rigid groups, graph distance >= 4 — the
    1-2/1-3/1-4 exclusion, Vina's convention).
    """

    n_atoms: int
    axes: np.ndarray        # [K, 2] int32
    move: np.ndarray        # [K, N] bool
    intra_pairs: np.ndarray  # [P, 2] int32
    n_rot: int

    @classmethod
    def from_molecule(cls, mol: Molecule) -> "TorsionTree":
        n = mol.n_atoms
        rot = _rotatable_bonds(mol)
        gd = _graph_distances(n, mol.bonds)

        # rigid groups: connected components after cutting rotatable bonds
        cut = {frozenset(b) for b in rot}
        parent = list(range(n))

        def find(x):
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        for i, j, _ in mol.bonds:
            if frozenset((i, j)) in cut:
                continue
            parent[find(i)] = find(j)
        group = np.array([find(i) for i in range(n)])

        # root = largest rigid group (AutoDock convention); BFS over the
        # group tree gives the root-to-leaf torsion order
        sizes = {g: int((group == g).sum()) for g in set(group.tolist())}
        root_g = max(sizes, key=lambda g: (sizes[g], -g))
        axes, move = [], []
        # bond -> which side moves: the side NOT containing the root group,
        # found by BFS from the root group over rotatable bonds
        adj = {}
        for (i, j) in rot:
            adj.setdefault(group[i], []).append((i, j))
            adj.setdefault(group[j], []).append((i, j))
        seen_g = {root_g}
        frontier = [root_g]
        seen_b = set()
        while True:
            while frontier:
                nxt = []
                for g in frontier:
                    for (i, j) in adj.get(g, []):
                        key = (i, j)
                        if key in seen_b:
                            continue
                        seen_b.add(key)
                        a, b = (i, j) if group[i] == g else (j, i)
                        # moving set: atoms closer to b than to a in hop
                        # count (b's side of the cut); atoms of OTHER
                        # disconnected fragments have 127 on both sides
                        # and stay fixed
                        mv = gd[b] < gd[a]
                        axes.append((a, b))
                        move.append(mv)
                        gb = group[b]
                        if gb not in seen_g:
                            seen_g.add(gb)
                            nxt.append(gb)
                frontier = nxt
            # disconnected fragments (common in generated molecules):
            # restart the BFS from each remaining fragment's largest
            # rigid group so that its torsions are parameterised too
            left = [g for g in adj if g not in seen_g]
            if not left:
                break
            root2 = max(left, key=lambda g: (sizes[g], -g))
            seen_g.add(root2)
            frontier = [root2]
        k = len(axes)
        axes_arr = (np.asarray(axes, np.int32) if k
                    else np.zeros((0, 2), np.int32))
        move_arr = (np.asarray(move, bool) if k
                    else np.zeros((0, n), bool))

        ii, jj = np.triu_indices(n, 1)
        flex = (group[ii] != group[jj]) & (gd[ii, jj] >= 4)
        intra = np.stack([ii[flex], jj[flex]], -1).astype(np.int32)
        return cls(n_atoms=n, axes=axes_arr, move=move_arr,
                   intra_pairs=intra, n_rot=k)


# ---------------------------------------------------------------------------
# batched scoring + pose transform (torch; leading dims are poses)
# ---------------------------------------------------------------------------

def _vina_pair_terms(ds, hydro_ij, polar_ij):
    """Weighted Vina interaction energy per pair from surface distances
    (the five terms and constants of scoring.py)."""
    gauss1 = torch.exp(-((ds / 0.5) ** 2))
    gauss2 = torch.exp(-(((ds - 3.0) / 2.0) ** 2))
    repulsion = torch.where(ds < 0, ds ** 2, 0.0)
    h = (1.5 - ds).clamp(0.0, 1.0) * hydro_ij
    g = (-ds / 0.7).clamp(0.0, 1.0) * polar_ij
    return (W_GAUSS1 * gauss1 + W_GAUSS2 * gauss2 + W_REPULSION * repulsion
            + W_HYDROPHOBIC * h + W_HBOND * g)


def _safe_norm(v, dim=-1):
    """sqrt(sum(v^2) + eps): a finite gradient at v == 0, unlike
    torch.linalg.norm, whose NaN there leaks through torch.where masks
    (padded torsion axes and padded intra pairs sit exactly at 0)."""
    return torch.sqrt((v * v).sum(dim) + 1e-12)


def _quat_to_mat(q):
    """[..., 4] quaternions (any norm) -> [..., 3, 3] rotations."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1).unflatten(-1, (3, 3))


def _axis_rot(u, theta):
    """Rodrigues rotation matrices [..., 3, 3] about unit axes u [..., 3]
    by angles theta [...]."""
    c, s = torch.cos(theta)[..., None, None], torch.sin(theta)[..., None, None]
    ux, uy, uz = u.unbind(-1)
    zero = torch.zeros_like(ux)
    K = torch.stack([zero, -uz, uy, uz, zero, -ux, -uy, ux, zero],
                    -1).unflatten(-1, (3, 3))
    eye = torch.eye(3, dtype=u.dtype, device=u.device)
    return c * eye + s * K + (1 - c) * (u[..., :, None] * u[..., None, :])


def _rotate_about(x, a, R):
    """x [..., N, 3] rotated by R [..., 3, 3] about the points a [..., 3]."""
    return (x - a[..., None, :]) @ R.mT + a[..., None, :]


def make_pose_fn(tree: TorsionTree, lig_x0: np.ndarray, device=None):
    """pose(trans [..., 3], quat [..., 4], torsions [..., K]) -> ligand
    coordinates [..., N, 3].

    Torsions applied root to leaf on current coordinates (so that nested
    axes track earlier rotations), then the rigid quaternion about the
    conformer centroid, then translation of the centroid to `trans`
    (absolute coordinates)."""
    device = resolve_device(device)
    x0 = torch.as_tensor(np.asarray(lig_x0, np.float32), device=device)
    axes = tree.axes
    move = torch.as_tensor(tree.move, device=device)[..., None]
    K = tree.n_rot

    def pose(trans, quat, torsions):
        x = x0.expand(*trans.shape[:-1], *x0.shape)
        for k in range(K):
            a = x[..., axes[k, 0], :]
            b = x[..., axes[k, 1], :]
            u = (b - a) / (_safe_norm(b - a)[..., None] + 1e-9)
            R = _axis_rot(u, torsions[..., k])
            x = torch.where(move[k], _rotate_about(x, a, R), x)
        com = x.mean(-2, keepdim=True)
        return (x - com) @ _quat_to_mat(quat).mT + trans[..., None, :]

    return pose


def _ligand_typing(mol: Molecule, lig_x: np.ndarray):
    """(radii, hydrophobic, donor, acceptor, neighbour-mean operator,
    has-neighbour) of a ligand: its topology types it where it has bonds,
    else every polar atom is both donor and acceptor."""
    r, hydro, polar = _atom_properties(lig_x, mol.symbols)
    if mol.bonds:
        don, acc = ligand_hbond_types(mol)
        anb, has_nb = neighbor_mean_operator(mol)
    else:
        don = acc = polar
        anb = np.zeros((len(lig_x), len(lig_x)), np.float32)
        has_nb = np.zeros(len(lig_x), bool)
    return r, hydro, don, acc, anb, has_nb


def _ligand_directions(x, anb, has_nb):
    """Pose-covariant ligand base directions for the directional H-bond
    weight (see scoring.py): x [..., N, 3] -> (dir [..., N, 3], has
    [..., N])."""
    v = x - anb @ x
    nv = _safe_norm(v)[..., None]
    return (torch.where(nv > 1e-4, v / nv, 0.0),
            has_nb & (nv[..., 0] > 1e-4))


def make_score_fn(tree: TorsionTree, mol: Molecule, scorer: VinaScorer,
                  center: np.ndarray, box_size: float, device=None):
    """Batched pose objective.  Returns (objective(params) -> [...],
    inter(params) -> [...], pose) where params = (trans [..., 3], quat
    [..., 4], torsions [..., K]); objective = inter + intra + box penalty;
    `inter` alone (all receptor pairs within 8 A) is what the affinity
    estimate divides by the N_rot factor, as scoring.py does."""
    device = resolve_device(device)

    def t(a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    lig_x0 = np.asarray(mol.coords, np.float32)
    lig_r, lig_hydro, lig_don, lig_acc, anb, has_nb = _ligand_typing(
        mol, lig_x0)

    # receptor atoms that any in-box ligand atom could see within cutoff
    ctr = np.asarray(center, np.float32)
    lig_radius = float(np.linalg.norm(
        lig_x0 - lig_x0.mean(0), axis=-1).max())
    reach = box_size / 2.0 + lig_radius + _CUTOFF
    keep = np.linalg.norm(scorer.rec_x - ctr, axis=-1) <= reach
    rec_x = t(scorer.rec_x[keep], torch.float32)
    rec_r = t(scorer.rec_r[keep], torch.float32)
    rec_h = scorer.rec_hydro[keep]
    rec_don = scorer.rec_donor[keep]
    rec_acc = scorer.rec_acceptor[keep]
    rec_hd = t(scorer.rec_hdir[keep], torch.float32)
    rec_hh = t(scorer.rec_hdir_has[keep])
    directional = bool(getattr(scorer, "directional_hbond", False))
    a_op, t_has_nb = t(anb), t(has_nb)

    lr = t(lig_r, torch.float32)
    inter_hydro = t(lig_hydro[:, None] & rec_h[None])
    # hbond pairs: ligand donor vs receptor acceptor, either direction
    inter_polar = t((lig_don[:, None] & rec_acc[None])
                    | (lig_acc[:, None] & rec_don[None]))

    ip = tree.intra_pairs
    if len(ip):
        intra_r = t(lig_r[ip[:, 0]] + lig_r[ip[:, 1]], torch.float32)
        intra_hydro = t(lig_hydro[ip[:, 0]] & lig_hydro[ip[:, 1]])
        intra_polar = t((lig_don[ip[:, 0]] & lig_acc[ip[:, 1]])
                        | (lig_acc[ip[:, 0]] & lig_don[ip[:, 1]]))

    pose = make_pose_fn(tree, lig_x0, device)
    half = box_size / 2.0
    cj = t(ctr)

    def inter_energy(x):
        d = torch.linalg.norm(x[..., :, None, :] - rec_x, dim=-1)
        ds = d - (lr[:, None] + rec_r)
        polar_w = inter_polar.float()
        if directional:
            ldir, lhas = _ligand_directions(x, a_op, t_has_nb)
            polar_w = polar_w * hbond_direction_weight_torch(
                x, ldir, lhas, rec_x, rec_hd, rec_hh, d)
        e = _vina_pair_terms(ds, inter_hydro, polar_w)
        return torch.where(d < _CUTOFF, e, 0.0).sum((-2, -1))

    def both(trans, quat, torsions):
        x = pose(trans, quat, torsions)
        inter = inter_energy(x)
        intra = 0.0
        if len(ip):
            dd = _safe_norm(x[..., ip[:, 0], :] - x[..., ip[:, 1], :])
            e = _vina_pair_terms(dd - intra_r, intra_hydro, intra_polar)
            intra = torch.where(dd < _CUTOFF, e, 0.0).sum(-1)
        # qvina2 restricts poses to the grid box; a quadratic penalty on
        # atoms leaving it keeps the objective smooth
        out = ((x - cj).abs() - half).clamp_min(0.0)
        box_pen = (out ** 2).sum((-2, -1))
        return inter + intra + 10.0 * box_pen, inter

    def objective(trans, quat, torsions):
        return both(trans, quat, torsions)[0]

    def inter_of(trans, quat, torsions):
        return both(trans, quat, torsions)[1]

    return objective, inter_of, pose


# ---------------------------------------------------------------------------
# optimiser and draws
# ---------------------------------------------------------------------------

def _cosine_lr(lr: float, sched_len: int, count: int) -> float:
    """optax.cosine_decay_schedule(lr, sched_len, alpha=0.05)(count),
    in float32 as optax computes it."""
    f32 = np.float32
    c = f32(min(count, sched_len))
    decay = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * c / f32(sched_len)))
    return float(f32(lr) * (f32(1 - LR_ALPHA) * decay + f32(LR_ALPHA)))


def adam_refine(objective, params, n: int, sched_len: int, lr: float):
    """n steps of optax's ``adam(cosine_decay_schedule(lr, sched_len,
    alpha=0.05))`` on ``objective(*params).sum()``, from a fresh state:
    the moments in optax's order, bias corrections of the incremented
    count, and each step at the rate of the count before the increment.
    Returns the new params (detached)."""
    params = [p.detach() for p in params]
    mu = [torch.zeros_like(p) for p in params]
    nu = [torch.zeros_like(p) for p in params]
    sched_len = max(sched_len, 1)
    f32 = np.float32
    for count in range(n):
        leaves = [p.requires_grad_(True) for p in params]
        with torch.enable_grad():
            loss = objective(*leaves).sum()
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        c1 = float(f32(1) - f32(B1) ** f32(count + 1))
        c2 = float(f32(1) - f32(B2) ** f32(count + 1))
        step = -_cosine_lr(lr, sched_len, count)
        with torch.no_grad():
            for i, (p, g) in enumerate(zip(leaves, grads)):
                if g is None:       # a parameter the energy does not read
                    g = torch.zeros_like(p)
                mu[i] = (1 - B1) * g + B1 * mu[i]
                nu[i] = (1 - B2) * (g * g) + B2 * nu[i]
                u = (mu[i] / c1) / (torch.sqrt(nu[i] / c2) + EPS)
                params[i] = p.detach() + step * u
    return params


@dataclass
class PoseDraws:
    """The random numbers of one search: ``trans`` uniform in [-box/2,
    box/2] [..., P, 3], ``quat`` standard normal [..., P, 4], ``tors``
    uniform in [-pi, pi] [..., P, K]; ``mc``, one (trans, quat, tors)
    triple of standard normals of the same shapes per MC round."""
    trans: torch.Tensor
    quat: torch.Tensor
    tors: torch.Tensor
    mc: List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = field(
        default_factory=list)

    def to(self, device) -> "PoseDraws":
        return PoseDraws(*(torch.as_tensor(a, dtype=torch.float32,
                                           device=device)
                           for a in (self.trans, self.quat, self.tors)),
                         [tuple(torch.as_tensor(a, dtype=torch.float32,
                                                device=device) for a in r)
                          for r in self.mc])


def draw_poses(seed: int, lead: Tuple[int, ...], k: int, mc_rounds: int,
               box_size: float, device) -> PoseDraws:
    """PoseDraws of shape lead + (3 | 4 | k) from a torch.Generator seeded
    by ``seed`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen,
                                           device=device)

    def normal(shape):
        return torch.randn(shape, generator=gen, device=device)

    half = box_size / 2.0
    shapes = (lead + (3,), lead + (4,), lead + (k,))
    return PoseDraws(uniform(shapes[0], -half, half), normal(shapes[1]),
                     uniform(shapes[2], -math.pi, math.pi),
                     [tuple(normal(s) for s in shapes)
                      for _ in range(mc_rounds)])


def _perturb(params, noise, scale: float):
    t, q, th = params
    nt, nq, nth = noise
    return (t + scale * nt, q + 0.3 * scale * nq,
            th + (np.pi / 2) * scale * nth)


def _select(take, best, cand):
    """Per restart: cand where take [...] is set, else best."""
    return [torch.where(take.reshape(take.shape + (1,) * (b.ndim
                                                         - take.ndim)), c, b)
            for b, c in zip(best, cand)]


# ---------------------------------------------------------------------------
# the search
# ---------------------------------------------------------------------------

@dataclass
class DockResult:
    coords: np.ndarray        # [N, 3] best pose
    affinity: float           # inter / (1 + w_rot * n_rot), kcal/mol-like
    inter: float
    objective: float
    n_rot: int
    n_restarts: int
    all_affinities: np.ndarray  # [P] per-restart final affinities
    # top distinct binding modes (qvina2's num_modes output): poses
    # sorted by objective, greedily deduplicated at 2 A RMSD — None on
    # paths that do not compute them (batched dock_molecules)
    top_poses: Optional[np.ndarray] = None      # [K, N, 3]
    top_affinities: Optional[np.ndarray] = None  # [K]


def cluster_poses(coords_all: np.ndarray, order: np.ndarray,
                  rmsd_thresh: float = 2.0, max_modes: int = 9
                  ) -> List[int]:
    """Greedy Vina-style mode clustering: walk poses in score order,
    keep one representative per >= rmsd_thresh-distinct cluster."""
    reps: List[int] = []
    for i in order:
        xi = coords_all[i]
        distinct = True
        for j in reps:
            if np.sqrt(((xi - coords_all[j]) ** 2).sum(-1).mean()) \
                    < rmsd_thresh:
                distinct = False
                break
        if distinct:
            reps.append(int(i))
            if len(reps) >= max_modes:
                break
    return reps


def dock_molecule(mol: Molecule, scorer: VinaScorer,
                  center: Optional[np.ndarray] = None,
                  box_size: float = 20.0, n_restarts: int = 256,
                  steps: int = 200, mc_rounds: int = 2,
                  seed: int = 0, lr: float = 0.25, device=None,
                  draws: Optional[PoseDraws] = None) -> DockResult:
    """Dock one ligand: batched random restarts, Adam refinement, and
    basin-hopping rounds (perturb, re-optimise, keep improvements) — the
    parallel analogue of qvina2's MC+BFGS at exhaustiveness ~ n_restarts.
    The box is centred on `center` (the ligand's centroid when None).
    draws: [P, ...] PoseDraws with ``mc_rounds`` MC triples (default:
    drawn on the device from ``seed``)."""
    if mol.coords is None:
        raise ValueError("ligand needs 3D coordinates")
    device = resolve_device(device)
    tree = TorsionTree.from_molecule(mol)
    ctr = (np.asarray(mol.coords, np.float32).mean(0)
           if center is None else np.asarray(center, np.float32))
    objective, inter_of, pose = make_score_fn(tree, mol, scorer, ctr,
                                              box_size, device)
    K, P = tree.n_rot, n_restarts
    if draws is None:
        draws = draw_poses(seed, (P,), K, mc_rounds, box_size, device)
    draws = draws.to(device)

    trans = torch.as_tensor(ctr, device=device) + draws.trans * 0.8
    quat = draws.quat.clone()
    tors = draws.tors[:, :K].clone()
    # restart 0 = the input pose (local refinement of the given
    # conformer: for a generated molecule, the pose the model placed in
    # the pocket, the one qvina2's --local_only would refine)
    com0 = np.asarray(mol.coords, np.float32).mean(0)
    trans[0] = torch.as_tensor(com0, device=device)
    quat[0] = torch.tensor([1.0, 0.0, 0.0, 0.0], device=device)
    tors[0] = 0.0

    best = adam_refine(objective, (trans, quat, tors), steps, steps, lr)
    with torch.no_grad():
        best_obj = objective(*best).cpu().numpy()
        for r in range(mc_rounds):
            cand = adam_refine(objective, _perturb(best, draws.mc[r], 1.0),
                               steps // 2, steps, lr)
            obj = objective(*cand).cpu().numpy()
            take = obj < best_obj
            best = _select(torch.as_tensor(take, device=device), best, cand)
            best_obj = np.where(take, obj, best_obj)

        inter = inter_of(*best).cpu().numpy()
        all_x = pose(*best).cpu().numpy()              # [P, N, 3]
    denom = 1.0 + W_NROT * tree.n_rot
    aff = inter / denom
    i_best = int(best_obj.argmin())
    reps = cluster_poses(all_x, np.argsort(best_obj))
    return DockResult(coords=all_x[i_best], affinity=float(aff[i_best]),
                      inter=float(inter[i_best]),
                      objective=float(best_obj[i_best]),
                      n_rot=tree.n_rot, n_restarts=P,
                      all_affinities=aff,
                      top_poses=all_x[reps],
                      top_affinities=aff[reps])


def calculate_native_dock_score(receptor_file: str, sdf_file: str,
                                out_dir: Optional[str] = None,
                                box_size: float = 20.0,
                                n_restarts: int = 256, steps: int = 200,
                                seed: int = 0, device=None) -> List[float]:
    """The native analogue of docking.calculate_qvina2_score: docks every
    molecule of `sdf_file` into the receptor, the box at each ligand's
    centroid (size 20, qvina2's default here), returns one affinity per
    molecule and optionally writes the docked poses to
    ``out_dir/<name>_docked.sdf``.

    A molecule the batched search rejects (ValueError, which the
    sanitizer's errors are) sends the file to one search per molecule,
    where such a molecule scores NaN.  Any other error, a CUDA one
    included, ends the call."""
    from diffndm_tpu_torch.chem.io import read_sdf, write_sdf

    device = resolve_device(device)
    scorer = VinaScorer.from_pdb(receptor_file)
    mols = read_sdf(sdf_file)
    try:
        batch = dock_molecules(mols, scorer, box_size=box_size,
                               n_restarts=n_restarts, steps=steps,
                               seed=seed, device=device)
    except ValueError as e:
        print(f"[dock] batched path failed ({type(e).__name__}: {e}); "
              f"falling back per molecule", flush=True)
        batch = [None] * len(mols)
    scores: List[float] = []
    docked = []
    for i, (mol, res) in enumerate(zip(mols, batch)):
        if res is None and mol is not None and mol.coords is not None:
            try:  # per-molecule fallback if the batch path failed
                res = dock_molecule(mol, scorer, box_size=box_size,
                                    n_restarts=n_restarts, steps=steps,
                                    seed=seed + i, device=device)
            except ValueError as e:
                print(f"[dock] molecule {i} failed "
                      f"({type(e).__name__}: {e})", flush=True)
                res = None
        if res is None:
            scores.append(float("nan"))
            docked.append(mol)
            continue
        scores.append(res.affinity)
        docked.append(Molecule(symbols=list(mol.symbols),
                               bonds=list(mol.bonds), coords=res.coords))
    if out_dir is not None:
        import os

        os.makedirs(out_dir, exist_ok=True)
        base = os.path.splitext(os.path.basename(sdf_file))[0]
        write_sdf(os.path.join(out_dir, f"{base}_docked.sdf"), docked)
    return scores


# ---------------------------------------------------------------------------
# batched multi-molecule docking (shape-bucketed)
# ---------------------------------------------------------------------------

def _ceil_to(n: int, m: int) -> int:
    return -(-max(n, 1) // m) * m


def bucket_key(mol: Molecule, tree: TorsionTree) -> Tuple[int, int, int]:
    """(padded atoms, padded torsions, padded intra pairs)."""
    return (_ceil_to(mol.n_atoms, 8), _ceil_to(tree.n_rot, 4),
            _ceil_to(len(tree.intra_pairs), 64))


def bucket_molecules(mols: Sequence[Optional[Molecule]]
                     ) -> Dict[Tuple[int, int, int], list]:
    """Molecules with coordinates by bucket key, as (index, mol, tree)
    items in input order."""
    buckets: dict = {}
    for i, mol in enumerate(mols):
        if mol is None or mol.coords is None:
            continue
        tree = TorsionTree.from_molecule(mol)
        buckets.setdefault(bucket_key(mol, tree), []).append((i, mol, tree))
    return buckets


def bucket_arrays(items, centers, n_pad: int, k_pad: int, p_pad: int):
    """The host arrays of one bucket, in ``_bucket_both``'s order: (x0,
    amask, radii, hydrophobic, donor, acceptor, neighbour operator,
    has-neighbour, axes, torsion mask, move, intra pairs, intra mask,
    intra radii, intra hydrophobic, intra polar, centres), and the largest
    ligand radius about its centroid."""
    M = len(items)
    x0 = np.zeros((M, n_pad, 3), np.float32)
    amask = np.zeros((M, n_pad), np.float32)
    lr_a = np.zeros((M, n_pad), np.float32)
    lhyd = np.zeros((M, n_pad), bool)
    ldon = np.zeros((M, n_pad), bool)
    lacc = np.zeros((M, n_pad), bool)
    anb = np.zeros((M, n_pad, n_pad), np.float32)
    hnb = np.zeros((M, n_pad), bool)
    axes = np.zeros((M, k_pad, 2), np.int32)
    tmask = np.zeros((M, k_pad), bool)
    move = np.zeros((M, k_pad, n_pad), bool)
    ip = np.zeros((M, p_pad, 2), np.int32)
    imask = np.zeros((M, p_pad), np.float32)
    ir = np.zeros((M, p_pad), np.float32)
    ihyd = np.zeros((M, p_pad), bool)
    ipol = np.zeros((M, p_pad), bool)
    ctr = np.zeros((M, 3), np.float32)
    radius = 0.0
    for m, (i, mol, tree) in enumerate(items):
        n, k, p = mol.n_atoms, tree.n_rot, len(tree.intra_pairs)
        xm = np.asarray(mol.coords, np.float32)
        x0[m, :n] = xm
        amask[m, :n] = 1.0
        r_, h_, d_, a_, A_, hn_ = _ligand_typing(mol, xm)
        lr_a[m, :n] = r_
        lhyd[m, :n] = h_
        ldon[m, :n] = d_
        lacc[m, :n] = a_
        anb[m, :n, :n] = A_
        hnb[m, :n] = hn_
        if k:
            axes[m, :k] = tree.axes
            tmask[m, :k] = True
            move[m, :k, :n] = tree.move
        if p:
            i0, i1 = tree.intra_pairs[:, 0], tree.intra_pairs[:, 1]
            ip[m, :p] = tree.intra_pairs
            imask[m, :p] = 1.0
            ir[m, :p] = r_[i0] + r_[i1]
            ihyd[m, :p] = h_[i0] & h_[i1]
            ipol[m, :p] = (d_[i0] & a_[i1]) | (a_[i0] & d_[i1])
        c = centers[i]
        ctr[m] = xm.mean(0) if c is None else np.asarray(c, np.float32)
        radius = max(radius, float(np.linalg.norm(
            xm - xm.mean(0), axis=-1).max()))
    return ((x0, amask, lr_a, lhyd, ldon, lacc, anb, hnb, axes, tmask, move,
             ip, imask, ir, ihyd, ipol, ctr), radius)


def receptor_crop(scorer: VinaScorer, ctr: np.ndarray, reach: float):
    """The receptor atoms within `reach` of any centre, in
    ``_bucket_both``'s order: (coords, radii, hydrophobic, donor,
    acceptor, base directions, has-direction); a scorer without
    directional H-bonds gets no directions."""
    keep = (np.linalg.norm(scorer.rec_x[None] - ctr[:, None], axis=-1)
            <= reach).any(0)
    has = (scorer.rec_hdir_has[keep]
           if getattr(scorer, "directional_hbond", False)
           else np.zeros(int(keep.sum()), bool))
    return (scorer.rec_x[keep].astype(np.float32),
            scorer.rec_r[keep].astype(np.float32), scorer.rec_hydro[keep],
            scorer.rec_donor[keep], scorer.rec_acceptor[keep],
            scorer.rec_hdir[keep].astype(np.float32), has)


def _gather_atoms(x, idx):
    """x [M, P, N, 3], idx [M, J] -> x[m, p, idx[m, j]]: [M, P, J, 3]."""
    M, P, _, _ = x.shape
    return torch.gather(x, 2, idx[:, None, :, None].expand(
        M, P, idx.shape[1], 3))


def _pose_padded(x0m, am, axm, tm, mvm, quat, tors):
    """[M, P, N, 3] poses without translation: torsions (root to leaf,
    padded axes masked by tm) and the rigid rotation about the REAL-atom
    centroid."""
    M, P = quat.shape[:2]
    x = x0m[:, None].expand(M, P, *x0m.shape[1:])
    for k in range(axm.shape[1]):
        ab = _gather_atoms(x, axm[:, k])            # [M, P, 2, 3]
        a, b = ab[:, :, 0], ab[:, :, 1]
        u = (b - a) / (_safe_norm(b - a)[..., None] + 1e-9)
        R = _axis_rot(u, tors[..., k])
        x = torch.where((tm[:, k, None] & mvm[:, k])[:, None, :, None],
                        _rotate_about(x, a, R), x)
    na = am.sum(-1).clamp_min(1.0)
    com = (x * am[:, None, :, None]).sum(-2) / na[:, None, None]
    return (x - com[..., None, :]) @ _quat_to_mat(quat).mT


def _bucket_both(consts, rec, half, trans, quat, tors):
    """(objective [M, P], inter [M, P]) for one shape bucket: consts and
    rec as tensors in the orders of ``bucket_arrays`` and
    ``receptor_crop`` (index arrays as int64), trans [M, P, 3], quat
    [M, P, 4], tors [M, P, K]."""
    (x0m, am, lrm, lhm, ldm, lam, anm, hnm, axm, tm, mvm, ipm, imm, irm,
     ihm, ipolm, cm) = consts
    rec_x, rec_r, rec_h, rec_don, rec_acc, rec_hd, rec_hh = rec
    x = (_pose_padded(x0m, am, axm, tm, mvm, quat, tors)
         + trans[..., None, :])                       # [M, P, N, 3]
    d = torch.linalg.norm(x[..., :, None, :] - rec_x, dim=-1)
    ds = d - (lrm[:, None, :, None] + rec_r)
    pw = ((ldm[..., None] & rec_acc) | (lam[..., None] & rec_don)).float()
    # directional H-bond weight; an all-False rec_hh (a non-directional
    # scorer) makes it a no-op
    ldir, lhas = _ligand_directions(x, anm[:, None], hnm[:, None])
    pw = pw[:, None] * hbond_direction_weight_torch(
        x, ldir, lhas, rec_x, rec_hd, rec_hh, d)
    e = _vina_pair_terms(ds, (lhm[..., None] & rec_h)[:, None], pw)
    within = (d < _CUTOFF) & (am[:, None, :, None] > 0.5)
    inter = torch.where(within, e, 0.0).sum((-2, -1))
    xi = _gather_atoms(x, ipm[..., 0])
    xj = _gather_atoms(x, ipm[..., 1])
    dd = _safe_norm(xi - xj)                          # [M, P, p_pad]
    ei = _vina_pair_terms(dd - irm[:, None], ihm[:, None], ipolm[:, None])
    intra = torch.where((dd < _CUTOFF) & (imm[:, None] > 0.5), ei,
                        0.0).sum(-1)
    out = (((x - cm[:, None, None]).abs() - half).clamp_min(0.0)
           * am[:, None, :, None])
    return inter + intra + 10.0 * (out ** 2).sum((-2, -1)), inter


def _to_device(arrays, device):
    """Host arrays -> tensors: float32 stays, bool stays, ints -> int64."""
    out = []
    for a in arrays:
        a = np.asarray(a)
        dtype = (torch.int64 if np.issubdtype(a.dtype, np.integer)
                 else None)
        out.append(torch.as_tensor(a, dtype=dtype, device=device))
    return tuple(out)


def dock_molecules(mols: Sequence[Molecule], scorer: VinaScorer,
                   centers: Optional[Sequence[np.ndarray]] = None,
                   box_size: float = 20.0, n_restarts: int = 128,
                   steps: int = 200, mc_rounds: int = 1, seed: int = 0,
                   lr: float = 0.25, device=None,
                   draws: Optional[Dict[tuple, PoseDraws]] = None
                   ) -> List[Optional[DockResult]]:
    """Dock a whole molecule list against one receptor: molecules are
    bucketed by padded (atoms, torsions, intra pairs) shape and each
    bucket runs as ONE [M, P]-batched optimisation over molecules x
    restarts, against one receptor crop — the sweep-scale path behind
    ``cli/evaluate.py --dock`` (a 20-molecule pocket sweep typically
    lands in 2-3 buckets).

    Semantics per molecule match dock_molecule (same terms, same
    restart-0 input pose); padded atoms, torsions and pairs are masked out
    of every term and the rigid rotation centres on the REAL-atom
    centroid.  draws: per bucket key, [M, P, ...] PoseDraws with
    ``mc_rounds`` MC triples (default: each bucket draws on the device
    from ``seed``).  Returns one DockResult per input (None for molecules
    without coordinates)."""
    device = resolve_device(device)
    if centers is None:
        centers = [None] * len(mols)
    results: List[Optional[DockResult]] = [None] * len(mols)
    P = n_restarts
    half = box_size / 2.0
    for key, items in sorted(bucket_molecules(mols).items()):
        n_pad, k_pad, _ = key
        M = len(items)
        host, radius = bucket_arrays(items, centers, *key)
        # shared receptor crop: atoms any in-box ligand atom could reach
        rec = _to_device(receptor_crop(scorer, host[-1],
                                       half + radius + _CUTOFF), device)
        consts = _to_device(host, device)

        def both(trans, quat, tors):
            return _bucket_both(consts, rec, half, trans, quat, tors)

        def objective(trans, quat, tors):
            return both(trans, quat, tors)[0]

        dr = (draws[key] if draws is not None else
              draw_poses(seed, (M, P), k_pad, mc_rounds, box_size,
                         device)).to(device)
        trans = consts[-1][:, None] + dr.trans * 0.8
        quat = dr.quat.clone()
        tors = dr.tors.clone()
        # restart 0 = input pose (the generated placement)
        x0, amask = host[0], host[1]
        com0 = (x0 * amask[..., None]).sum(1) \
            / np.maximum(amask.sum(1), 1)[:, None]
        trans[:, 0] = torch.as_tensor(com0, device=device)
        quat[:, 0] = torch.tensor([1.0, 0.0, 0.0, 0.0], device=device)
        tors[:, 0] = 0.0

        best = adam_refine(objective, (trans, quat, tors), steps, steps,
                           lr)
        with torch.no_grad():
            best_obj = objective(*best).cpu().numpy()        # [M, P]
            for r in range(mc_rounds):
                cand = adam_refine(objective, _perturb(best, dr.mc[r], 1.0),
                                   steps // 2, steps, lr)
                obj = objective(*cand).cpu().numpy()
                take = obj < best_obj
                best = _select(torch.as_tensor(take, device=device), best,
                               cand)
                best_obj = np.where(take, obj, best_obj)

            obj_f, inter_f = (v.cpu().numpy() for v in both(*best))
            x_all = (_pose_padded(*consts[:2], *consts[8:11], best[1],
                                  best[2])
                     + best[0][..., None, :]).cpu().numpy()
        for m, (i, mol, tree) in enumerate(items):
            denom = 1.0 + W_NROT * tree.n_rot
            aff = inter_f[m] / denom
            ib = int(obj_f[m].argmin())
            results[i] = DockResult(
                coords=x_all[m, ib, :mol.n_atoms], affinity=float(aff[ib]),
                inter=float(inter_f[m, ib]),
                objective=float(obj_f[m, ib]), n_rot=tree.n_rot,
                n_restarts=P, all_affinities=aff)
    return results
