"""The port's pose search (diffndm_tpu_torch/chem/dock.py) against the
JAX package's chem/dock.py on the same inputs: test ligands of
data/processed/virtual_v3 (bonds perceived) in their own pocket, written
as PDB with one ALA residue per atom.

- TorsionTree (axes, moving sets, intra pairs, n_rot) is equal, also on a
  molecule of two disconnected fragments.
- At identical parameters, in fp32: pose coordinates, objective and inter
  energy agree elementwise within rtol 1e-5 / atol 1e-5; the gradient
  with respect to (trans, quat, torsions) agrees per tensor within rtol
  1e-5 of the tensor's largest component plus atol 1e-5.  A component's
  own scale is not the measure there: it is a sum of pair terms whose
  largest parts (clashes at random poses) are 10-100x the net value, so
  rounding in another order (torch's and XLA's sin, cos, norms and 3x3
  products differ in the last bit) shows at the scale of the largest.
  This holds for make_score_fn and for the bucketed ``_bucket_both``
  with padded atoms, torsions and intra pairs.
- dock_molecule and dock_molecules, with JAX's own draws injected (the
  key splits of its ``dock.py``), in a short search (8 Adam steps, one MC
  round of 4, 8 restarts): the same best restart per molecule, and poses
  and objectives within the tolerances stated at SEARCH_*.
- cluster_poses and the bucket keys are equal; a RuntimeError inside the
  batched search propagates out of calculate_native_dock_score, while a
  ValueError (a bad molecule) sends it one molecule at a time.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_jax_native import pin_jax_native  # noqa: E402

pin_jax_native()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from diffndm_tpu.chem import dock as jd  # noqa: E402
from diffndm_tpu.chem import scoring as js  # noqa: E402
from diffndm_tpu.chem.mol import Molecule as JMol  # noqa: E402
from diffndm_tpu_torch.chem import dock as td  # noqa: E402
from diffndm_tpu_torch.chem import scoring as ts  # noqa: E402
from diffndm_tpu_torch.chem.bonds import build_molecule  # noqa: E402
from diffndm_tpu_torch.chem.mol import Molecule  # noqa: E402
from diffndm_tpu_torch.constants import dataset_params  # noqa: E402
from diffndm_tpu_torch.data.dataset import \
    ProcessedLigandPocketDataset  # noqa: E402
from test_torch_scoring import pocket_pdb  # noqa: E402

INFO = dataset_params["crossdock_full"]
POCKET = 29                      # 34 pocket atoms
# test ligands: 13, 3, 0, 1, 4, 5 and 8 torsions; 1-4 share bucket key
# (16, 4, 64), so that the JAX package compiles one bucket shape here
LIGANDS = (52, 0, 24, 7, 9, 17, 29)
RTOL = ATOL = 1e-5
# a short search: 8 Adam steps + one MC round of 4 re-refine steps.  The
# two sides differ by rounding only (about 1e-5 here), but Adam moves each
# parameter by about lr * sign(gradient) in its first steps, so a gradient
# component at rounding level (a quaternion's radial direction) could step
# either way on either side.  The tolerance leaves room for such a step
# to fade while still catching any fault of the update itself; the best
# restart must be the same one.
SEARCH_COORD_ATOL = 1e-3         # A, best pose
SEARCH_OBJ_ATOL = 1e-3           # objective / affinity units
STEPS, ROUNDS, RESTARTS = 8, 1, 8


def to_jax_mol(m):
    return JMol(list(m.symbols), list(m.bonds),
                coords=np.asarray(m.coords, np.float64))


def fragments_molecule(a, b):
    """Two molecules side by side as one (disconnected) Molecule."""
    n = a.n_atoms
    return Molecule(list(a.symbols) + list(b.symbols),
                    list(a.bonds) + [(i + n, j + n, o)
                                     for i, j, o in b.bonds],
                    coords=np.concatenate([a.coords, b.coords + 3.0]))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    ds = ProcessedLigandPocketDataset("data/processed/virtual_v3/test.npz")
    mols = [build_molecule(ds[i].lig_coords, ds[i].lig_one_hot.argmax(1),
                           INFO) for i in LIGANDS]
    pair = ds[POCKET]
    pdb = pocket_pdb(pair, tmp_path_factory.mktemp("dock") / "pocket.pdb")
    # every ligand placed in the one pocket, centred on its ligand
    lig_ctr = pair.lig_coords.mean(0)
    for m in mols:
        m.coords = m.coords - m.coords.mean(0) + lig_ctr
    return dict(mols=mols, pdb=pdb, port=ts.VinaScorer.from_pdb(pdb),
                jax=js.VinaScorer.from_pdb(pdb))


def params(rng, lead, k, ctr):
    return ((ctr + rng.uniform(-4, 4, lead + (3,))).astype(np.float32),
            rng.normal(size=lead + (4,)).astype(np.float32),
            rng.uniform(-np.pi, np.pi, lead + (k,)).astype(np.float32))


def assert_close(port, ref, scale_of_tensor=False):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    bound = RTOL * (np.abs(ref).max() if scale_of_tensor
                    else np.abs(ref)) + ATOL
    assert (np.abs(port - ref) <= bound).all(), \
        float((np.abs(port - ref) / bound).max())


def grads_port(fn, p):
    leaves = [torch.tensor(a, requires_grad=True) for a in p]
    out = fn(*leaves)
    g = torch.autograd.grad(out.sum(), leaves, allow_unused=True)
    return out.detach().numpy(), [None if x is None else x.numpy()
                                  for x in g]


@pytest.mark.parametrize("which", list(range(len(LIGANDS))) + ["fragments"])
def test_torsion_tree_matches_jax(data, which):
    mols = data["mols"]
    mol = (fragments_molecule(mols[1], mols[5]) if which == "fragments"
           else mols[which])
    if which == "fragments":
        assert len(mol.fragments()) == 2
    port = td.TorsionTree.from_molecule(mol)
    ref = jd.TorsionTree.from_molecule(to_jax_mol(mol))
    assert port.n_rot == ref.n_rot and port.n_atoms == ref.n_atoms
    for name in ("axes", "move", "intra_pairs"):
        a, b = getattr(port, name), getattr(ref, name)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    if which == "fragments":     # both fragments' torsions are there
        n0 = mols[1].n_atoms
        assert (port.axes < n0).any() and (port.axes >= n0).any()


@pytest.mark.parametrize("which,directional", [(0, True), (0, False),
                                               (2, True)])
def test_score_fn_matches_jax_at_identical_params(data, directional, which):
    mol = data["mols"][which]
    port_sc, jax_sc = data["port"], data["jax"]
    port_sc.directional_hbond = jax_sc.directional_hbond = directional
    try:
        tree = td.TorsionTree.from_molecule(mol)
        ctr = np.asarray(mol.coords, np.float32).mean(0)
        pobj, pint, ppose = td.make_score_fn(tree, mol, port_sc, ctr, 20.0,
                                             device="cpu")
        jobj, jint, jpose = jd.make_score_fn(
            jd.TorsionTree.from_molecule(to_jax_mol(mol)), to_jax_mol(mol),
            jax_sc, ctr, 20.0)
    finally:
        port_sc.directional_hbond = jax_sc.directional_hbond = True
    p = params(np.random.default_rng(which), (16,), tree.n_rot, ctr)
    obj, grads = grads_port(pobj, p)

    @jax.jit
    def reference(*a):
        (_, out), g = jax.value_and_grad(
            lambda *b: (jobj(*b).sum(), jobj(*b)), argnums=(0, 1, 2),
            has_aux=True)(*a)
        return out, g, jint(*a), jax.vmap(jpose)(*a)

    jobj_p, jgrads, jinter, jx = reference(*p)
    assert_close(obj, jobj_p)
    tp = [torch.from_numpy(a) for a in p]
    assert_close(pint(*tp).numpy(), jinter)
    assert_close(ppose(*tp).numpy(), jx)
    for g, jg in zip(grads, jgrads):
        if g is None:            # no torsions: JAX's gradient is empty
            assert np.asarray(jg).size == 0
            continue
        assert np.isfinite(g).all()
        assert_close(g, jg, scale_of_tensor=True)


@pytest.fixture(scope="module")
def bucket(data):
    """Molecules of three bucket keys padded to one shape (atoms, torsions
    and intra pairs padded in each), on the pocket's receptor crop."""
    mols = [data["mols"][i] for i in (1, 2, 3)]
    items = [(i, m, td.TorsionTree.from_molecule(m))
             for i, m in enumerate(mols)]
    shape = tuple(max(k) for k in zip(*(td.bucket_key(m, t)
                                        for _, m, t in items)))
    host, radius = td.bucket_arrays(items, [None] * 3, *shape)
    rec = td.receptor_crop(data["port"], host[-1], 10.0 + radius + 8.0)
    return items, shape, host, rec


def test_bucket_both_matches_jax_with_padding(bucket):
    items, (n_pad, k_pad, p_pad), host, rec = bucket
    amask, tmask, imask = host[1], host[9], host[12]
    assert (amask == 0).any(axis=1).all() and (~tmask).any(axis=1).all() \
        and (imask == 0).any(axis=1).all()
    rng = np.random.default_rng(7)
    p = params(rng, (len(items), 6), k_pad, host[-1][:, None])
    consts = td._to_device(host, "cpu")
    trec = td._to_device(rec, "cpu")
    obj, grads = grads_port(
        lambda *a: td._bucket_both(consts, trec, 10.0, *a)[0], p)
    jc = tuple(jnp.asarray(a) for a in host)
    jr = tuple(jnp.asarray(a) for a in rec)
    jboth = jax.jit(jd._bucket_both)
    jobj, jinter = jboth(jc, jr, 10.0, *p)
    jgrads = jax.grad(lambda *a: jboth(jc, jr, 10.0, *a)[0].sum(),
                      argnums=(0, 1, 2))(*p)
    tp = [torch.from_numpy(a) for a in p]
    assert_close(obj, jobj)
    assert_close(td._bucket_both(consts, trec, 10.0, *tp)[1].numpy(), jinter)
    for g, jg in zip(grads, jgrads):
        assert np.isfinite(g).all()
        assert_close(g, jg, scale_of_tensor=True)
    x = (td._pose_padded(*consts[:2], *consts[8:11], tp[1], tp[2])
         + tp[0][..., None, :]).numpy()
    jx = np.stack([np.stack([
        np.asarray(jd._pose_one_padded(jc[0][m], jc[1][m], jc[8][m],
                                       jc[9][m], jc[10][m], p[1][m, r],
                                       p[2][m, r])) + p[0][m, r]
        for r in range(p[0].shape[1])]) for m in range(len(items))])
    assert_close(x, jx)


def jax_draws(seed, lead, k, rounds, half, k_draw=None):
    """The draws of JAX's dock.py for one search (dock_molecule draws
    k_draw = max(K, 1) torsion columns and keeps K)."""
    k1, k2, k3, key = jax.random.split(jax.random.PRNGKey(seed), 4)
    trans = jax.random.uniform(k1, lead + (3,), minval=-half, maxval=half)
    quat = jax.random.normal(k2, lead + (4,))
    tors = jax.random.uniform(k3, lead + (k_draw or k,), minval=-np.pi,
                              maxval=np.pi)[..., :k]
    mc = []
    for _ in range(rounds):
        key, sub = jax.random.split(key)
        kt, kq, ko = jax.random.split(sub, 3)
        mc.append(tuple(np.array(jax.random.normal(kk, lead + (n,)))
                        for kk, n in ((kt, 3), (kq, 4), (ko, k))))
    return td.PoseDraws(np.array(trans), np.array(quat), np.array(tors),
                        mc)


def best_restart(res):
    """The restart whose affinity the result reports (the argmin of the
    objective)."""
    (i,) = np.flatnonzero(res.all_affinities == res.affinity)[:1]
    return int(i)


def test_dock_molecule_matches_jax_with_its_draws(data):
    mol = data["mols"][4]
    k = td.TorsionTree.from_molecule(mol).n_rot
    draws = jax_draws(3, (RESTARTS,), k, ROUNDS, 10.0, max(k, 1))
    port = td.dock_molecule(mol, data["port"], n_restarts=RESTARTS,
                            steps=STEPS, mc_rounds=ROUNDS, seed=3,
                            device="cpu", draws=draws)
    ref = jd.dock_molecule(to_jax_mol(mol), data["jax"],
                           n_restarts=RESTARTS, steps=STEPS,
                           mc_rounds=ROUNDS, seed=3)
    assert port.n_rot == ref.n_rot == k and port.n_restarts == RESTARTS
    assert best_restart(port) == best_restart(ref)
    assert np.isclose(port.objective, ref.objective, rtol=0,
                      atol=SEARCH_OBJ_ATOL)
    np.testing.assert_allclose(port.all_affinities, ref.all_affinities,
                               rtol=0, atol=SEARCH_OBJ_ATOL)
    np.testing.assert_allclose(port.coords, ref.coords, rtol=0,
                               atol=SEARCH_COORD_ATOL)
    assert np.isclose(port.affinity, ref.affinity, rtol=0,
                      atol=SEARCH_OBJ_ATOL)
    assert port.top_poses.shape[1:] == (mol.n_atoms, 3)
    assert len(port.top_affinities) == len(port.top_poses)


def test_dock_molecules_matches_jax_with_its_draws(data):
    mols = [data["mols"][i] for i in (1, 2, 4)] + [None]
    buckets = td.bucket_molecules(mols)
    assert list(buckets) == [(16, 4, 64)]
    draws = {key: jax_draws(5, (len(items), RESTARTS), key[1], ROUNDS, 10.0)
             for key, items in buckets.items()}
    port = td.dock_molecules(mols, data["port"], n_restarts=RESTARTS,
                             steps=STEPS, mc_rounds=ROUNDS, seed=5,
                             device="cpu", draws=draws)
    ref = jd.dock_molecules([None if m is None else to_jax_mol(m)
                             for m in mols], data["jax"],
                            n_restarts=RESTARTS, steps=STEPS,
                            mc_rounds=ROUNDS, seed=5)
    assert port[-1] is None and ref[-1] is None
    for p, r in zip(port[:-1], ref[:-1]):
        assert p.n_rot == r.n_rot
        assert best_restart(p) == best_restart(r)
        np.testing.assert_allclose(p.all_affinities, r.all_affinities,
                                   rtol=0, atol=SEARCH_OBJ_ATOL)
        np.testing.assert_allclose(p.coords, r.coords, rtol=0,
                                   atol=SEARCH_COORD_ATOL)
        assert np.isclose(p.objective, r.objective, rtol=0,
                          atol=SEARCH_OBJ_ATOL)


def test_cluster_poses_and_bucket_keys_equal(data):
    rng = np.random.default_rng(2)
    coords = rng.normal(size=(24, 9, 3)) * 2.0
    coords[5] = coords[3] + 0.1              # a duplicate mode
    order = np.argsort(rng.normal(size=24))
    for thresh, modes in ((2.0, 9), (3.5, 4), (0.05, 30)):
        assert td.cluster_poses(coords, order, thresh, modes) == \
            jd.cluster_poses(coords, order, thresh, modes)
    mols = data["mols"] + [fragments_molecule(data["mols"][1],
                                              data["mols"][5])]
    for m in mols:
        jt = jd.TorsionTree.from_molecule(to_jax_mol(m))
        want = (jd._ceil_to(m.n_atoms, 8), jd._ceil_to(jt.n_rot, 4),
                jd._ceil_to(len(jt.intra_pairs), 64))
        assert td.bucket_key(m, td.TorsionTree.from_molecule(m)) == want


def test_batched_runtime_error_propagates(data, monkeypatch, tmp_path,
                                          capsys):
    from diffndm_tpu_torch.chem.io import write_sdf

    sdf = str(tmp_path / "ligs.sdf")
    write_sdf(sdf, data["mols"][:2])

    def fails(exc):
        def dock_molecules(*args, **kw):
            raise exc
        return dock_molecules

    monkeypatch.setattr(td, "dock_molecules",
                        fails(RuntimeError("CUDA error: an illegal memory "
                                           "access was encountered")))
    with pytest.raises(RuntimeError, match="illegal memory"):
        td.calculate_native_dock_score(data["pdb"], sdf, n_restarts=2,
                                       steps=1, device="cpu")
    # a bad molecule (ValueError) falls back to one search per molecule
    monkeypatch.setattr(td, "dock_molecules",
                        fails(ValueError("ligand needs 3D coordinates")))
    scores = td.calculate_native_dock_score(
        data["pdb"], sdf, out_dir=str(tmp_path / "out"), n_restarts=2,
        steps=1, device="cpu")
    assert "falling back per molecule" in capsys.readouterr().out
    assert len(scores) == 2 and np.isfinite(scores).all()
    assert (tmp_path / "out" / "ligs_docked.sdf").exists()


def test_default_draws_are_seeded_and_need_a_gpu(data, monkeypatch):
    mol = data["mols"][0]
    runs = [td.dock_molecule(mol, data["port"], n_restarts=4, steps=2,
                             mc_rounds=1, seed=s, device="cpu")
            for s in (1, 1, 2)]
    np.testing.assert_array_equal(runs[0].coords, runs[1].coords)
    assert not np.array_equal(runs[0].all_affinities, runs[2].all_affinities)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        td.dock_molecules([mol], data["port"], n_restarts=2, steps=1)
