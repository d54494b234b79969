"""The yardstick's arithmetic: operations and bytes of the edge-chain
kernels, the denoiser's FLOPs and the card's peaks.  Frozen copies, so
that a change to the program does not move them:

- ``fwd_call_cost``: ``chip_smoke.py``'s ``call_cost`` and ``bwd_call_cost``
  its ``bwd_cost`` (repository commit c481f2b), taking edge counts in
  place of the adjacency;
- ``forward_flops``: ``diffndm_tpu_torch/utils/flops.egnn_flops_analytic``
  (commit c481f2b), counted over the edges that the inputs have under the
  configuration's cutoffs instead of every dense N^2 slot;
- ``PEAKS``: the published dense peaks of ``utils/flops.py`` (commit
  c481f2b) and NVIDIA's H100 SXM data sheet.
"""

from __future__ import annotations

from typing import Optional, Tuple

# published dense peaks (no sparsity) at the 700 W power limit, keyed by a
# prefix of torch.cuda.get_device_name()
PEAKS = {"NVIDIA H100": {"tf32": 495e12, "bf16": 989e12, "fp32": 67e12,
                         "hbm_bytes": 3.35e12}}
# the tensor-core rate each configuration precision runs its products at
PRECISION_PEAK = {"float32": "tf32", "bfloat16": "bf16"}


def peaks(device_kind: str) -> Optional[dict]:
    for prefix, table in PEAKS.items():
        if device_kind.startswith(prefix):
            return table
    return None


def fwd_call_cost(kind: str, b: int, n: int, h: int, rows: int,
                  edges: int) -> Tuple[float, float]:
    """(operations, bytes) of one forward kernel call: ``kind`` is
    ``gcl_messages`` (all n rows) or ``edge_vector_reduce_pair`` (two
    weight sets over the first ``rows`` rows); ``edges`` the adjacency's
    nonzeros among the rows computed."""
    gcl = kind == "gcl_messages"
    n_sets = 1 if gcl else 2
    per_edge = 2 * h * h + 2 * h + (2 * h if gcl else 30)
    node = n_sets * (b * rows * h + b * n * h)
    planes = 3 * b * rows * n
    weights = n_sets * (h * h + 5 * h)
    if gcl:
        out, extra = b * n * h, 0
    else:
        out, extra = b * n * 3, b * n * 3 + b * 3
    return (float(n_sets * edges * per_edge),
            float(4 * (node + planes + weights + extra + out)))


def bwd_call_cost(kind: str, b: int, n: int, h: int, rows: int,
                  edges: int) -> Tuple[float, float]:
    """(operations, bytes) of one backward call (two launches), as
    ``fwd_call_cost``: 6H^2 + 24H operations per edge and weight set."""
    gcl = kind == "gcl_messages"
    n_sets = 1 if gcl else 2
    per_edge = 6 * h * h + 24 * h
    node = n_sets * 2 * (b * rows * h + b * n * h)
    planes = 3 * b * rows * n + 2 * b * rows * n
    weights = 2 * n_sets * (h * h + 5 * h)
    if gcl:
        extra = 2 * b * n * h
    else:
        extra = 2 * (b * n * 3 + b * 3) + b * n * 3
    return (float(n_sets * edges * per_edge),
            float(4 * (node + planes + weights + extra)))


def least_seconds(ops: float, nbytes: float, peak: dict,
                  precision: str) -> float:
    """The larger of the operations at the precision's tensor-core peak
    and the bytes at the memory bandwidth."""
    return max(ops / peak[PRECISION_PEAK[precision]],
               nbytes / peak["hbm_bytes"])


def forward_flops(hp: dict, b: int, n_lig: int, n: int, edges: int,
                  lig_edges: int) -> float:
    """Dominant-matmul FLOPs of one denoiser forward of ``b`` rows of
    ``n`` nodes (``n_lig`` ligand rows): 2*m*n*k per dense layer over the
    nodes, and per edge over ``edges`` (the GCLs, all rows) and
    ``lig_edges`` (the coordinate chains, ligand rows) summed over the
    batch:

    per GCL        node: src/dst/n1(2H->H)/n2  = 5*H^2 (+ H)
                   edge: W2 H^2 + W_e e*H + att H
    per EqUpdate   node: coord_src/dst + cross_src/dst = 4*H^2
                   edge: 2 chains of (H^2 + e*H + H)
    """
    h = hp["hidden_nf"]
    jn = hp["joint_nf"]
    e = 1 + (hp.get("edge_embedding_dim") or 0)
    subl = hp.get("inv_sublayers", 1)
    cross = 0 if hp["reflection_equivariant"] else 1
    per_gcl_node = 5 * h * h + h
    per_gcl_edge = h * h + e * h + (h if hp["attention"] else 0)
    per_equ_node = (2 + 2 * cross) * h * h
    per_equ_edge = (1 + cross) * (h * h + e * h + h)
    per_layer_nodes = b * n * (subl * per_gcl_node + per_equ_node)
    per_layer_edges = edges * subl * per_gcl_edge + lig_edges * per_equ_edge
    embed = b * (n * (jn + 1) * h + n * h * (jn + 1))
    return 2.0 * (hp["n_layers"] * (per_layer_nodes + per_layer_edges)
                  + embed)


def window_costs(records, hp: dict, peak: Optional[dict], backward: bool):
    """From every forward's kept inputs (z_lig, xh_pocket, lig_mask,
    pocket_mask, traced): the edges each needs under the configuration's
    cutoffs; the traced forwards' least kernel time (the forward kernels',
    or with ``backward`` the backward kernels', of every layer; None
    without a peak for this card); the untraced forwards' model FLOPs
    (three forwards each for a training step).  Returns (least_s, traced,
    untraced_flops)."""
    import torch

    from benchmark.reference.egnn import adjacency

    precision = hp.get("compute_dtype", "float32")
    cost = bwd_call_cost if backward else fwd_call_cost
    h, layers = hp["hidden_nf"], hp["n_layers"]
    least, flops, traced = 0.0, 0.0, 0
    counts = [torch.stack([a.sum(), a[:, :z.shape[1]].sum()])
              for z, p, lm, pm, _ in records
              for a in [adjacency(z[..., :3], p[..., :3], lm, pm, hp)]]
    counts = torch.stack(counts).cpu().tolist() if counts else []
    for (z, p, lm, pm, in_trace), (e_all, e_lig) in zip(records, counts):
        b, nl = lm.shape
        n = nl + pm.shape[1]
        if in_trace:
            traced += 1
            if peak is not None:
                for kind, rows, e in (("gcl_messages", n, e_all),
                                      ("edge_vector_reduce_pair", nl, e_lig)):
                    ops, nbytes = cost(kind, b, n, h, rows, int(e))
                    least += layers * least_seconds(ops, nbytes, peak,
                                                    precision)
        else:
            flops += (3.0 if backward else 1.0) * forward_flops(
                hp, b, nl, n, int(e_all), int(e_lig))
    return (least if peak is not None else None), traced, flops
