"""Visium arrays as graphs for the graph node classifier.

The port's copy of the JAX package's ``data/graph_data.py`` without
annotations (as ``register`` uses it): a graph is a dict of numpy arrays,
``nodes`` (N, n_genes) in-tissue spot counts, ``edges`` (2, E)
sender/receiver pairs between hex-adjacent spots, ``pos`` (N, 2) pseudo-hex
(array_col, array_row), and ``n_node``/``n_edge`` per array. Nodes follow
the positions file's in-tissue order; adjacency comes from the hex
lattice in O(N).
"""

from __future__ import annotations

import gzip
import hashlib

import numpy as np

from gridnext_tpu_torch.geometry import HEX_TAPS_R1
from gridnext_tpu_torch.io.spaceranger import (find_feature_matrix_files,
                                               read_feature_matrix, read_positions)


def hex_adjacency(arr_coords: np.ndarray) -> np.ndarray:
    """(2, E) int64 directed edges between hex-adjacent pseudo-hex
    ``(array_col, array_row)`` coordinates, both directions, in the order
    of the spots and then of the radius-1 stencil taps."""
    coords = np.asarray(arr_coords, dtype=np.int64)
    index = {(int(c), int(r)): i for i, (c, r) in enumerate(coords)}
    # a tap (dr, dc_even, dc_odd) is (dc_even + dc_odd, dr) in pseudo-hex,
    # whose column offsets do not depend on the row's parity
    offsets = [(ce + co, dr) for dr, ce, co in HEX_TAPS_R1[1:]]
    send, recv = [], []
    for i, (c, r) in enumerate(coords):
        for dc, dr in offsets:
            j = index.get((int(c) + dc, int(r) + dr))
            if j is not None:
                send.append(i)
                recv.append(j)
    return np.asarray([send, recv], dtype=np.int64)


def _feature_ids(spaceranger_dir) -> list:
    """The MEX matrix's gene order: the first column of features.tsv.gz."""
    f = str(find_feature_matrix_files(spaceranger_dir)["features"])
    op = gzip.open if f.endswith(".gz") else open
    with op(f, "rt") as fh:
        return [line.split("\t", 1)[0] for line in fh]


def feature_axis_signature(spaceranger_dir) -> dict:
    """Identity of an array's MEX gene axis: ``{"n_genes", "sha256"}`` (the
    first 16 hex digits of the IDs' hash), as graph model directories
    record it."""
    ids = _feature_ids(spaceranger_dir)
    return {"n_genes": len(ids),
            "sha256": hashlib.sha256("\n".join(ids).encode()).hexdigest()[:16]}


def read_visium_graph(spaceranger_dir):
    """One array -> ``(x, edges, arr_coords)``: (spots, genes) float32 counts
    of the in-tissue spots in positions-file order, their (2, E) hex edges
    and (spots, 2) pseudo-hex (array_col, array_row). Only the in-tissue
    columns of the matrix are made dense."""
    files = find_feature_matrix_files(spaceranger_dir)
    pos = read_positions(spaceranger_dir)
    keep = pos["in_tissue"] == 1
    barcodes = [b for b, k in zip(pos.barcodes, keep) if k]
    counts, _, _ = read_feature_matrix(individual_files=files, barcodes=barcodes)
    arr_coords = np.stack([pos["array_col"][keep], pos["array_row"][keep]],
                          axis=1).astype(np.int64)
    return counts.T.astype(np.float32), hex_adjacency(arr_coords), arr_coords


def visium_to_graphdata(spaceranger_dirs) -> dict:
    """Several arrays as one graph, node indices offset per array.

    Raises ValueError when the arrays' feature axes differ (node features
    concatenate on gene position).
    """
    if isinstance(spaceranger_dirs, str):
        spaceranger_dirs = [spaceranger_dirs]
    xs, es, ps = [], [], []
    offset = 0
    feature_ids = first_srd = None
    for srd in spaceranger_dirs:
        ids = _feature_ids(srd)
        if feature_ids is None:
            feature_ids, first_srd = ids, srd
        elif ids != feature_ids:
            raise ValueError(
                f"feature axes differ between {first_srd} "
                f"({len(feature_ids)} genes) and {srd} ({len(ids)} genes); "
                "graph node features need one shared gene ordering")
        x, e, pos = read_visium_graph(srd)
        xs.append(x)
        es.append(e + offset)
        ps.append(pos)
        offset += x.shape[0]
    return {"nodes": np.concatenate(xs, axis=0), "edges": np.concatenate(es, axis=1),
            "pos": np.concatenate(ps, axis=0),
            "n_node": np.asarray([x.shape[0] for x in xs], np.int64),
            "n_edge": np.asarray([e.shape[1] for e in es], np.int64)}
