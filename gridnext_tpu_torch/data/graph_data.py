"""Visium arrays as graphs for the graph node classifier.

The port's copy of the JAX package's ``data/graph_data.py``: a graph is a
dict of numpy arrays, ``nodes`` (N, n_genes) in-tissue spot counts,
``edges`` (2, E) sender/receiver pairs between hex-adjacent spots, ``pos``
(N, 2) pseudo-hex (array_col, array_row), ``y`` node labels (or None),
``classes`` and ``n_node``/``n_edge`` per array. Without annotations
(``register``) the nodes follow the positions file's in-tissue order; with
Loupe annotations they are the annotated in-tissue spots in the
annotation file's order, or, with ``keep_unannotated``, every in-tissue
spot with ``y = -1`` where unannotated. Adjacency comes from the hex
lattice in O(N); :func:`pad_graph` pads to static sizes.
"""

from __future__ import annotations

import csv
import gzip
import hashlib
from typing import Optional

import numpy as np

from gridnext_tpu_torch.geometry import HEX_TAPS_R1
from gridnext_tpu_torch.io.annotations import _NA, _label_strings
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


def _loupe_labels(annot_file) -> dict:
    """{barcode: label} of a Loupe CSV's annotated rows (blank cells, as
    pandas reads them, dropped)."""
    with open(str(annot_file), newline="") as fh:
        rows = [r for r in csv.reader(fh) if r][1:]
    rows = [r for r in rows if len(r) > 1 and r[1] not in _NA]
    return dict(zip([r[0] for r in rows], _label_strings([r[1] for r in rows])))


def read_visium_graph(spaceranger_dir, annot_file=None, keep_unannotated: bool = False):
    """One array -> ``(x, edges, arr_coords, y)``: (spots, genes) float32
    counts, their (2, E) hex edges, (spots, 2) pseudo-hex (array_col,
    array_row) and the string labels (None without ``annot_file``).

    Without annotations the spots are the in-tissue ones in positions-file
    order. With ``annot_file`` they are the annotated in-tissue spots in
    the file's order, or with ``keep_unannotated`` every in-tissue spot
    (label ``''`` where unannotated), so training sees the lattice that
    ``register`` serves. Only the kept columns of the matrix are made
    dense."""
    files = find_feature_matrix_files(spaceranger_dir)
    pos = read_positions(spaceranger_dir)
    tissue = np.flatnonzero(pos["in_tissue"] == 1)
    y = None
    if annot_file is not None:
        labels = _loupe_labels(annot_file)
        if keep_unannotated:
            y = np.array([labels.get(pos.barcodes[i], "") for i in tissue], dtype=object)
        else:
            where = {pos.barcodes[i]: i for i in tissue}
            seen, kept = set(), []
            for b in labels:
                if b in where and b not in seen:
                    seen.add(b)
                    kept.append(where[b])
            tissue = np.asarray(kept, dtype=np.int64)
            y = np.array([labels[pos.barcodes[i]] for i in tissue], dtype=object)
    barcodes = [pos.barcodes[i] for i in tissue]
    counts, _, _ = read_feature_matrix(individual_files=files, barcodes=barcodes)
    arr_coords = np.stack([pos["array_col"][tissue], pos["array_row"][tissue]],
                          axis=1).astype(np.int64)
    return counts.T.astype(np.float32), hex_adjacency(arr_coords), arr_coords, y


def visium_to_graphdata(spaceranger_dirs, annot_files=None,
                        keep_unannotated: bool = False) -> dict:
    """Several arrays as one graph, node indices offset per array.

    Labels: classes sort alphanumerically; unannotated nodes kept by
    ``keep_unannotated`` get ``y = -1``. Raises ValueError when the arrays'
    feature axes differ (node features concatenate on gene position) or
    when only some arrays are annotated.
    """
    if isinstance(spaceranger_dirs, str):
        spaceranger_dirs = [spaceranger_dirs]
        annot_files = [annot_files] if annot_files is not None else None
    if annot_files is None:
        annot_files = [None] * len(spaceranger_dirs)
    if len(annot_files) != len(spaceranger_dirs):
        raise ValueError("need one annotation file per array")
    xs, es, ps, ys = [], [], [], []
    offset = 0
    feature_ids = first_srd = None
    for srd, afile in zip(spaceranger_dirs, annot_files):
        ids = _feature_ids(srd)
        if feature_ids is None:
            feature_ids, first_srd = ids, srd
        elif ids != feature_ids:
            raise ValueError(
                f"feature axes differ between {first_srd} "
                f"({len(feature_ids)} genes) and {srd} ({len(ids)} genes); "
                "graph node features need one shared gene ordering")
        x, e, pos, y = read_visium_graph(srd, afile, keep_unannotated=keep_unannotated)
        xs.append(x)
        es.append(e + offset)
        ps.append(pos)
        ys.append(y)
        offset += x.shape[0]

    classes = y_enc = None
    if any(y is not None for y in ys):
        if any(y is None for y in ys):
            raise ValueError(
                "annot_files mixes annotated and unannotated arrays; node "
                "labels need an annotation file per array")
        y_all = np.concatenate(ys)
        labeled = y_all != ""
        classes = np.unique(y_all[labeled])
        y_enc = np.full(len(y_all), -1, np.int64)
        y_enc[labeled] = np.searchsorted(classes, y_all[labeled])
    return {"nodes": np.concatenate(xs, axis=0), "edges": np.concatenate(es, axis=1),
            "pos": np.concatenate(ps, axis=0), "y": y_enc,
            "n_node": np.asarray([x.shape[0] for x in xs], np.int64),
            "n_edge": np.asarray([e.shape[1] for e in es], np.int64),
            "classes": classes}


def pad_graph(graph: dict, n_node_pad: int, n_edge_pad: Optional[int] = None) -> dict:
    """Pad a graph to static sizes and add a ``node_mask``.

    Padding nodes are zero rows (``y = -1``); padding edges (to the next
    multiple of 128 by default) are self-loops on the first padding node,
    so real nodes receive no padding messages. Raises ValueError for pads
    smaller than the graph, or padding edges without a padding node.
    """
    n = graph["nodes"].shape[0]
    e = graph["edges"].shape[1]
    if n_node_pad < n:
        raise ValueError(f"pad {n_node_pad} < {n} nodes")
    if n_edge_pad is None:
        n_edge_pad = ((e + 127) // 128) * 128
    if n_edge_pad < e:
        raise ValueError(f"pad {n_edge_pad} < {e} edges")
    if n_edge_pad > e and n_node_pad == n:
        raise ValueError(
            "padding edges require at least one padding node: pass "
            f"n_node_pad > {n}")
    out = dict(graph)
    out["nodes"] = np.pad(graph["nodes"], [(0, n_node_pad - n), (0, 0)])
    out["pos"] = np.pad(graph["pos"], [(0, n_node_pad - n), (0, 0)])
    out["edges"] = np.concatenate(
        [graph["edges"], np.full((2, n_edge_pad - e), n, dtype=np.int64)], axis=1)
    if graph.get("y") is not None and graph["y"].shape[0] == n:
        out["y"] = np.pad(graph["y"], (0, n_node_pad - n), constant_values=-1)
    out["node_mask"] = np.arange(n_node_pad) < n
    return out
