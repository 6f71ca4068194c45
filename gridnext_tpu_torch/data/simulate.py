"""Pseudo-Visium simulation: complete Spaceranger-shaped fixtures.

The port of the JAX package's ``data/simulate.py``, file for file: the
same seeds give the same positions, scalefactors, MEX matrix, Loupe
annotations and fullres JPEG (the port's encoder, Pillow's bytes). The
full 78 x 64 lattice (or a square Visium HD bin grid) is generated: synthetic or real Visium v1
barcodes, v1/v2 positions CSVs or an HD positions parquet
(:func:`~gridnext_tpu_torch.io.parquet.write_parquet`), and a MEX count
matrix. At full transcriptome width (16,906 genes) the simulated counts
are nearly dense, ~24 M matrix lines an array, so the MEX text is
formatted with numpy (:func:`~gridnext_tpu_torch.io.tsv_codec.format_int_rows`)
and gzipped at level 9 in members on a thread pool; the inflated bytes
equal the JAX package's.
"""

from __future__ import annotations

import gzip
import json
from pathlib import Path

import numpy as np

from gridnext_tpu_torch import geometry
from gridnext_tpu_torch.io.tsv_codec import _pool_map, format_int_rows

_MEX_LINES = 1 << 20      # matrix lines a gzip member holds


def lattice_positions(h_st: int = geometry.VISIUM_H_ST, w_st: int = geometry.VISIUM_W_ST):
    """All ``(barcode, array_col, array_row)`` of the full lattice, with
    synthetic ``SYN{col}X{row}-1`` barcodes."""
    rows = np.repeat(np.arange(h_st), w_st)
    cols_oddr = np.tile(np.arange(w_st), h_st)
    col, row = geometry.oddr_to_pseudo_hex(cols_oddr, rows)
    barcodes = np.array([f"SYN{c:03d}X{r:03d}-1" for c, r in zip(col, row)])
    return barcodes, col, row


def _gzip_members(path, texts, level: int = 9) -> None:
    """Write byte strings as consecutive gzip members (one a string,
    compressed on the pool): an ordinary gzip file."""
    members = _pool_map(lambda t: gzip.compress(t, compresslevel=level, mtime=0), texts)
    with open(path, "wb") as fh:
        for m in members:
            fh.write(m)


def _mex_text_chunks(counts: np.ndarray, n_barcodes: int) -> list:
    """The ``matrix.mtx`` text of ``counts`` (barcodes x genes): the header,
    then ``gene barcode count`` (1-based) of every nonzero in gene-major
    order, as byte strings of at most ``_MEX_LINES`` lines."""
    ct = counts.T
    g, b = np.nonzero(ct)
    head = (b"%%MatrixMarket matrix coordinate integer general\n%\n"
            + f"{ct.shape[0]} {n_barcodes} {len(g)}\n".encode())

    def chunk(lo):
        gg, bb = g[lo:lo + _MEX_LINES], b[lo:lo + _MEX_LINES]
        return format_int_rows(np.stack([gg + 1, bb + 1, ct[gg, bb]], axis=1), sep=32)

    return [head] + _pool_map(chunk, range(0, len(g), _MEX_LINES))


def _positions_csv(columns: dict, header: bool) -> str:
    names = list(columns)
    lines = [",".join(names)] if header else []
    lines += [",".join(str(v) for v in row)
              for row in zip(*(columns[n].tolist() for n in names))]
    return "\n".join(lines) + "\n"


def simulate_spaceranger_dir(dest_dir, *, n_genes: int = 60, n_classes: int = 4,
                             seed: int = 0, tissue_fraction: float = 0.6,
                             image: bool = False, spot_spacing_px: int = 12,
                             spaceranger_version=2, gene_names=None, hd_grid=None,
                             hd_binning: str = "square_008um",
                             barcodes: str = "synthetic") -> dict:
    """Create ``dest_dir`` as a simulated Spaceranger output directory.

    The tissue is an ellipse; its annotation classes are concentric bands
    (spatially coherent), and each class draws its genes from Poisson rates
    of its own (Gamma(2, 2), fixed across arrays), so both a spot
    classifier and a corrector have signal.

    ``spaceranger_version``: 1 (headerless ``tissue_positions_list.csv``),
    2 (``tissue_positions.csv``) or ``"hd"`` (``outs/binned_outputs/
    <hd_binning>``: a positions parquet and that binning's MEX; on the
    78 x 64 lattice, or with ``hd_grid=(h, w)`` on a square bin lattice).
    ``barcodes='visium_v1'`` stamps the real Visium v1 whitelist
    (:mod:`~gridnext_tpu_torch.data.template`) onto the lattice.
    ``gene_names``: the symbols of ``features.tsv.gz`` (IDs are
    ``ENSG{i:05d}``). ``image=True`` writes a fullres JPEG at Pillow's quality
    95 (:func:`~gridnext_tpu_torch.io.jpeg.encode_jpeg`, no PIL).

    Returns a dict with the paths, the (h, w) ground-truth ``label_grid``,
    the class names and ``n_genes``.
    """
    if not 0 < tissue_fraction <= 1:
        raise ValueError(f"tissue_fraction must be in (0, 1]; got {tissue_fraction}")
    rng = np.random.default_rng(seed)
    dest = Path(dest_dir)
    spatial = dest / "outs" / "spatial"
    matdir = dest / "outs" / "filtered_feature_bc_matrix"
    spatial.mkdir(parents=True, exist_ok=True)

    if hd_grid is not None and spaceranger_version != "hd":
        raise ValueError("hd_grid requires spaceranger_version='hd'")
    if hd_grid is not None:
        if barcodes != "synthetic":
            raise ValueError("barcodes='visium_v1' applies to the Visium "
                             "pseudo-hex lattice; HD bin barcodes are "
                             "coordinate-derived")
        h_st, w_st = int(hd_grid[0]), int(hd_grid[1])
        row = np.repeat(np.arange(h_st), w_st)
        col = np.tile(np.arange(w_st), h_st)
        um = hd_binning.split("_")[-1]
        barcodes = np.array([f"s_{um}_{r:05d}_{c:05d}-1" for r, c in zip(row, col)])
        xs, ys = col.astype(float), row.astype(float)
    else:
        h_st, w_st = geometry.VISIUM_H_ST, geometry.VISIUM_W_ST
        bc_syn, col, row = lattice_positions()
        if barcodes == "visium_v1":
            if spaceranger_version == "hd":
                raise ValueError("barcodes='visium_v1' applies to v1/v2 "
                                 "layouts (HD barcodes are coordinate-"
                                 "derived)")
            from gridnext_tpu_torch.data.template import visium_v1_barcode_grid

            ox_all, oy_all = geometry.pseudo_hex_to_oddr(col, row)
            barcodes = visium_v1_barcode_grid()[oy_all, ox_all].astype(str)
        elif barcodes == "synthetic":
            barcodes = bc_syn
        else:
            raise ValueError(f"barcodes must be 'synthetic' or "
                             f"'visium_v1'; got {barcodes!r}")
        xs, ys = geometry.pseudo_to_true_hex(col, row)

    cx, cy = np.mean(xs), np.mean(ys)
    rx = (xs.max() - xs.min()) / 2 * tissue_fraction
    ry = (ys.max() - ys.min()) / 2 * tissue_fraction
    r2 = ((xs - cx) / rx) ** 2 + ((ys - cy) / ry) ** 2
    in_tissue = (r2 <= 1.0).astype(int)
    band = np.minimum((np.sqrt(r2) * n_classes).astype(int), n_classes - 1)
    labels = np.where(in_tissue == 1, band + 1, 0)
    margin = 2 * spot_spacing_px
    px_col = np.rint(xs * spot_spacing_px + margin).astype(int)
    px_row = np.rint(ys * spot_spacing_px + margin).astype(int)

    pos = {"barcode": np.asarray(barcodes), "in_tissue": in_tissue, "array_row": row,
           "array_col": col, "pxl_row_in_fullres": px_row, "pxl_col_in_fullres": px_col}
    if isinstance(spaceranger_version, str) and spaceranger_version != "hd":
        raise ValueError(
            f"spaceranger_version must be 1, 2, or 'hd'; got {spaceranger_version!r}")
    if spaceranger_version == "hd":
        from gridnext_tpu_torch.io.parquet import write_parquet

        bin_spatial = dest / "outs" / "binned_outputs" / hd_binning / "spatial"
        bin_spatial.mkdir(parents=True, exist_ok=True)
        pos_path = bin_spatial / "tissue_positions.parquet"
        write_parquet(pos_path, {k: (v.tolist() if k == "barcode" else np.asarray(v, np.int64))
                                 for k, v in pos.items()})
        matdir = dest / "outs" / "binned_outputs" / hd_binning / "filtered_feature_bc_matrix"
    elif spaceranger_version >= 2:
        pos_path = spatial / "tissue_positions.csv"
        pos_path.write_text(_positions_csv(pos, header=True))
    else:
        pos_path = spatial / "tissue_positions_list.csv"
        pos_path.write_text(_positions_csv(pos, header=False))

    scale = {"spot_diameter_fullres": spot_spacing_px * 0.55,
             "fiducial_diameter_fullres": spot_spacing_px * 0.85,
             "tissue_hires_scalef": 0.1, "tissue_lowres_scalef": 0.03}
    with open(spatial / "scalefactors_json.json", "w") as fh:
        json.dump(scale, fh)

    keep = in_tissue == 1
    kept_barcodes = np.asarray(barcodes)[keep]
    if not len(kept_barcodes):
        raise ValueError("simulated tissue ellipse contains no spots; "
                         "increase tissue_fraction or the grid size")
    # class signatures belong to the tissue, not the array: one fixed
    # generator for every simulated array
    sig_rng = np.random.default_rng(20260816 + n_genes * 1000 + n_classes)
    rates = sig_rng.gamma(2.0, 2.0, size=(n_classes, n_genes))
    counts = rng.poisson(rates[labels[keep] - 1])       # (n_spots, n_genes)

    gene_ids = [f"ENSG{i:05d}" for i in range(n_genes)]
    if gene_names is None:
        gene_names = [f"Gene{i}" for i in range(n_genes)]
    elif len(gene_names) != n_genes:
        raise ValueError(f"gene_names has {len(gene_names)} entries, expected {n_genes}")
    matdir.mkdir(parents=True, exist_ok=True)
    features = "".join(f"{gid}\t{gname}\tGene Expression\n"
                       for gid, gname in zip(gene_ids, gene_names))
    _gzip_members(matdir / "features.tsv.gz", [features.encode()])
    _gzip_members(matdir / "barcodes.tsv.gz", [("\n".join(kept_barcodes) + "\n").encode()])
    _gzip_members(matdir / "matrix.mtx.gz", _mex_text_chunks(counts, len(kept_barcodes)))

    class_names = [f"Layer{i + 1}" for i in range(n_classes)]
    annot_path = dest / f"{dest.name}_annotations.csv"
    annot_path.write_text("Barcode,AARs\n" + "".join(
        f"{b},{class_names[lab - 1]}\n" for b, lab in zip(kept_barcodes, labels[keep])))

    img_path = None
    if image:
        from gridnext_tpu_torch.io.jpeg import encode_jpeg

        W = int(px_col.max() + margin)
        H = int(px_row.max() + margin)
        img = np.full((H, W, 3), 255, dtype=np.uint8)
        # class colours belong to the tissue like the gene signatures
        pal_rng = np.random.default_rng(20260816 + n_classes)
        palette = (np.stack([pal_rng.permutation(256)[:n_classes]
                             for _ in range(3)], 1)).astype(np.uint8)
        rad = spot_spacing_px // 2
        for x0, y0, lab in zip(px_col[keep], px_row[keep], labels[keep]):
            img[max(0, y0 - rad):y0 + rad, max(0, x0 - rad):x0 + rad] = palette[lab - 1]
        img_path = dest / f"{dest.name}_fullres.jpg"
        img_path.write_bytes(encode_jpeg(img, quality=95))

    label_grid = np.zeros((h_st, w_st), dtype=np.int64)
    if hd_grid is not None:
        label_grid[row, col] = labels
    else:
        ox, oy = geometry.pseudo_hex_to_oddr(col, row)
        label_grid[oy, ox] = labels
    return {"spaceranger_dir": str(dest), "position_file": str(pos_path),
            "annot_file": str(annot_path), "image_file": str(img_path) if img_path else None,
            "label_grid": label_grid, "class_names": class_names, "n_genes": n_genes}


def pseudo_visium_from_image(fullres_roi, dest_dir, image_width_mm: float = 8,
                             spot_width_um: float = 55, spot_spacing_um: float = 100,
                             template: str = "visium_v1") -> str:
    """Simulated Visium files for a cropped tissue image: writes
    ``<dest>/<image stem>/outs/spatial/{tissue_positions.csv,
    scalefactors_json.json}`` placing the 78 x 64 lattice over the image
    (``data/simulate.py:247-323``). ``template='visium_v1'``: the real
    slide template's barcodes, in-tissue pattern and scalefactors (spot
    and fiducial diameters rescaled to ``spot_width_um``);
    ``'synthetic'``: ``SYN`` barcodes, every spot in tissue. Reads a JPEG's,
    TIFF's or PNG's header with the port's readers and any other image with
    PIL. Returns the created directory."""
    from gridnext_tpu_torch.io.jpeg import is_jpeg_file, jpeg_info
    from gridnext_tpu_torch.io.png import is_png_file, png_info
    from gridnext_tpu_torch.io.tiff import is_tiff_file, tiff_info

    # the first dimension (the height), as the reference takes it
    if is_jpeg_file(fullres_roi):
        w_px = jpeg_info(fullres_roi)["height"]
    elif is_tiff_file(fullres_roi):
        w_px = tiff_info(fullres_roi)["height"]
    elif is_png_file(fullres_roi):
        w_px = png_info(fullres_roi)["height"]
    else:
        try:
            from PIL import Image
        except ImportError as e:
            raise ImportError("pseudo_visium_from_image reads images other than JPEG, TIFF "
                              "and PNG with PIL, which is not installed") from e

        w_px = np.asarray(Image.open(fullres_roi)).shape[0]
    px_per_mm = w_px / image_width_mm
    spot_width_px = px_per_mm * spot_width_um / 1000
    spot_space_px = px_per_mm * spot_spacing_um / 1000
    ul = int(np.rint(0.75 * px_per_mm + spot_width_px / 2))

    if template == "visium_v1":
        from gridnext_tpu_torch.data.template import visium_v1_scalefactors, visium_v1_template

        pos = visium_v1_template()
        barcodes, col, row = pos["barcode"], pos["array_col"], pos["array_row"]
        in_tissue = pos["in_tissue"]
        scale = visium_v1_scalefactors()
        scale["fiducial_diameter_fullres"] = (
            scale["fiducial_diameter_fullres"] / scale["spot_diameter_fullres"] * spot_width_px)
        scale["spot_diameter_fullres"] = spot_width_px
    elif template == "synthetic":
        barcodes, col, row = lattice_positions()
        in_tissue = np.ones(len(barcodes), int)
        scale = {"spot_diameter_fullres": spot_width_px,
                 "fiducial_diameter_fullres": spot_width_px * 85 / 55,
                 "tissue_hires_scalef": 0.1, "tissue_lowres_scalef": 0.03}
    else:
        raise ValueError(f"template must be 'visium_v1' or 'synthetic'; got {template!r}")
    x_hex, y_hex = geometry.pseudo_to_true_hex(col, row)
    columns = {"barcode": np.asarray(barcodes), "in_tissue": np.asarray(in_tissue),
               "array_row": np.asarray(row), "array_col": np.asarray(col),
               "pxl_row_in_fullres": np.rint(ul + y_hex * spot_space_px).astype(int),
               "pxl_col_in_fullres": np.rint(ul + x_hex * spot_space_px).astype(int)}
    arr_name = Path(fullres_roi).stem.replace(" ", "_")
    out_dir = Path(dest_dir) / arr_name / "outs" / "spatial"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "tissue_positions.csv").write_text(_positions_csv(columns, header=True))
    with open(out_dir / "scalefactors_json.json", "w") as fh:
        json.dump(scale, fh)
    return str(Path(dest_dir) / arr_name)
