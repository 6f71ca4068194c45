"""Command line of the port: ``python -m gridnext_tpu_torch register ...``.

The ``register`` command of the JAX package's CLI, on the card: a trained
model directory (``model.json`` + ``g_state.msgpack``, as the JAX package's
``train-*`` commands write it) registers each Spaceranger directory and
writes a Loupe CSV (``Barcode,AARs``).

* Image models (``*TpuPatchClassifier``, ``*DenseNet121``) register the
  fullres slides (``--images``, one per ``--spaceranger`` directory) through
  :func:`~gridnext_tpu_torch.serving.register_slides`: decode and staging
  overlap registration, same-shape slides batch per call (``--slide-batch``).
  Square-lattice image models (``grid_dims``, Visium HD with
  ``hd_binning``) read each array's positions parquet, register dense
  lattices of a fractional pitch by resampling (``register_dense``) and the
  rest bin by bin, and write Loupe CSVs indexed by (array_row, array_col).
* Count models (``GridNet[Hex]+CountMLP``, as ``train-count`` writes
  them) register each directory's unified count cache (``prepare``'s
  ``<dir>.unified.tsv.gz``); with ``grid_dims`` on the square lattice.
* Multimodal models (``GridNetHexMM``, and ``GridNetMM`` with
  ``grid_dims``, as ``train-mm`` writes them) register each slide's patch
  grid, cropped on the card (or, for ``dense_ingest`` directories, tiled
  from the slide), beside the count grid of the directory's validated
  unified cache, mapped into the count f's input (scBERT's gene2vec space,
  or ``log1p``); the tissue comes from the raw counts.
* Graph models (``HexGCN``, as ``train-graph`` writes them) register each
  array's in-tissue spots as one hex graph over its MEX counts.

``--device`` (default ``cuda``) is where registration runs; ``--device cpu``
takes the kernels' plain versions. Exits and messages follow the JAX
package's ``register``.
"""

from __future__ import annotations

import argparse
import os
import sys


def _require_one_image_per_dir(images, spaceranger_dirs):
    if not images or len(images) != len(spaceranger_dirs):
        sys.exit("error: --images must list one fullres image per "
                 "--spaceranger directory")


def _validated_count_cache(srd, meta):
    """Path of ``srd``'s unified count cache, verified to exist and to carry
    the model's gene axis (mapped to a CLI exit)."""
    from gridnext_tpu_torch.io.unify import validated_unified_cache

    try:
        return validated_unified_cache(srd, meta.get("hd_binning"),
                                       genes=meta.get("genes"))
    except (FileNotFoundError, ValueError) as e:
        sys.exit(f"error: {e}")


def _write_loupe(label_grid, srd, args, classes, hd_binning=None, hex_coords=True,
                 index=None):
    """Loupe-CSV export of one array: a single file for one array, else
    ``<out>/<name>_loupe.csv``; directories that share a basename (the
    standard '.../outs' layout) get an ``NN_`` index prefix. ``hd_binning``
    picks the HD positions parquet, ``hex_coords=False`` a square grid."""
    from gridnext_tpu_torch.evaluate import to_loupe_annots
    from gridnext_tpu_torch.io import find_position_file
    from gridnext_tpu_torch.io.unify import array_name

    name = array_name(srd)
    names = [array_name(s) for s in args.spaceranger]
    if index is not None and names.count(name) > 1:
        name = f"{index:02d}_{name}"
    out_csv = (args.out if len(args.spaceranger) == 1
               else os.path.join(args.out, f"{name}_loupe.csv"))
    if len(args.spaceranger) > 1:
        os.makedirs(args.out, exist_ok=True)
    to_loupe_annots(label_grid, find_position_file(srd, hd_binning), out_csv,
                    annot_names=classes, hex_coords=hex_coords)
    print(f"registered {name} -> {out_csv}")


def _register_images(args, meta, classes, variables):
    from gridnext_tpu_torch.modeldir import image_registrar_from_meta
    from gridnext_tpu_torch.serving import register_slides

    _require_one_image_per_dir(args.images, args.spaceranger)
    registrar = image_registrar_from_meta(meta, classes, variables, device=args.device)
    hd_binning = meta.get("hd_binning")
    # decode and staging overlap registration; same-shape slides batch, and
    # dense square lattices register without the per-bin gather
    for i, label_grid, _pos in register_slides(registrar, args.images, args.spaceranger,
                                               hd_binning=hd_binning,
                                               slide_batch=args.slide_batch):
        _write_loupe(label_grid, args.spaceranger[i], args, classes, hd_binning=hd_binning,
                     hex_coords=meta.get("grid_dims") is None, index=i)


def _register_counts(args, meta, classes, variables):
    import numpy as np
    import torch

    from gridnext_tpu_torch.compat.from_jax import load_gridnet
    from gridnext_tpu_torch.data import CountGridDataset
    from gridnext_tpu_torch.modeldir import _count_mlp, _has_bn_corrector
    from gridnext_tpu_torch.models import GridNet, GridNetHex
    from gridnext_tpu_torch.serving import resolve_device

    device = resolve_device(args.device)
    n = len(classes)
    grid_dims = meta.get("grid_dims")       # square HD lattices (GridNet g)
    cls = GridNetHex if grid_dims is None else GridNet
    # CountMLP with BatchNorm, as the JAX package's register builds it
    g = cls(_count_mlp(variables, "patch_classifier", n), n_classes=n, f_dim=n,
            use_bn=_has_bn_corrector(variables))
    g = load_gridnet(g, variables).to(device).eval()
    lattice = {} if grid_dims is None else {
        "Visium": False, "h_st": int(grid_dims[0]), "w_st": int(grid_dims[1])}
    for i, srd in enumerate(args.spaceranger):
        cfile = _validated_count_cache(srd, meta)
        x, _ = CountGridDataset([cfile], **lattice)[0]
        fg = x.sum(-1) > 0              # tissue from the raw counts
        if meta.get("log1p"):
            x = np.log1p(x)
        with torch.no_grad():
            logits = g(torch.as_tensor(x[None], device=device))[0]
            labels = (torch.argmax(logits, -1) + 1).cpu().numpy()
        _write_loupe(np.where(fg, labels, 0), srd, args, classes,
                     hd_binning=meta.get("hd_binning"), hex_coords=grid_dims is None,
                     index=i)


def _scbert_count_transform(spaceranger_dirs, hd_binning, vocab: int):
    """modeldir.scbert_count_transform, its zero-overlap error mapped to a
    CLI exit."""
    from gridnext_tpu_torch.modeldir import scbert_count_transform

    try:
        return scbert_count_transform(spaceranger_dirs, hd_binning, vocab)
    except ValueError as e:
        sys.exit(f"error: {e}")


def _register_mm(args, meta, classes, variables):
    """Multimodal directories: each slide's patch grid on the card beside
    its count grid, through ``register_mm_grid``. Returns the stage seconds
    (decode, count read, crop + grid, count transform, forward, csv)."""
    import numpy as np

    from gridnext_tpu_torch.data import (DenseWSIGridDataset, MMStackDataset,
                                         create_visium_dataset)
    from gridnext_tpu_torch.modeldir import mm_model_from_meta
    from gridnext_tpu_torch.observability import StageTimer
    from gridnext_tpu_torch.serving import register_mm_grid, resolve_device

    _require_one_image_per_dir(args.images, args.spaceranger)
    # every cache must exist and carry the training gene axis before any
    # grid is built
    for srd in args.spaceranger:
        _validated_count_cache(srd, meta)
    hd_binning = meta.get("hd_binning")
    if meta.get("count_f") == "scbert":
        count_transform, _ = _scbert_count_transform(args.spaceranger, hd_binning,
                                                     meta["scbert_vocab"])
    else:
        count_transform = np.log1p if meta.get("log1p") else None
    device = resolve_device(args.device)
    grid_dims = tuple(meta["grid_dims"]) if meta.get("grid_dims") else None
    g = mm_model_from_meta(meta, classes, variables, device=device)
    timer = StageTimer()
    patch_px = meta.get("patch_px", 128)
    if meta.get("dense_ingest") and grid_dims:
        # dense-ingest models tile the image modality straight off the slides
        mm = MMStackDataset(
            DenseWSIGridDataset(args.images, args.spaceranger, patch_size=patch_px,
                                hd_binning=hd_binning, grid_dims=grid_dims,
                                device=device, timer=timer),
            create_visium_dataset(args.spaceranger, use_image=False,
                                  hd_binning=hd_binning, grid_dims=grid_dims,
                                  timer=timer))
    else:
        mm = create_visium_dataset(args.spaceranger, fullres_image_files=args.images,
                                   patch_size_px=patch_px,
                                   window_size_px=meta.get("window_px"),
                                   hd_binning=hd_binning, grid_dims=grid_dims,
                                   device=device, timer=timer)
    for i, srd in enumerate(args.spaceranger):
        (xi, xc), _ = mm[i]
        labels = register_mm_grid(g, xi, xc, count_transform, device=device, timer=timer)
        del xi, xc                      # this slide's grids go before the next's are built
        with timer("csv"):
            _write_loupe(labels, srd, args, classes, hd_binning=hd_binning,
                         hex_coords=grid_dims is None, index=i)
    return timer.summary()


def _register_graph(args, meta, classes, variables):
    """HexGCN directories: each array's in-tissue spots as one hex graph;
    the node labels scatter back onto the odd-right lattice."""
    import numpy as np
    import torch

    from gridnext_tpu_torch.data.graph_data import visium_to_graphdata
    from gridnext_tpu_torch.geometry import VISIUM_H_ST, VISIUM_W_ST, pseudo_hex_to_oddr
    from gridnext_tpu_torch.modeldir import (graph_model_from_meta,
                                             validate_graph_feature_axis)
    from gridnext_tpu_torch.serving import resolve_device

    device = resolve_device(args.device)
    model = graph_model_from_meta(meta, classes, variables, device=device)
    for i, srd in enumerate(args.spaceranger):
        try:
            validate_graph_feature_axis(meta, srd)
        except ValueError as e:
            sys.exit(f"error: {e}")
        gd = visium_to_graphdata([srd])
        x = np.log1p(gd["nodes"]) if meta.get("log1p") else gd["nodes"]
        with torch.no_grad():
            logits = model(torch.as_tensor(x, device=device),
                           torch.as_tensor(gd["edges"], device=device))
            labels = (torch.argmax(logits, -1) + 1).cpu().numpy()
        label_grid = np.zeros((VISIUM_H_ST, VISIUM_W_ST), np.int64)
        ox, oy = pseudo_hex_to_oddr(gd["pos"][:, 0], gd["pos"][:, 1])
        label_grid[oy, ox] = labels
        _write_loupe(label_grid, srd, args, classes, index=i)


def _cmd_register(args):
    from gridnext_tpu_torch.compat.from_jax import load_model_dir

    meta, classes, variables = load_model_dir(args.model)
    model_name = meta.get("model", "")
    if model_name in ("GridNetHexMM", "GridNetMM"):
        return _register_mm(args, meta, classes, variables)
    if model_name.endswith(("DenseNet121", "TpuPatchClassifier")):
        return _register_images(args, meta, classes, variables)
    if model_name == "HexGCN":
        return _register_graph(args, meta, classes, variables)
    if not model_name.endswith("CountMLP"):
        sys.exit(f"error: don't know how to register model "
                 f"{model_name or '<missing>'!r} (expected GridNet[Hex]"
                 f"[MM]+CountMLP / *DenseNet121 / *TpuPatchClassifier / "
                 f"HexGCN)")
    return _register_counts(args, meta, classes, variables)


def build_parser():
    """The port's argument parser (one subparser per ported command)."""
    ap = argparse.ArgumentParser(prog="gridnext_tpu_torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("register", help="write Loupe CSVs from a trained model")
    s.add_argument("--spaceranger", nargs="+", required=True)
    s.add_argument("--model", required=True)
    s.add_argument("--out", required=True)
    s.add_argument("--images", nargs="*", default=None,
                   help="fullres slide images (required for image models)")
    s.add_argument("--slide-batch", type=int, default=4,
                   help="image models: same-shape slides registered per "
                        "register_batch call, with decode/stage/register "
                        "overlapped (serving.register_slides)")
    s.add_argument("--device", default="cuda",
                   help="where registration runs: 'cuda' (default; fails "
                        "without a card) or 'cpu' (the kernels' plain versions)")
    s.set_defaults(fn=_cmd_register)
    return ap


def main(argv=None):
    """Run one command; returns what it returns (the multimodal
    ``register``'s stage seconds, else None)."""
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
