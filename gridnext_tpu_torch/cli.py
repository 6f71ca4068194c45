"""Command line of the port: ``python -m gridnext_tpu_torch <command> ...``.

Data (``simulate``, ``prepare``): the JAX package's commands on the host.
``simulate`` writes Spaceranger-shaped fixtures (positions, MEX counts,
Loupe annotations, optionally a fullres JPEG with PIL); ``prepare`` writes
each directory's unified count cache over the cohort's union gene axis
(``--images``, the JPEG patch caches, is not ported: the port crops
patches from the slides on the card).

Training (``train-count``, ``train-image``, ``train-mm``): the JAX
package's commands with its flags and defaults, on the card. Each trains
its f spotwise on the cohort's annotated spots, then g (the hex corrector,
or the Cartesian one on a square ``--grid-dims`` lattice) gridwise with f
frozen (``--finetune-f`` trains f too, and dense ingest always does), and
writes a model directory (``model.json``, ``f_*state.msgpack``,
``g_state.msgpack``) that this package's and the JAX package's
``register`` read. Every epoch end writes ``<stage>.msgpack.latest``;
``--resume`` continues from it, and SIGTERM checkpoints at the next batch
boundary and exits 75. Missing unified count caches are written first
(``--min-detection``), as ``prepare`` writes them. ``--mesh`` (multi-card training) and
``--scbert-ckpt`` / ``--scbert-finetune`` are not ported yet and exit.

Registration: the ``register`` command of the JAX package's CLI, on the card: a trained
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

``--device`` (default ``cuda``) is where a command runs; ``--device cpu``
takes the kernels' plain versions. Exits and messages follow the JAX
package's commands.
"""

from __future__ import annotations

import argparse
import os
import sys


def _cmd_simulate(args):
    from gridnext_tpu_torch.data import simulate_spaceranger_dir

    kw = {}
    if args.gene2vec_names:
        # the FIRST n gene2vec symbols, so any --scbert-vocab >= --genes
        # maps every simulated gene
        from gridnext_tpu_torch.models.scbert import load_gene2vec_names

        kw["gene_names"] = list(load_gene2vec_names()[:args.genes])
    if args.hd_grid is not None:
        kw.update(spaceranger_version="hd", hd_grid=tuple(args.hd_grid),
                  hd_binning=args.hd_binning)
    if args.barcodes != "synthetic":
        if args.hd_grid is not None:
            sys.exit("error: --barcodes visium_v1 applies to the 78x64 "
                     "Visium lattice, not HD bin grids")
        kw["barcodes"] = args.barcodes
    os.makedirs(args.out, exist_ok=True)
    for i in range(args.arrays):
        sim = simulate_spaceranger_dir(
            os.path.join(args.out, f"a{i}"), seed=args.seed + i,
            n_genes=args.genes, n_classes=args.classes, image=args.image, **kw)
        print(f"simulated {sim['spaceranger_dir']} "
              f"(annotations: {sim['annot_file']})")


_MIN_DETECTION_DEFAULT = 0.02


def _min_detection(args):
    """--min-detection's effective value (its argparse default is None, so
    that a flag the caches ignore can be told from the default)."""
    v = getattr(args, "min_detection", None)
    return _MIN_DETECTION_DEFAULT if v is None else v


def _warn_existing_caches(args, caches):
    if args.min_detection is not None and all(os.path.exists(c) for c in caches):
        print("note: unified count caches already exist -- --min-detection "
              "has no effect on them (delete *.unified.tsv.gz to refilter)")


def _cmd_prepare(args):
    from gridnext_tpu_torch.io.unify import prepare_count_files, unified_count_suffix

    written = prepare_count_files(args.spaceranger, unified_count_suffix(args.hd_binning),
                                  minimum_detection_rate=_min_detection(args),
                                  hd_binning=args.hd_binning)
    for w in written:
        print(f"wrote {w}")


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


# -- training ----------------------------------------------------------------------

_LATER_MESH = ("error: --mesh (multi-card training) is not ported yet "
               "(ROADMAP.md Queue 1 item 9)")
_LATER_SCBERT = ("error: --scbert-ckpt / --scbert-finetune are not ported yet "
                 "(ROADMAP.md Queue 1 item 6)")


def _resume_path(args, outfile):
    """Under --resume, the '.latest' continuation checkpoint of ``outfile``
    if one exists (a run killed before its first epoch end restarts clean;
    a completed stage resumes to a no-op)."""
    if not getattr(args, "resume", False):
        return None
    p = str(outfile) + ".latest"
    return p if os.path.exists(p) else None


def _split_dls(dataset, val_den: int, stream: bool, transform=None,
               val_if_single: bool = True, seed: int = 0, val_arrays=None):
    """Shuffled train/val split as loop-ready dataloaders (the JAX CLI's
    split, the same numpy draws): ``stream`` gives lazy :class:`Subset`
    views, else materialized arrays (``transform`` applied whole).
    ``val_den``: validation is ``len // val_den`` items; ``val_arrays``
    (array directory basenames) holds out whole arrays instead."""
    import numpy as np

    from gridnext_tpu_torch.data import Subset
    from gridnext_tpu_torch.train.loops import _take

    rng = np.random.default_rng(seed)
    n = len(dataset)
    if val_arrays:
        from pathlib import Path

        names = set(val_arrays)
        is_val = np.array([bool(names & set(Path(s).parts)) for s in dataset.source_ids()])
        if not is_val.any():
            sys.exit(f"error: --val-arrays {sorted(names)} matched no "
                     "items (names must be array dir basenames)")
        if is_val.all():
            sys.exit("error: --val-arrays matched every item; nothing left to train on")
        order = np.concatenate([rng.permutation(np.flatnonzero(is_val)),
                                rng.permutation(np.flatnonzero(~is_val))])
        n_val = int(is_val.sum())
    else:
        order = rng.permutation(n)
        n_val = max(1, n // val_den) if (val_if_single or n > 1) else 0
    if stream:
        return {"train": Subset(dataset, order[n_val:], transform),
                "val": Subset(dataset, order[:n_val], transform) if n_val else None}
    X, Y = dataset.materialize()
    if transform is not None:
        X = transform(X)
    multi = isinstance(X, tuple)
    X = tuple(_take(a, order) for a in X) if multi else _take(X, order)
    Y = Y[order]

    def part(sl):
        return (tuple(a[sl] for a in X) if multi else X[sl]), Y[sl]

    return {"train": part(slice(n_val, None)),
            "val": part(slice(None, n_val)) if n_val else None}


def _train_augment(args):
    if not getattr(args, "augment", False):
        return None
    from gridnext_tpu_torch.pipeline import make_train_augment

    return make_train_augment()


def _check_train_args(args):
    if getattr(args, "mesh", None) is not None:
        sys.exit(_LATER_MESH)
    if getattr(args, "scbert_ckpt", None) or getattr(args, "scbert_finetune", False):
        sys.exit(_LATER_SCBERT)


def _spot_stage(args, f, spots, name, transform=None, stream=False, augment=None):
    """Train ``f`` spotwise on ``spots``; returns its variables (JAX layout),
    taken before g's initialisation redraws the shared module."""
    from gridnext_tpu_torch.train import train_spotwise

    out = os.path.join(args.out, f"{name}.msgpack")
    state, *_ = train_spotwise(
        f, _split_dls(spots, 5, stream, transform, seed=args.split_seed,
                      val_arrays=args.val_arrays),
        learning_rate=args.f_lr, num_epochs=args.epochs, batch_size=args.batch_size,
        verbose=True, outfile=out, resume=_resume_path(args, out), augment=augment,
        device=args.device)
    return state.variables()


def _grid_stage(args, g, grids, transform, stream, joint_f, f_vars):
    """Train g gridwise (f frozen unless ``joint_f``) after loading the
    spotwise f variables ``{key: variables}``; writes ``g_state.msgpack``."""
    import torch

    from gridnext_tpu_torch.train import (create_train_state, load_f_params,
                                          make_gridwise_optimizer, save_checkpoint,
                                          train_gridwise)

    tx = make_gridwise_optimizer(args.g_lr, f_lr=args.f_lr if joint_f else None)
    dls = _split_dls(grids, 4, stream, transform, val_if_single=False,
                     seed=args.split_seed, val_arrays=args.val_arrays)
    state = create_train_state(g, tx, generator=torch.Generator().manual_seed(0),
                               device=args.device)
    for key, variables in f_vars.items():
        load_f_params(state, variables, key=key)
    g_out = os.path.join(args.out, "g_state.msgpack")
    state, *_ = train_gridwise(g, dls, state=state, num_epochs=args.epochs, verbose=True,
                               batch_size=args.grid_batch_size, outfile=g_out,
                               resume=_resume_path(args, g_out),
                               augment=_train_augment(args), device=args.device)
    save_checkpoint(g_out, state)


def _write_meta(args, meta):
    import json

    with open(os.path.join(args.out, "model.json"), "w") as fh:
        json.dump(meta, fh)
    print(f"saved model to {args.out}")


def _train_fg(args, f, grids, spots, meta_extra, patch_chunk=None, transform=None,
              stream: bool = False, corrector: str = "hex"):
    """The shared f-spotwise + g-gridwise flow of train-count and
    train-image (``spots`` None: dense ingest, f trains jointly with g)."""
    from gridnext_tpu_torch.models import GridNet, GridNetHex

    classes = list(grids.classes)
    spot_desc = "joint f+g (dense ingest)" if spots is None else f"{len(spots)} spots"
    print(f"{spot_desc}, {len(grids)} arrays, classes: {classes}"
          + (" [streaming]" if stream else ""))
    os.makedirs(args.out, exist_ok=True)
    f_vars = {}
    if spots is not None:
        f_vars["patch_classifier"] = _spot_stage(args, f, spots, "f_state", transform,
                                                 stream, _train_augment(args))
    g_cls = GridNet if corrector == "square" else GridNetHex
    g = g_cls(f, n_classes=len(classes), f_dim=len(classes), patch_chunk=patch_chunk)
    _grid_stage(args, g, grids, transform, stream, args.finetune_f or spots is None, f_vars)
    _write_meta(args, {"classes": classes, **meta_extra})


def _parse_hd_args(args, require_dims: bool, what: str = "training"):
    """(hd_binning, grid_dims): --grid-dims 'auto' | 'HxW' (needs
    --hd-binning; image and multimodal training need it with one)."""
    hd_binning, spec = args.hd_binning, args.grid_dims
    grid_dims = None
    if spec is not None:
        if spec.lower() == "auto":
            grid_dims = "auto"
        else:
            try:
                h, w = spec.lower().split("x")
                grid_dims = (int(h), int(w))
            except ValueError:
                sys.exit(f"error: --grid-dims must be 'auto' or HxW; got {spec!r}")
    if grid_dims is not None and hd_binning is None:
        sys.exit("error: --grid-dims requires --hd-binning")
    if require_dims and hd_binning is not None and grid_dims is None:
        sys.exit(f"error: --hd-binning {what} needs --grid-dims "
                 "(the square HD bin lattice the patch grid is indexed by)")
    return hd_binning, grid_dims


def _check_image_args(args):
    _require_one_image_per_dir(args.images, args.spaceranger)
    if args.patch_px < 32:
        sys.exit("error: --patch-px must be >= 32 (densenet121 downsamples "
                 "by 32x, TpuPatchClassifier by 16x then 2x; smaller patches "
                 "collapse to zero spatial size)")
    if args.window_px is not None and args.window_px < args.patch_px:
        sys.exit("error: --window-px must be >= --patch-px (the window is "
                 "cropped around each spot then resized DOWN to the patch "
                 "size; upsampling a smaller window is never what you want)")


def _check_dense_ingest_args(args, grid_dims):
    if grid_dims is None:
        sys.exit("error: --dense-ingest needs a square HD bin lattice "
                 "(--grid-dims / --hd-binning); Visium pseudo-hex "
                 "spots don't tile the slide")
    if args.window_px is not None and args.window_px != args.patch_px:
        sys.exit("error: --dense-ingest extracts whole bins (window == "
                 "pitch == --patch-px); drop --window-px or use the "
                 "cache-based pipeline")


def _image_f(args, n_classes):
    """(f, model-name suffix, tpu_f meta) of --f and --bf16."""
    import torch

    from gridnext_tpu_torch.models import TpuPatchClassifier, densenet121

    dtype = torch.bfloat16 if args.bf16 else None
    if args.f == "tpu":
        f = TpuPatchClassifier(n_classes=n_classes, dtype=dtype)
        return f, "TpuPatchClassifier", {"stages": [list(s) for s in f.stages_spec],
                                         "stem_patch": f.stem_patch, "norm": f.stem_norm.kind}
    return densenet121(num_classes=n_classes, dtype=dtype), "DenseNet121", None


def _cmd_train_count(args):
    import numpy as np

    from gridnext_tpu_torch.data import create_visium_dataset
    from gridnext_tpu_torch.io.unify import read_unified_genes, unified_cache_path
    from gridnext_tpu_torch.models import CountMLP

    _check_train_args(args)
    hd_binning, grid_dims = _parse_hd_args(args, require_dims=False)
    _warn_existing_caches(args, [unified_cache_path(s, hd_binning) for s in args.spaceranger])
    kw = dict(annot_files=args.annots, use_image=False, hd_binning=hd_binning,
              minimum_detection_rate=_min_detection(args))
    try:
        spots = create_visium_dataset(args.spaceranger, spatial=False, **kw)
        grids = create_visium_dataset(args.spaceranger, spatial=True, grid_dims=grid_dims,
                                      **kw)
    except FileNotFoundError as e:
        sys.exit(f"error: {e}")
    genes = read_unified_genes(unified_cache_path(args.spaceranger[0], hd_binning))
    square = grid_dims is not None
    f = CountMLP(len(genes), n_classes=len(grids.classes))
    _train_fg(args, f, grids, spots,
              {"n_genes": len(genes), "genes": genes, "log1p": True,
               "hd_binning": hd_binning,
               "grid_dims": [grids.h_st, grids.w_st] if square else None,
               "model": "GridNet+CountMLP" if square else "GridNetHex+CountMLP"},
              transform=np.log1p, corrector="square" if square else "hex")


def _cmd_train_image(args):
    from gridnext_tpu_torch.data import DenseWSIGridDataset, create_visium_dataset

    _check_train_args(args)
    _check_image_args(args)
    hd_binning, grid_dims = _parse_hd_args(args, require_dims=True, what="image training")
    if args.dense_ingest:
        _check_dense_ingest_args(args, grid_dims)
        spots = None
        grids = DenseWSIGridDataset(args.images, args.spaceranger, args.annots,
                                    patch_size=args.patch_px, hd_binning=hd_binning,
                                    grid_dims=grid_dims, device=args.device)
    else:
        kw = dict(annot_files=args.annots, use_count=False, fullres_image_files=args.images,
                  patch_size_px=args.patch_px, window_size_px=args.window_px,
                  hd_binning=hd_binning, grid_dims=grid_dims, device=args.device)
        spots = create_visium_dataset(args.spaceranger, spatial=False, **kw)
        grids = create_visium_dataset(args.spaceranger, spatial=True, **kw)
    square = grid_dims is not None
    g_name = "GridNet" if square else "GridNetHex"
    f, f_name, tpu_f_meta = _image_f(args, len(grids.classes))
    if args.dense_ingest and args.f != "tpu":
        print("warning: --dense-ingest trains f jointly with g (no "
              "spotwise stage), but DenseNet's BatchNorm runs in eval "
              "mode inside GridNet, so from-scratch running stats stay "
              "at their (mean 0, var 1) init. Prefer '--f tpu' "
              "(LayerNorm, immune) or start from a pretrained f.", file=sys.stderr)
    _train_fg(args, f, grids, spots,
              {"patch_px": args.patch_px, "window_px": args.window_px,
               "model": f"{g_name}+{f_name}", "tpu_f": tpu_f_meta,
               "image_f": args.f, "hd_binning": hd_binning,
               "grid_dims": [grids.h_st, grids.w_st] if square else None,
               "patch_chunk": args.patch_chunk, "dense_ingest": bool(args.dense_ingest)},
              patch_chunk=args.patch_chunk, stream=not args.no_stream,
              corrector="square" if square else "hex")


def _cmd_train_mm(args):
    """Multimodal: the count f and the image f spotwise, then the MM g."""
    import numpy as np

    from gridnext_tpu_torch.data import (DenseWSIGridDataset, MMStackDataset,
                                         create_visium_dataset)
    from gridnext_tpu_torch.io.unify import read_unified_genes, unified_cache_path
    from gridnext_tpu_torch.models import CountMLP, GridNetHexMM, GridNetMM, scBERT

    _check_train_args(args)
    _check_image_args(args)
    hd_binning, grid_dims = _parse_hd_args(args, require_dims=True,
                                           what="multimodal training")
    _warn_existing_caches(args, [unified_cache_path(s, hd_binning) for s in args.spaceranger])
    count_kw = dict(annot_files=args.annots, use_image=False, hd_binning=hd_binning,
                    minimum_detection_rate=_min_detection(args))
    try:
        if args.dense_ingest:
            _check_dense_ingest_args(args, grid_dims)
            img_grids = DenseWSIGridDataset(args.images, args.spaceranger, args.annots,
                                            patch_size=args.patch_px, hd_binning=hd_binning,
                                            grid_dims=grid_dims, device=args.device)
            mm_grids = MMStackDataset(img_grids, create_visium_dataset(
                args.spaceranger, grid_dims=(img_grids.h_st, img_grids.w_st), **count_kw))
            image_spots = None
        else:
            kw = dict(annot_files=args.annots, fullres_image_files=args.images,
                      patch_size_px=args.patch_px, window_size_px=args.window_px,
                      hd_binning=hd_binning, grid_dims=grid_dims, device=args.device,
                      minimum_detection_rate=_min_detection(args))
            mm_grids = create_visium_dataset(args.spaceranger, spatial=True, **kw)
            image_spots = create_visium_dataset(args.spaceranger, spatial=False,
                                                use_count=False, **kw)
        count_spots = create_visium_dataset(args.spaceranger, spatial=False, **count_kw)
    except FileNotFoundError as e:
        sys.exit(f"error: {e}")
    classes = list(mm_grids.classes)
    n_classes = len(classes)
    stream = not args.no_stream
    print(f"{len(count_spots)} count spots, "
          + (f"{len(image_spots)} image spots, " if image_spots is not None
             else "dense image ingest, ")
          + f"{len(mm_grids)} arrays, classes: {classes}"
          + (" [streaming]" if stream else ""))
    os.makedirs(args.out, exist_ok=True)
    genes = read_unified_genes(unified_cache_path(args.spaceranger[0], hd_binning))
    if args.count_f == "scbert":
        count_transform, vocab = _scbert_count_transform(args.spaceranger, hd_binning,
                                                         args.scbert_vocab)
        f_count = scBERT(n_genes=vocab, dim=args.scbert_dim, depth=args.scbert_depth,
                         heads=args.scbert_heads, dim_head=args.scbert_dim_head,
                         nb_features=args.scbert_features, n_classes=n_classes,
                         generalized_attention=True)
        count_chunk = 8 if args.count_chunk is None else args.count_chunk
    else:
        count_transform, vocab = np.log1p, None
        f_count = CountMLP(len(genes), n_classes=n_classes)
        count_chunk = args.count_chunk
    # count spots always materialize (small in RAM); image spots stream
    f_vars = {"count_classifier": _spot_stage(args, f_count, count_spots, "f_count_state",
                                              count_transform)}
    f_image, f_name, tpu_f_meta = _image_f(args, n_classes)
    if image_spots is not None:
        f_vars["image_classifier"] = _spot_stage(args, f_image, image_spots,
                                                 "f_image_state", stream=stream,
                                                 augment=_train_augment(args))
    square = grid_dims is not None
    g = (GridNetMM if square else GridNetHexMM)(
        f_image, f_count, n_classes=n_classes, patch_chunk=args.patch_chunk,
        count_chunk=count_chunk)
    _grid_stage(args, g, mm_grids, lambda x: (x[0], count_transform(x[1])), stream,
                args.finetune_f or image_spots is None, f_vars)
    _write_meta(args, {
        "classes": classes, "patch_px": args.patch_px, "window_px": args.window_px,
        "patch_chunk": args.patch_chunk, "count_chunk": count_chunk,
        "n_genes": len(genes), "genes": genes, "log1p": args.count_f != "scbert",
        "count_f": args.count_f, "scbert_vocab": vocab, "scbert_dim": args.scbert_dim,
        "scbert_depth": args.scbert_depth, "scbert_heads": args.scbert_heads,
        "scbert_dim_head": args.scbert_dim_head, "scbert_features": args.scbert_features,
        "hd_binning": hd_binning,
        "grid_dims": ([mm_grids.image_dataset.h_st, mm_grids.image_dataset.w_st]
                      if square else None),
        "image_f": args.f, "tpu_f": tpu_f_meta, "dense_ingest": bool(args.dense_ingest),
        "model": "GridNetMM" if square else "GridNetHexMM"})


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

    s = sub.add_parser("simulate", help="fabricate pseudo-Visium data")
    s.add_argument("--out", required=True)
    s.add_argument("--arrays", type=int, default=4)
    s.add_argument("--genes", type=int, default=60)
    s.add_argument("--classes", type=int, default=4)
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--image", action="store_true",
                   help="also write a fullres JPEG a directory (needs PIL)")
    s.add_argument("--gene2vec-names", action="store_true",
                   help="name the simulated genes from the gene2vec vocabulary "
                        "(so the cohort feeds scBERT count models)")
    s.add_argument("--barcodes", choices=("synthetic", "visium_v1"), default="synthetic",
                   help="'visium_v1' stamps the real Visium v1 slide whitelist onto "
                        "the lattice; default: self-describing SYN names")
    s.add_argument("--hd-grid", type=int, nargs=2, default=None, metavar=("H", "W"),
                   help="emit square-lattice Visium HD binned outputs on an HxW bin "
                        "grid instead of the 78x64 Visium lattice")
    s.add_argument("--hd-binning", default="square_008um",
                   help="binning name for --hd-grid output layout")
    s.set_defaults(fn=_cmd_simulate)

    s = sub.add_parser("prepare", help="generate the unified count caches")
    s.add_argument("--spaceranger", nargs="+", required=True)
    s.add_argument("--min-detection", type=float, default=None,
                   help="gene detection-rate filter (default 0.02)")
    s.add_argument("--hd-binning", default=None,
                   help="Visium HD binned output to read (e.g. square_008um)")
    s.set_defaults(fn=_cmd_prepare)

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

    s = sub.add_parser("train-count", help="train CountMLP f + GridNetHex g")
    _add_hd_args(s, "GridNet")
    s.add_argument("--spaceranger", nargs="+", required=True)
    s.add_argument("--annots", nargs="+", required=True)
    s.add_argument("--out", required=True)
    s.add_argument("--epochs", type=int, default=10)
    s.add_argument("--batch-size", type=int, default=128)
    s.add_argument("--f-lr", type=float, default=1e-4)
    s.add_argument("--g-lr", type=float, default=1e-3)
    s.add_argument("--finetune-f", action="store_true")
    s.add_argument("--min-detection", type=float, default=None,
                   help="gene detection-rate filter for caches this command "
                        "generates (default 0.02)")
    _add_train_args(s)
    s.set_defaults(fn=_cmd_train_count)

    s = sub.add_parser("train-image", help="train DenseNet-121 f + GridNetHex g")
    _add_image_train_args(s)
    s.add_argument("--no-stream", action="store_true",
                   help="materialize the cohort instead of streaming batches")
    s.add_argument("--dense-ingest", action="store_true",
                   help="square-HD only: tile training grids straight from the "
                        "fullres slides; skips the spotwise stage and trains f "
                        "jointly with g")
    _add_hd_args(s, "GridNet")
    _add_train_args(s)
    s.set_defaults(fn=_cmd_train_image)

    s = sub.add_parser("train-mm", help="train multimodal GridNetHexMM (count + image)")
    _add_image_train_args(s)
    s.add_argument("--min-detection", type=float, default=None,
                   help="gene detection-rate filter for caches this command "
                        "generates (default 0.02)")
    s.add_argument("--count-f", choices=("mlp", "scbert"), default="mlp",
                   help="count classifier: 'mlp' (CountMLP) or 'scbert' (counts "
                        "reindexed into the gene2vec space, Performer over the "
                        "token sequence, from random init)")
    s.add_argument("--scbert-vocab", type=int, default=16906,
                   help="gene2vec tokens to use (full vocabulary = 16,906)")
    s.add_argument("--scbert-dim", type=int, default=200)
    s.add_argument("--scbert-depth", type=int, default=6)
    s.add_argument("--scbert-heads", type=int, default=10)
    s.add_argument("--scbert-dim-head", type=int, default=64,
                   help="per-head attention width (64 = the reference checkpoint shape)")
    s.add_argument("--scbert-features", type=int, default=None,
                   help="FAVOR random features m per head (default dim_head*ln(dim_head))")
    s.add_argument("--scbert-ckpt", default=None, help="not ported yet (exits)")
    s.add_argument("--scbert-finetune", action="store_true", help="not ported yet (exits)")
    s.add_argument("--count-chunk", type=int, default=None,
                   help="spots per count-f chunk in g (default: patch-chunk "
                        "for mlp, 8 for scbert)")
    s.add_argument("--no-stream", action="store_true",
                   help="materialize the cohort instead of streaming batches")
    s.add_argument("--dense-ingest", action="store_true",
                   help="square-HD only: tile the image modality's training grids "
                        "straight from the fullres slides; skips the image-f "
                        "spotwise stage and trains the image f jointly with g")
    _add_hd_args(s, "GridNetMM")
    _add_train_args(s)
    s.set_defaults(fn=_cmd_train_mm)
    return ap


def _add_image_train_args(s):
    s.add_argument("--spaceranger", nargs="+", required=True)
    s.add_argument("--annots", nargs="+", required=True)
    s.add_argument("--images", nargs="+", required=True)
    s.add_argument("--out", required=True)
    s.add_argument("--patch-px", type=int, default=128)
    s.add_argument("--window-px", type=int, default=None,
                   help="crop this window around each spot and resize down to "
                        "--patch-px (default: crop exactly --patch-px)")
    s.add_argument("--f", choices=("densenet", "tpu"), default="densenet",
                   help="spot classifier: 'densenet' (DenseNet-121) or 'tpu' "
                        "(TpuPatchClassifier)")
    s.add_argument("--patch-chunk", type=int, default=624)
    s.add_argument("--epochs", type=int, default=10)
    s.add_argument("--batch-size", type=int, default=32)
    s.add_argument("--f-lr", type=float, default=1e-3)
    s.add_argument("--g-lr", type=float, default=1e-3)
    s.add_argument("--finetune-f", action="store_true")
    s.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute in f (float32 parameters)")
    s.add_argument("--augment", action="store_true",
                   help="each train patch draws one of the 8 flips/rotations on "
                        "the card (pipeline.augment_patches); eval and register "
                        "see clean inputs")


def _add_hd_args(s, corrector: str):
    s.add_argument("--hd-binning", default=None,
                   help="Visium HD binned output to read (e.g. square_008um)")
    s.add_argument("--grid-dims", default=None,
                   help="square HD bin lattice: 'auto' (infer from positions) "
                        f"or HxW; selects the Cartesian {corrector} corrector")


def _add_train_args(s):
    s.add_argument("--mesh", default=None, help="not ported yet (exits)")
    s.add_argument("--grid-batch-size", type=int, default=1,
                   help="arrays per gridwise training step")
    s.add_argument("--split-seed", type=int, default=0,
                   help="seed for the random train/val split")
    s.add_argument("--val-arrays", nargs="+", default=None,
                   help="hold out these whole arrays (dir basenames) for "
                        "validation instead of a random split")
    s.add_argument("--resume", action="store_true",
                   help="continue an interrupted run from the '.latest' "
                        "checkpoints in --out (--epochs is the TOTAL count)")
    s.add_argument("--device", default="cuda",
                   help="where training runs: 'cuda' (default; fails without a "
                        "card) or 'cpu' (the kernels' plain versions)")


def main(argv=None):
    """Run one command; returns what it returns (the multimodal
    ``register``'s stage seconds, else None). A training command that
    SIGTERM preempts exits 75 after its batch-boundary checkpoint."""
    args = build_parser().parse_args(argv)
    if not args.cmd.startswith("train-"):
        return args.fn(args)
    from gridnext_tpu_torch.serving import resolve_device
    from gridnext_tpu_torch.train.preempt import (TrainingPreempted,
                                                  install_preemption_handler,
                                                  uninstall_preemption_handler)

    args.device = resolve_device(args.device)
    install_preemption_handler()
    try:
        return args.fn(args)
    except TrainingPreempted as e:
        print(f"preempted: {e}", file=sys.stderr)
        if e.checkpoint is not None:
            print("resume by rerunning with --resume", file=sys.stderr)
        raise SystemExit(75)
    finally:
        uninstall_preemption_handler()


if __name__ == "__main__":
    main()
