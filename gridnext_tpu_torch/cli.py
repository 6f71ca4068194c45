"""Command line of the port: ``python -m gridnext_tpu_torch <command> ...``.

Data (``simulate``, ``prepare``): the JAX package's commands on the host.
``simulate`` writes Spaceranger-shaped fixtures (positions, MEX counts,
Loupe annotations, optionally a fullres JPEG with PIL); ``prepare`` writes
each directory's unified count cache over the cohort's union gene axis
(``--images``, the JPEG patch caches, is not ported: the port crops
patches from the slides on the card).

Training (``train-count``, ``train-image``, ``train-mm``,
``train-graph``, ``pretrain-scbert``): the JAX package's commands with its
flags and defaults, on the card. ``train-count``, ``train-image`` and
``train-mm`` train f spotwise on the cohort's annotated spots, then g (the
hex corrector, or the Cartesian one on a square ``--grid-dims`` lattice)
gridwise with f frozen (``--finetune-f`` trains f too, and dense ingest
always does), and write a model directory (``model.json``,
``f_*state.msgpack``, ``g_state.msgpack``) that this package's and the JAX
package's ``register`` read. ``train-mm --count-f scbert --scbert-ckpt``
starts the scBERT count f from a checkpoint (a reference torch ``.pth``,
or a flax msgpack such as ``pretrain-scbert`` writes; mismatched entries,
the classifier head first, re-initialise), and ``--scbert-finetune``
freezes all but the final norm, layer ``depth - 2`` and the head, in both
stages. ``pretrain-scbert`` pretrains a ``PerformerLM`` with the
masked-LM objective over a cohort's spots (no annotations; FAVOR
projections redrawn every ``--redraw-every`` steps) and writes
``scbert_lm.msgpack`` and ``pretrain.json``. ``train-graph`` trains a
``HexGCN`` full-batch over the cohort's hex graph and writes a model
directory. Every epoch end writes ``<stage>.msgpack.latest``;
``--resume`` continues from it, and SIGTERM checkpoints at the next batch
boundary and exits 75. Missing unified count caches are written first
(``--min-detection``), as ``prepare`` writes them. ``--mesh`` trains over
several cards, one process a card over ``torch.distributed``: launch with
``torchrun --nproc-per-node N -m gridnext_tpu_torch --multihost <command>
--mesh data=N ...`` or wire each process with ``--coordinator
host:port,N,rank`` (NCCL on the card, gloo under ``--device cpu``); the
replicas start from rank 0's weights, the batches shard over the ranks,
BatchNorm normalises over the global batch, and only rank 0 writes. A
``seq`` axis (``pretrain-scbert --mesh data=1,seq=2``) shards the MLM
corpus's gene tokens over its ranks (sequence-parallel MLM; the corpus is
padded with ``-1`` tokens to a multiple of it), FAVOR summing its context
over them; other commands treat it as JAX's do (spot batches over every
axis, grid batches over ``data``).

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

Evaluation (``evaluate``): the JAX package's command on the card. One or
more trained model directories of any kind ``register`` serves are scored
over annotated arrays (``--annots``): foreground accuracy, per-class and
macro AUROC / AUPRC, the classification report and the confusion matrix,
written as JSON (the metrics in numpy, :mod:`~gridnext_tpu_torch.metrics`);
several directories also score their consensus (mean softmax).
``--f-only`` scores f alone, ``--tta`` averages the 8 dihedral
orientations of each patch, ``--plots`` / ``--maps`` render figures with
matplotlib (and exit at once where it is missing).

Distillation (``distill``): an image directory's f (DenseNet-121 or
``TpuPatchClassifier``) distils into a ``TpuPatchClassifier`` student
(bf16 unless ``--f32``) over a pool of spot patches cropped from the
slides, the teacher's corrector carried over verbatim; a multimodal
directory's scBERT count f distils into a stateless ``CountMLP`` on log1p
counts. The holdout agreement and the registrations' label agreement are
written into the student directory's ``model.json``.

Serving (``serve``, ``export``, ``serve-artifact``): ``serve`` keeps a
model directory (or an exported artifact) on the card behind an HTTP
server (:mod:`~gridnext_tpu_torch.server`). ``register --mesh`` and ``serve
--mesh`` split an image model's flat spot axis over the visible cards in one
process (``SlideRegistrar(mesh=...)``). ``export`` writes a directory's
registration as a ``torch.export``
artifact (``.pt2``, weights inside, the kernels as ``gridnext::`` custom
ops) and its JSON sidecar: slide -> labels for image directories
(``--wsi-shape``; ``--dense`` for an exact Visium HD lattice), the grid
forward for count and multimodal ones. ``serve-artifact`` registers slides
through an artifact with no model code and writes Loupe CSVs. An artifact
runs on the device type it was exported on.

``--device`` (default ``cuda``) is where a command runs; ``--device cpu``
takes the kernels' plain versions. ``--profile-dir DIR`` (before the
subcommand) traces the whole command with ``torch.profiler`` into a Chrome
trace JSON under DIR (the JAX package writes a TensorBoard xplane). Exits
and messages follow the JAX package's commands.
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
    registrar = image_registrar_from_meta(meta, classes, variables, device=args.device,
                                          mesh=_serving_mesh(args))
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

def _parse_mesh(args):
    """--mesh 'data=4,spot=2' | 'auto' -> the trainers' mesh_shape value."""
    spec = getattr(args, "mesh", None)
    if spec is None:
        return None
    spec = spec.lower()
    if spec == "auto":
        return "auto"
    try:
        shape = {}
        for part in spec.split(","):
            name, size = part.split("=")
            shape[name.strip()] = int(size)
        if not shape or any(s <= 0 for s in shape.values()):
            raise ValueError
    except ValueError:
        sys.exit(f"error: --mesh must be 'auto' or like 'data=4,spot=2' "
                 f"(positive axis sizes); got {spec!r}")
    return shape


def _checked_mesh(args, *, spot_batch=None, grid_batch=None, mlm_batch=None):
    """Build the training mesh of --mesh over the process group and fail
    fast on batch / mesh divisibility, before any stage trains (the g
    stage starts only after f has trained). The mesh is kept on ``args``
    for the stages."""
    mesh_shape = _parse_mesh(args)
    args.train_mesh = None
    if mesh_shape is None:
        return None
    from gridnext_tpu_torch.train.loops import _mesh_placement, _resolve_mesh

    try:
        mesh = _resolve_mesh(None, mesh_shape)
    except ValueError as e:
        sys.exit(f"error: {e}")
    try:
        for kind, batch in (("spot", spot_batch), ("grid", grid_batch), ("mlm", mlm_batch)):
            if batch is not None:
                _mesh_placement(mesh, kind, batch)
    except ValueError as e:
        sys.exit(f"error: {e} (adjust --batch-size / --grid-batch-size "
                 "before training starts)")
    args.train_mesh = mesh
    return mesh


def _serving_mesh(args):
    """The device mesh of register / serve --mesh: the flat spot axis over
    the visible cards of this process (``--device cpu``: that many CPU
    shards)."""
    mesh_shape = _parse_mesh(args)
    if mesh_shape is None:
        return None
    import numpy as np
    import torch

    from gridnext_tpu_torch.parallel import default_mesh_shape, make_mesh
    from gridnext_tpu_torch.parallel.mesh import SEQ_SERVING

    if "seq" in mesh_shape:
        sys.exit(f"error: {SEQ_SERVING}")
    from gridnext_tpu_torch.serving import resolve_device

    device = resolve_device(args.device)
    if device.type == "cuda":
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        n = 1 if mesh_shape == "auto" else int(np.prod(list(mesh_shape.values())))
        devices = [device] * n
    if mesh_shape == "auto":
        mesh_shape = default_mesh_shape(len(devices))
    try:
        mesh = make_mesh(mesh_shape, devices=devices)
    except ValueError as e:
        sys.exit(f"error: {e}")
    print(f"serving over mesh {mesh.shape}")
    return mesh


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


def _spot_stage(args, f, spots, name, transform=None, stream=False, augment=None,
                state=None):
    """Train ``f`` spotwise on ``spots`` (from ``state`` when given, else from
    a fresh initialisation); returns its variables (JAX layout), taken
    before g's initialisation redraws the shared module."""
    from gridnext_tpu_torch.train import train_spotwise

    out = os.path.join(args.out, f"{name}.msgpack")
    state, *_ = train_spotwise(
        f, _split_dls(spots, 5, stream, transform, seed=args.split_seed,
                      val_arrays=args.val_arrays),
        learning_rate=args.f_lr, num_epochs=args.epochs, batch_size=args.batch_size,
        verbose=True, outfile=out, resume=_resume_path(args, out), augment=augment,
        state=state, device=args.device, mesh=getattr(args, "train_mesh", None))
    return state.variables()


def _grid_stage(args, g, grids, transform, stream, joint_f, f_vars, frozen_f=None):
    """Train g gridwise (f frozen unless ``joint_f``; ``frozen_f`` carries a
    per-leaf freeze of an f subtree) after loading the spotwise f variables
    ``{key: variables}``; writes ``g_state.msgpack``."""
    import torch

    from gridnext_tpu_torch.parallel import is_primary
    from gridnext_tpu_torch.train import (create_train_state, load_f_params,
                                          make_gridwise_optimizer, save_checkpoint,
                                          train_gridwise)

    tx = make_gridwise_optimizer(args.g_lr, f_lr=args.f_lr if joint_f else None,
                                 frozen_f_labels=frozen_f)
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
                               augment=_train_augment(args), device=args.device,
                               mesh=getattr(args, "train_mesh", None))
    if is_primary():
        save_checkpoint(g_out, state)


def _write_meta(args, meta):
    import json

    from gridnext_tpu_torch.parallel import is_primary

    if not is_primary():
        return
    with open(os.path.join(args.out, "model.json"), "w") as fh:
        json.dump(meta, fh)
    print(f"saved model to {args.out}")


def _train_fg(args, f, grids, spots, meta_extra, patch_chunk=None, transform=None,
              stream: bool = False, corrector: str = "hex"):
    """The shared f-spotwise + g-gridwise flow of train-count and
    train-image (``spots`` None: dense ingest, f trains jointly with g)."""
    from gridnext_tpu_torch.models import GridNet, GridNetHex

    classes = list(grids.classes)
    # dense ingest has no spotwise stage: --batch-size is not checked there
    mesh = _checked_mesh(args, spot_batch=args.batch_size if spots is not None else None,
                         grid_batch=args.grid_batch_size)
    spot_desc = "joint f+g (dense ingest)" if spots is None else f"{len(spots)} spots"
    print(f"{spot_desc}, {len(grids)} arrays, classes: {classes}"
          + (" [streaming]" if stream else "")
          + (f" [mesh {mesh.shape}]" if mesh is not None else ""))
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


def _load_scbert_ckpt(path, depth: int) -> dict:
    """scBERT starting weights as a variables tree (the JAX layout): a
    reference torch ``.pth`` / ``.pt`` (read without running pickled code,
    a ``model_state_dict`` wrapper unwrapped, converted by
    :mod:`~gridnext_tpu_torch.compat.scbert_convert`) or a flax msgpack
    file: a raw variables dict, a checkpoint payload (``params`` and
    ``extra_vars``) or a raw ``PerformerLM`` tree (``pretrain-scbert``'s),
    which is nested under scBERT's ``performer_lm`` (its own head then has
    no place and drops away)."""
    if str(path).endswith((".pth", ".pt")):
        from gridnext_tpu_torch.compat.scbert_convert import (read_torch_checkpoint,
                                                              scbert_from_torch)

        variables, _ = scbert_from_torch(read_torch_checkpoint(path), depth=depth)
        return variables
    from gridnext_tpu_torch.compat.from_jax import load_checkpoint

    payload = load_checkpoint(path)
    variables = {"params": payload["params"]}
    variables.update(payload.get("extra_vars") or {})
    if "favor" in payload:                      # the raw variables-dict form
        variables["favor"] = payload["favor"]
    params = variables.get("params") or {}
    if "performer_lm" not in params and ("token_emb" in params or "performer" in params):
        variables = {k: {"performer_lm": v} for k, v in variables.items()}
    return variables


def _merge_matching_params(dst, src, skipped, path=""):
    """``dst`` (a fresh tree) with every leaf of ``src`` whose path and
    shape match; the rest keep their fresh values and are recorded in
    ``skipped`` (a different classifier head, a truncated vocabulary)."""
    import numpy as np

    if isinstance(dst, dict):
        out = {}
        for k, v in dst.items():
            if isinstance(src, dict) and k in src:
                out[k] = _merge_matching_params(v, src[k], skipped, f"{path}/{k}")
            else:
                skipped.append(f"{path}/{k} (missing)")
                out[k] = v
        return out
    if np.shape(dst) == np.shape(src):
        return np.asarray(src)
    skipped.append(f"{path} (shape {np.shape(src)} != {np.shape(dst)})")
    return dst


def _scbert_start(args, f_count):
    """The ``--scbert-ckpt`` / ``--scbert-finetune`` start of an scBERT count
    f: ``(train state, frozen_f)``. The weights are drawn fresh, then every
    checkpoint leaf that fits replaces its fresh value (the re-initialised
    ones are reported); ``--scbert-finetune`` trains only the leaves
    ``finetune_param_labels`` marks, here and (``frozen_f``) in g's stage."""
    import torch

    from gridnext_tpu_torch.compat.from_jax import jax_variables, load_variables
    from gridnext_tpu_torch.models.scbert import finetune_param_labels
    from gridnext_tpu_torch.train import create_train_state, make_adam, make_masked_adam
    from gridnext_tpu_torch.train.init import flax_init_

    tx, frozen_f = make_adam(args.f_lr), None
    if args.scbert_finetune:
        def labels(params):
            return finetune_param_labels(params, args.scbert_depth)

        tx, frozen_f = make_masked_adam(args.f_lr, labels), {"count_classifier": labels}
    flax_init_(f_count, torch.Generator().manual_seed(0))
    if args.scbert_ckpt:
        loaded = _load_scbert_ckpt(args.scbert_ckpt, args.scbert_depth)
        fresh, skipped = jax_variables(f_count), []
        merged = {"params": _merge_matching_params(fresh["params"], loaded.get("params", {}),
                                                   skipped)}
        for k, v in fresh.items():
            if k != "params":
                merged[k] = (_merge_matching_params(v, loaded[k], skipped, path=f"[{k}]")
                             if k in loaded else v)
        load_variables(f_count, merged)
        print("scBERT checkpoint: "
              + ("all parameters loaded" if not skipped else
                 f"{len(skipped)} entries re-initialized "
                 "(head swap / vocab or attention-geometry "
                 f"mismatch): {skipped[:3]}"))
    return create_train_state(f_count, tx, device=args.device, init=False), frozen_f


def _cmd_train_count(args):
    import numpy as np

    from gridnext_tpu_torch.data import create_visium_dataset
    from gridnext_tpu_torch.io.unify import read_unified_genes, unified_cache_path
    from gridnext_tpu_torch.models import CountMLP

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
    mesh = _checked_mesh(args, spot_batch=args.batch_size, grid_batch=args.grid_batch_size)
    print(f"{len(count_spots)} count spots, "
          + (f"{len(image_spots)} image spots, " if image_spots is not None
             else "dense image ingest, ")
          + f"{len(mm_grids)} arrays, classes: {classes}"
          + (" [streaming]" if stream else "")
          + (f" [mesh {mesh.shape}]" if mesh is not None else ""))
    os.makedirs(args.out, exist_ok=True)
    genes = read_unified_genes(unified_cache_path(args.spaceranger[0], hd_binning))
    f_count_state = frozen_f = None
    if args.count_f == "scbert":
        count_transform, vocab = _scbert_count_transform(args.spaceranger, hd_binning,
                                                         args.scbert_vocab)
        f_count = scBERT(n_genes=vocab, dim=args.scbert_dim, depth=args.scbert_depth,
                         heads=args.scbert_heads, dim_head=args.scbert_dim_head,
                         nb_features=args.scbert_features, n_classes=n_classes,
                         generalized_attention=True)
        count_chunk = 8 if args.count_chunk is None else args.count_chunk
        if args.scbert_ckpt or args.scbert_finetune:
            f_count_state, frozen_f = _scbert_start(args, f_count)
    else:
        count_transform, vocab = np.log1p, None
        f_count = CountMLP(len(genes), n_classes=n_classes)
        count_chunk = args.count_chunk
    # count spots always materialize (small in RAM); image spots stream
    f_vars = {"count_classifier": _spot_stage(args, f_count, count_spots, "f_count_state",
                                              count_transform, state=f_count_state)}
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
                args.finetune_f or image_spots is None, f_vars, frozen_f=frozen_f)
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


def _cmd_pretrain_scbert(args):
    """Masked-expression pretraining of an scBERT-scale ``PerformerLM`` on a
    cohort's spots (no annotations). ``scbert_lm.msgpack`` holds the
    best-validation weights and projections (no optimiser state) and feeds
    ``train-mm --count-f scbert --scbert-ckpt`` (matching
    ``--scbert-vocab/dim/depth/heads``), which loads every LM weight and
    re-initialises the classifier head; ``pretrain.json`` describes it."""
    import json

    import numpy as np

    from gridnext_tpu_torch.data import create_visium_dataset
    from gridnext_tpu_torch.models import PerformerLM
    from gridnext_tpu_torch.parallel import is_primary
    from gridnext_tpu_torch.train import mlm_token_len, save_checkpoint, train_mlm

    mesh = _checked_mesh(args, mlm_batch=args.batch_size)
    try:
        spots = create_visium_dataset(args.spaceranger, spatial=False, use_count=True,
                                      use_image=False,
                                      minimum_detection_rate=_min_detection(args),
                                      hd_binning=args.hd_binning)
    except FileNotFoundError as e:
        sys.exit(f"error: {e}")
    transform, vocab = _scbert_count_transform(args.spaceranger, args.hd_binning,
                                               args.scbert_vocab)
    dls = _split_dls(spots, 5, stream=False, seed=args.split_seed,
                     val_arrays=args.val_arrays)

    def tokens_of(pair):
        """(N, vocab + 1) int16 tokens: the gene2vec transform clipped to
        [0, bin_num], then the zero token scBERT appends."""
        if pair is None:
            return None
        binned = np.minimum(transform(pair[0]), args.bin_num).astype(np.int16)
        return np.concatenate([binned, np.zeros((len(binned), 1), np.int16)], axis=1)

    token_dls = {k: tokens_of(v) for k, v in dls.items()}
    del dls, spots              # the float cohort dwarfs the int16 corpus
    n_val = 0 if token_dls.get("val") is None else len(token_dls["val"])
    print(f"MLM corpus: {len(token_dls['train'])} train / {n_val} val spots "
          f"x {vocab} gene2vec tokens, bins 0..{args.bin_num}"
          + (f" [mesh {mesh.shape}]" if mesh is not None else ""))
    # no positional embedding: the weights do not depend on the token count,
    # so the LM loads into scBERT at any n_genes
    lm = PerformerLM(num_tokens=args.bin_num + 2,
                     max_seq_len=mlm_token_len(vocab + 1, mesh),
                     dim=args.scbert_dim, depth=args.scbert_depth, heads=args.scbert_heads,
                     dim_head=args.scbert_dim_head, nb_features=args.scbert_features,
                     remat=args.remat, generalized_attention=not args.softmax_features)
    os.makedirs(args.out, exist_ok=True)
    outfile = os.path.join(args.out, "scbert_lm.msgpack")
    state, val_hist, _ = train_mlm(
        lm, token_dls, mask_id=args.bin_num + 1, mask_prob=args.mask_prob,
        learning_rate=args.lr, num_epochs=args.epochs, batch_size=args.batch_size,
        outfile=outfile, shuffle_seed=args.split_seed, redraw_every=args.redraw_every or None,
        resume=_resume_path(args, outfile), device=args.device, mesh=mesh)
    if not is_primary():
        return
    save_checkpoint(outfile, state, include_opt_state=False)
    with open(os.path.join(args.out, "pretrain.json"), "w") as fh:
        json.dump({"model": "PerformerLM-MLM", "vocab": vocab, "dim": args.scbert_dim,
                   "depth": args.scbert_depth, "heads": args.scbert_heads,
                   "dim_head": args.scbert_dim_head, "nb_features": args.scbert_features,
                   "bin_num": args.bin_num, "mask_prob": args.mask_prob,
                   # the checkpoint holds the best-validation weights
                   "val_loss": float(min(val_hist)) if val_hist else None}, fh)
    print(f"saved pretrained LM to {outfile}")


def fit_graph(state, nodes, edges, y, node_mask, steps: int, log=print) -> list:
    """``steps`` full-batch Adam updates of the ``HexGCN`` in ``state`` on one
    graph (the masked node loss); logs step 0, every 50th and the last, and
    returns every step's loss (device scalars)."""
    from gridnext_tpu_torch.models import graph_node_loss

    model, losses = state.model, []
    model.train()
    for i in range(steps):
        loss, correct, n = graph_node_loss(model(nodes, edges), y, node_mask)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        losses.append(loss.detach())
        if i % 50 == 0 or i == steps - 1:
            log(f"step {i}: loss {float(losses[-1]):.4f} "
                f"node acc {float(correct) / max(int(n), 1):.3f}")
    return losses


def _cmd_train_graph(args):
    """Node classification over the cohort's hex graph (``HexGCN``): every
    in-tissue spot of every array is a node of one node-offset graph
    (unannotated spots unlabeled, so the adjacency is the one ``register``
    serves), padded as the JAX command pads it, trained full-batch for
    ``--steps`` Adam updates on log1p counts; writes ``g_state.msgpack``
    and ``model.json`` (with the gene axis's ``feature_axis``)."""
    import json

    import numpy as np
    import torch

    from gridnext_tpu_torch.data.graph_data import (feature_axis_signature, pad_graph,
                                                    visium_to_graphdata)
    from gridnext_tpu_torch.models import HexGCN
    from gridnext_tpu_torch.train import create_train_state, make_adam, save_checkpoint

    if len(args.annots) != len(args.spaceranger):
        sys.exit("error: need one --annots file per --spaceranger dir")
    gd = visium_to_graphdata(args.spaceranger, annot_files=args.annots,
                             keep_unannotated=True)
    classes = [str(c) for c in gd["classes"]]
    n_real, n_real_edges = gd["nodes"].shape[0], gd["edges"].shape[1]
    n_labeled = int((gd["y"] >= 0).sum())
    gd = pad_graph(gd, ((n_real + 127) // 128) * 128 + 128)
    print(f"{n_labeled} annotated of {n_real} in-tissue spots across "
          f"{len(args.spaceranger)} arrays, {n_real_edges} edges, classes: {classes}")
    dev = args.device
    nodes = torch.as_tensor(np.log1p(gd["nodes"]), device=dev)
    model = HexGCN(nodes.shape[1], len(classes), hidden=args.hidden, depth=args.depth)
    state = create_train_state(model, make_adam(args.lr),
                               generator=torch.Generator().manual_seed(args.seed), device=dev)
    fit_graph(state, nodes, torch.as_tensor(gd["edges"], device=dev),
              torch.as_tensor(gd["y"], device=dev),
              torch.as_tensor(gd["node_mask"], device=dev), args.steps)
    os.makedirs(args.out, exist_ok=True)
    save_checkpoint(os.path.join(args.out, "g_state.msgpack"), state)
    with open(os.path.join(args.out, "model.json"), "w") as fh:
        json.dump({"classes": classes, "model": "HexGCN", "hidden": args.hidden,
                   "depth": args.depth, "log1p": True, "n_genes": int(nodes.shape[1]),
                   "feature_axis": feature_axis_signature(args.spaceranger[0])}, fh)
    print(f"saved model to {args.out}")


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


# -- evaluation ----------------------------------------------------------------------


def _array_names(spaceranger_dirs):
    """Per-array output names for map files: colliding basenames (every
    standard Spaceranger directory is 'outs') get an index prefix."""
    from gridnext_tpu_torch.io.unify import array_name

    names = [array_name(s) for s in spaceranger_dirs]
    if len(set(names)) < len(names):
        names = [f"{i:02d}_{n}" for i, n in enumerate(names)]
    return names


def _evaluate_graph(meta, classes, variables, args):
    """HexGCN directories: the annotated cohort as one hex graph (every
    in-tissue spot a node; metrics over the annotated ones), with per-array
    label and softmax grids for ``--maps`` (node outputs scattered back onto
    the odd-right lattice)."""
    import numpy as np
    import torch

    from gridnext_tpu_torch.data.graph_data import visium_to_graphdata
    from gridnext_tpu_torch.geometry import VISIUM_H_ST, VISIUM_W_ST, pseudo_hex_to_oddr
    from gridnext_tpu_torch.modeldir import graph_model_from_meta, validate_graph_feature_axis

    if args.f_only:
        sys.exit("error: --f-only does not apply to graph models (HexGCN "
                 "has no separate spot classifier f)")
    if args.tta:
        sys.exit("error: --tta applies to image-patch models only")
    if len(args.annots) != len(args.spaceranger):
        sys.exit("error: need one --annots file per --spaceranger dir")
    for srd in args.spaceranger:
        try:
            validate_graph_feature_axis(meta, srd)
        except ValueError as e:
            sys.exit(f"error: {e}")
    gd = visium_to_graphdata(args.spaceranger, annot_files=args.annots, keep_unannotated=True)
    ds_classes = [str(c) for c in gd["classes"]]
    unseen = [c for c in ds_classes if c not in classes]
    if unseen:
        sys.exit(f"error: annotations contain classes the model never "
                 f"trained on: {unseen} (model classes: {classes})")
    remap = np.asarray([classes.index(c) for c in ds_classes])

    model = graph_model_from_meta(meta, classes, variables, device=args.device)
    x = np.log1p(gd["nodes"]) if meta.get("log1p") else gd["nodes"]
    with torch.no_grad():
        logits = model(torch.as_tensor(x, device=args.device),
                       torch.as_tensor(gd["edges"], device=args.device))
        smax_all = torch.softmax(logits.float(), -1).cpu().numpy()
    y_enc = np.asarray(gd["y"])
    labeled = y_enc >= 0
    if not labeled.any():
        sys.exit("error: no annotated spots to evaluate")
    y_true = remap[y_enc[labeled]]
    smax = smax_all[labeled]
    y_pred = np.argmax(smax, -1)

    grids = []
    if args.maps:
        off = 0
        for n in gd["n_node"]:
            n = int(n)
            pos = gd["pos"][off:off + n]
            lab = labeled[off:off + n]
            ox, oy = pseudo_hex_to_oddr(pos[:, 0], pos[:, 1])
            tg = np.zeros((VISIUM_H_ST, VISIUM_W_ST), np.int64)
            sg = np.zeros((VISIUM_H_ST, VISIUM_W_ST, len(classes)))
            tg[oy[lab], ox[lab]] = remap[y_enc[off:off + n][lab]] + 1
            sg[oy, ox] = smax_all[off:off + n]
            grids.append((tg, sg))
            off += n
    return ("HexGCN", classes, len(args.spaceranger), y_true, y_pred, smax,
            {"grids": grids, "names": _array_names(args.spaceranger), "hex": True})


def _evaluate_one(model_dir, args):
    """Foreground predictions of one trained model directory over the
    annotated arrays: ``(model_name, classes, n_arrays, y_true, y_pred,
    smax, extras)``; image grids are cropped on the device, one gather
    launch a grid."""
    import numpy as np

    from gridnext_tpu_torch.compat.from_jax import load_model_dir
    from gridnext_tpu_torch.data import (DenseWSIGridDataset, MMStackDataset,
                                         create_visium_dataset)
    from gridnext_tpu_torch.evaluate import all_fgd_predictions
    from gridnext_tpu_torch.modeldir import grid_model_from_meta

    meta, classes, variables = load_model_dir(model_dir)
    model_name = meta.get("model", "")
    if model_name == "HexGCN":
        return _evaluate_graph(meta, classes, variables, args)
    hd_binning = meta.get("hd_binning")
    grid_dims = tuple(meta["grid_dims"]) if meta.get("grid_dims") else None
    mm = model_name in ("GridNetHexMM", "GridNetMM")
    if mm and args.f_only:
        # the multimodal patch predictions concatenate both modalities' f
        # outputs (2C channels), not a per-class softmax
        sys.exit("error: --f-only is ambiguous for multimodal models "
                 "(patch predictions concatenate both modalities); "
                 "evaluate the single-modality models instead")
    use_image = mm or model_name.endswith(("DenseNet121", "TpuPatchClassifier"))
    use_count = mm or not use_image
    if len(args.annots) != len(args.spaceranger):
        sys.exit("error: need one --annots file per --spaceranger dir")
    if use_image:
        _require_one_image_per_dir(args.images, args.spaceranger)
    if use_count:
        for srd in args.spaceranger:
            _validated_count_cache(srd, meta)

    transform = None
    if use_count:
        if meta.get("count_f") == "scbert":
            transform, _ = _scbert_count_transform(args.spaceranger, hd_binning,
                                                   meta["scbert_vocab"])
        elif meta.get("log1p"):
            transform = np.log1p

    if meta.get("dense_ingest") and use_image and grid_dims:
        # dense-ingest HD models: patch grids tiled off the slides, the labels
        # riding the image grids
        ds = DenseWSIGridDataset(args.images, args.spaceranger, args.annots,
                                 patch_size=meta.get("patch_px", 128), hd_binning=hd_binning,
                                 grid_dims=grid_dims, device=args.device)
        if mm:
            ds = MMStackDataset(ds, create_visium_dataset(
                args.spaceranger, use_image=False, annot_files=args.annots,
                hd_binning=hd_binning, grid_dims=grid_dims, minimum_detection_rate=None))
    else:
        kw = dict(annot_files=args.annots, hd_binning=hd_binning, grid_dims=grid_dims,
                  minimum_detection_rate=None, device=args.device)
        if use_image:
            kw.update(fullres_image_files=args.images, patch_size_px=meta.get("patch_px", 128),
                      window_size_px=meta.get("window_px"))
        ds = create_visium_dataset(args.spaceranger, use_count=use_count, use_image=use_image,
                                   **kw)

    # the cohort's label encoding (sorted over ITS annotation union) remapped
    # onto the model's training classes
    ds_classes = [] if ds.classes is None else [str(c) for c in ds.classes]
    unseen = [c for c in ds_classes if c not in classes]
    if unseen:
        sys.exit(f"error: annotations contain classes the model never "
                 f"trained on: {unseen} (model classes: {classes})")
    lut = np.zeros(len(ds_classes) + 1, np.int64)
    for i, name in enumerate(ds_classes):
        lut[i + 1] = classes.index(name) + 1

    g = grid_model_from_meta(meta, classes, variables, device=args.device)
    trues, preds, smaxes, grids = [], [], [], []
    for i in range(len(ds)):
        x, y = ds[i]
        y = lut[np.asarray(y).astype(np.int64)]
        if mm:
            xi, xc = x
            if transform is not None:
                xc = transform(np.asarray(xc))
            x = (xi[None], np.asarray(xc)[None])
        else:
            if transform is not None:
                x = transform(np.asarray(x))
            x = x[None]
        t, p, sm, gr = all_fgd_predictions((x, y[None]), g, f_only=args.f_only,
                                           return_grids=True, tta=args.tta)
        del x
        trues.append(t)
        preds.append(p)
        smaxes.append(sm)
        if args.maps:
            grids.extend(gr)
    y_true = np.concatenate(trues)
    if not len(y_true):
        sys.exit("error: no annotated foreground spots to evaluate")
    return (model_name, classes, len(ds), y_true, np.concatenate(preds),
            np.concatenate(smaxes),
            {"grids": grids, "names": _array_names(args.spaceranger),
             "hex": grid_dims is None})


def _fgd_metrics(model_name, classes, n_arrays, y_true, y_pred, smax, f_only=False):
    """Foreground metrics: accuracy, per-class and macro AUROC / AUPRC
    (one-vs-rest; None for a class absent or alone), the classification
    report and the confusion counts."""
    import numpy as np

    from gridnext_tpu_torch.metrics import (average_precision_score, classification_report,
                                            confusion_matrix, roc_auc_score)

    n_c = len(classes)
    auroc, auprc = {}, {}
    for c in range(n_c):
        pos = y_true == c
        if pos.any() and not pos.all():
            auroc[classes[c]] = float(roc_auc_score(pos, smax[:, c]))
            auprc[classes[c]] = float(average_precision_score(pos, smax[:, c]))
        else:
            auroc[classes[c]] = auprc[classes[c]] = None
    present_roc = [v for v in auroc.values() if v is not None]
    present_pr = [v for v in auprc.values() if v is not None]
    return {
        "model": model_name, "classes": list(classes), "f_only": bool(f_only),
        "n_arrays": n_arrays, "n_foreground_spots": int(len(y_true)),
        "accuracy": float((y_true == y_pred).mean()),
        "macro_auroc": float(np.mean(present_roc)) if present_roc else None,
        "macro_auprc": float(np.mean(present_pr)) if present_pr else None,
        "auroc_per_class": auroc, "auprc_per_class": auprc,
        "report": classification_report(y_true, y_pred, labels=list(range(n_c)),
                                        target_names=classes, zero_division=0),
        "confusion": confusion_matrix(y_true, y_pred, labels=list(range(n_c))).tolist(),
    }


def _save_eval_maps(maps_dir, names, grids, classes, hex_coords):
    """Per array: the true and predicted label maps (hex-aware scatter) and
    the misclassification-density heatmap."""
    import matplotlib

    matplotlib.use("Agg")
    import numpy as np
    from matplotlib import pyplot as plt

    from gridnext_tpu_torch.plotting import misclass_density, plot_label_tensor

    os.makedirs(maps_dir, exist_ok=True)
    for name, (true_grid, smax_grid) in zip(names, grids):
        pred_grid = (np.argmax(smax_grid, -1) + 1) * (true_grid > 0)
        for tag, grid in (("true", true_grid), ("pred", pred_grid)):
            fig, ax = plt.subplots(figsize=(10, 8))
            plot_label_tensor(grid, class_names=classes, Visium=hex_coords, ax=ax)
            fig.savefig(os.path.join(maps_dir, f"{name}_{tag}.png"), dpi=120,
                        bbox_inches="tight")
            plt.close(fig)
        fig, ax = plt.subplots(figsize=(10, 8))
        im = ax.imshow(misclass_density(smax_grid, true_grid), cmap="magma", vmin=0.0,
                       vmax=1.0)
        ax.axis("off")
        fig.colorbar(im, ax=ax, shrink=0.8, label="1 - p(true class)")
        fig.savefig(os.path.join(maps_dir, f"{name}_misclass.png"), dpi=120,
                    bbox_inches="tight")
        plt.close(fig)
    print(f"label/misclass maps -> {maps_dir} ({len(names)} arrays x 3)")


def _save_eval_plots(plots_dir, y_true, y_pred, smax, classes, prefix=""):
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    from gridnext_tpu_torch.plotting import performance_curves, plot_confusion

    os.makedirs(plots_dir, exist_ok=True)
    fig, _, _, _ = performance_curves(y_true, smax, class_names=classes)
    fig.savefig(os.path.join(plots_dir, f"{prefix}curves.png"), dpi=120, bbox_inches="tight")
    plt.close(fig)
    fig, _ = plot_confusion(y_true, y_pred, class_names=classes)
    fig.savefig(os.path.join(plots_dir, f"{prefix}confusion.png"), dpi=120,
                bbox_inches="tight")
    plt.close(fig)
    print(f"figures -> {plots_dir}/{prefix}curves.png, {prefix}confusion.png")


def _cmd_evaluate(args):
    """Metrics of trained model(s) over annotated arrays: foreground
    accuracy, per-class and macro AUROC / AUPRC, the classification report
    and the confusion matrix, as JSON (``--plots`` / ``--maps``: figures).
    Several ``--model`` directories also score their consensus (mean
    softmax, then argmax). Returns the metrics dict."""
    import json

    import numpy as np

    from gridnext_tpu_torch.serving import resolve_device

    if args.plots or args.maps:
        try:
            import matplotlib  # noqa: F401
        except ImportError:
            sys.exit("error: --plots / --maps need matplotlib, which is not installed "
                     "(evaluate without them writes the metrics JSON alone)")
    args.device = resolve_device(args.device)
    per_model = [_evaluate_one(m, args) for m in args.model]
    if len(per_model) == 1:
        model_name, classes, n_arrays, y_true, y_pred, smax, extra = per_model[0]
        metrics = _fgd_metrics(model_name, classes, n_arrays, y_true, y_pred, smax,
                               f_only=args.f_only)
        if args.plots:
            _save_eval_plots(args.plots, y_true, y_pred, smax, classes)
        if args.maps:
            _save_eval_maps(args.maps, extra["names"], extra["grids"], classes, extra["hex"])
    else:
        families = {"graph" if pm[0] == "HexGCN" else "grid" for pm in per_model}
        if len(families) > 1:
            # graph models flatten the foreground in positions-file node
            # order, grid models in raster order: a mean would mix spots
            sys.exit("error: consensus cannot mix graph (HexGCN) and grid "
                     "models -- their foreground orderings differ; "
                     "evaluate them separately")
        base = per_model[0]
        for other in per_model[1:]:
            if list(other[1]) != list(base[1]):
                sys.exit(f"error: models disagree on classes: {other[1]} "
                         f"vs {base[1]} -- consensus needs a shared label "
                         "space")
            if not np.array_equal(other[3], base[3]):
                sys.exit("error: models disagree on the foreground truth "
                         "vector; evaluate them over the same arrays and "
                         "annotations")
        classes, y_true = base[1], base[3]
        from gridnext_tpu_torch.evaluate import consensus_softmax

        smax_c = consensus_softmax([pm[5] for pm in per_model])
        pred_c = np.argmax(smax_c, axis=1)
        metrics = {
            "models": {m: _fgd_metrics(pm[0], classes, pm[2], pm[3], pm[4], pm[5],
                                       f_only=args.f_only)
                       for m, pm in zip(args.model, per_model)},
            "consensus": _fgd_metrics("consensus(" + "+".join(pm[0] for pm in per_model)
                                      + ")", classes, base[2], y_true, pred_c, smax_c,
                                      f_only=args.f_only),
        }
        if args.plots:
            _save_eval_plots(args.plots, y_true, pred_c, smax_c, classes, prefix="consensus_")
        if args.maps:
            # consensus maps: the same true grids, the mean softmax of the models
            extras = [pm[6] for pm in per_model]
            grids = [(t, np.mean([e["grids"][i][1] for e in extras], axis=0))
                     for i, (t, _) in enumerate(extras[0]["grids"])]
            _save_eval_maps(args.maps, extras[0]["names"], grids, classes, extras[0]["hex"])

    with open(args.out, "w") as fh:
        json.dump(metrics, fh, indent=1)
    for label, m in ([("", metrics)] if len(per_model) == 1 else
                     [(f"[{k}] ", v) for k, v in metrics["models"].items()]
                     + [("[consensus] ", metrics["consensus"])]):
        print(f"{label}{m['n_foreground_spots']} foreground spots over "
              f"{m['n_arrays']} arrays: acc {m['accuracy']:.4f}, "
              f"mAUROC {m['macro_auroc']}, mAUPRC {m['macro_auprc']}")
    print(f"metrics -> {args.out}")
    return metrics


# -- distillation --------------------------------------------------------------------


def _distill_count_mm(args, meta, classes, tvars):
    """``distill`` of a multimodal directory with an scBERT count f: the
    count f distils into a stateless ``CountMLP`` on raw log1p counts (the
    teacher reads gene2vec tokens of the same spots), the image f and the
    corrector carry over verbatim, and a multimodal directory with
    ``count_f: "mlp"`` is written. Returns the distillation info."""
    import numpy as np
    import torch

    from gridnext_tpu_torch.compat.from_jax import load_model_dir
    from gridnext_tpu_torch.data import create_visium_dataset
    from gridnext_tpu_torch.modeldir import mm_model_from_meta
    from gridnext_tpu_torch.models import CountMLP
    from gridnext_tpu_torch.train.distill import (distill_patch_classifier, label_agreement,
                                                  write_count_distilled_mm_dir)

    dev = args.device
    for srd in args.spaceranger:
        _validated_count_cache(srd, meta)
    grid_dims = tuple(meta["grid_dims"]) if meta.get("grid_dims") else None
    spots = create_visium_dataset(args.spaceranger, spatial=False, use_count=True,
                                  use_image=False, hd_binning=meta.get("hd_binning"),
                                  grid_dims=grid_dims, minimum_detection_rate=None)
    raw, _ = spots.materialize()
    rng = np.random.default_rng(args.split_seed)
    if len(raw) > args.max_patches:
        # the resident pool's cap; the gene2vec view stays float32 (scBERT
        # floors its continuous values into bins: bf16 would flip bins)
        pick = np.sort(rng.choice(len(raw), size=args.max_patches, replace=False))
        print(f"sampling {args.max_patches} of {len(raw)} spots (--max-patches)")
        raw = raw[pick]
    transform, _ = _scbert_count_transform(args.spaceranger, meta.get("hd_binning"),
                                           meta["scbert_vocab"])
    t_pool = transform(raw)
    s_pool = np.log1p(raw)

    mm = mm_model_from_meta(meta, classes, tvars, device=dev)
    teacher = mm.count_classifier
    order = rng.permutation(len(raw))
    n_hold = max(1, int(len(raw) * args.holdout))
    hold_idx, train_idx = order[:n_hold], order[n_hold:]
    if not len(train_idx):
        sys.exit("error: no training spots left after the holdout split")
    print(f"distilling scBERT count-f -> CountMLP on {len(train_idx)} "
          f"spots ({n_hold} held out), {args.steps} steps x batch "
          f"{args.batch_size}")
    student = CountMLP(raw.shape[1], len(classes), batch_norm=False)
    batch = min(args.batch_size, len(train_idx))
    svars, losses = distill_patch_classifier(
        teacher, student, torch.as_tensor(s_pool[train_idx], device=dev),
        teacher_inputs=torch.as_tensor(t_pool[train_idx], device=dev), steps=args.steps,
        batch_size=batch, learning_rate=args.lr, temperature=args.temperature,
        kl_weight=args.kl_weight, verbose=True)

    # the holdout's teacher logits in chunks of the training batch, which
    # the loop has shown to fit (the JAX package's 512 would not: at 16,907
    # tokens q, k and v alone take 66 GB in float32)
    t_hold = t_pool[hold_idx]
    with torch.no_grad():
        t_lab = torch.cat([torch.argmax(teacher(torch.as_tensor(t_hold[i:i + batch],
                                                                device=dev)), -1)
                           for i in range(0, len(t_hold), batch)])
        s_lab = torch.argmax(student(torch.as_tensor(s_pool[hold_idx], device=dev)), -1)
    agr_f = float((t_lab == s_lab).float().mean())
    print(f"holdout count-f agreement (argmax): {agr_f:.4f}")
    info = {"count_f_agreement": agr_f, "steps": args.steps, "final_loss": losses[-1]}
    write_count_distilled_mm_dir(args.out, meta, classes, tvars, svars, info)

    if args.images is not None:
        # full-MM label agreement over the arrays: both models on the same
        # grids, each with its own count preprocessing
        _require_one_image_per_dir(args.images, args.spaceranger)
        s_meta, s_classes, s_vars = load_model_dir(args.out)
        mm_student = mm_model_from_meta(s_meta, s_classes, s_vars, device=dev)
        grids = create_visium_dataset(
            args.spaceranger, use_count=True, use_image=True,
            fullres_image_files=args.images, patch_size_px=meta.get("patch_px", 128),
            window_size_px=meta.get("window_px"), hd_binning=meta.get("hd_binning"),
            grid_dims=grid_dims, minimum_detection_rate=None, device=dev)
        agrs = []
        for i in range(len(args.spaceranger)):
            (xi, xc), _ = grids[i]
            fg = xc.sum(-1) > 0
            with torch.no_grad():
                lt = torch.argmax(mm((xi[None], torch.as_tensor(
                    transform(xc)[None], device=dev)))[0], -1).cpu().numpy() + 1
                ls = torch.argmax(mm_student((xi[None], torch.as_tensor(
                    np.log1p(xc)[None], device=dev)))[0], -1).cpu().numpy() + 1
            del xi
            agrs.append(label_agreement(np.where(fg, lt, 0), np.where(fg, ls, 0)))
        agr_label = float(np.mean(agrs))
        print(f"full-MM label agreement (teacher vs student): "
              f"{agr_label:.4f} over {len(agrs)} arrays")
        info["label_agreement"] = agr_label
        write_count_distilled_mm_dir(args.out, meta, classes, tvars, svars, info)
    if (args.min_agreement is not None
            and info.get("label_agreement", info["count_f_agreement"]) < args.min_agreement):
        sys.exit(f"error: agreement below --min-agreement "
                 f"{args.min_agreement}: {info}")
    print(f"distilled multimodal model dir written to {args.out} "
          "(count_f=mlp, image f + corrector carried verbatim)")
    return info


def _cmd_distill(args):
    """Distil a trained image model's spot classifier f into the
    ``TpuPatchClassifier`` student (bf16 by default) over a pool of the
    cohort's spot patches, cropped from the slides (``--images``) on the
    device in one gather launch; the teacher's corrector carries over
    verbatim. Records the holdout patch agreement and the full-slide label
    agreement of the two directories' registrars in ``model.json``. A multimodal directory
    with an scBERT count f distils that f (:func:`_distill_count_mm`).
    Returns the distillation info."""
    import numpy as np
    import torch

    from gridnext_tpu_torch import ingest
    from gridnext_tpu_torch.compat.from_jax import load_model_dir
    from gridnext_tpu_torch.data import create_visium_dataset
    from gridnext_tpu_torch.data.datasets import to_device_slide
    from gridnext_tpu_torch.io import read_positions
    from gridnext_tpu_torch.modeldir import image_f_from_meta, image_registrar_from_meta
    from gridnext_tpu_torch.models import TpuPatchClassifier
    from gridnext_tpu_torch.serving import resolve_device
    from gridnext_tpu_torch.train.distill import (distill_patch_classifier, label_agreement,
                                                  patch_agreement, write_distilled_model_dir)

    args.device = dev = resolve_device(args.device)
    meta, classes, tvars = load_model_dir(args.model)
    if meta.get("model") in ("GridNetHexMM", "GridNetMM"):
        if meta.get("count_f") != "scbert":
            sys.exit("error: this multimodal dir's count-f is already an "
                     "MLP; distillation targets scBERT count classifiers "
                     "(count_f='scbert') or image models")
        return _distill_count_mm(args, meta, classes, tvars)
    try:
        teacher_f, _ = image_f_from_meta(meta, classes, tvars, device=dev)
    except ValueError as e:
        sys.exit(f"error: {e}")
    # the port crops the pool from the slides (it keeps no patch caches)
    _require_one_image_per_dir(args.images, args.spaceranger)

    patch_px = meta.get("patch_px", 128)
    grid_dims = tuple(meta["grid_dims"]) if meta.get("grid_dims") else None
    ds = create_visium_dataset(args.spaceranger, use_count=False, use_image=True,
                               spatial=False, fullres_image_files=args.images,
                               patch_size_px=patch_px, window_size_px=meta.get("window_px"),
                               hd_binning=meta.get("hd_binning"), grid_dims=grid_dims,
                               device=dev)
    rng = np.random.default_rng(args.split_seed)
    if len(ds) > args.max_patches:
        # the resident pool's cap: a uniform sample across all arrays
        pick = np.sort(rng.choice(len(ds), size=args.max_patches, replace=False))
        print(f"sampling {args.max_patches} of {len(ds)} patches (--max-patches)")
        patches, _ = ds.batch(pick)
    else:
        patches, _ = ds.materialize()
    order = torch.as_tensor(rng.permutation(len(patches)), device=dev)
    n_hold = max(1, int(len(patches) * args.holdout))
    hold, train = patches[order[:n_hold]], patches[order[n_hold:]]
    del patches
    if not len(train):
        sys.exit("error: no training patches left after the holdout split")
    print(f"distilling {meta.get('model')} -> TpuPatchClassifier on "
          f"{len(train)} patches ({n_hold} held out) @ {patch_px}px, "
          f"{args.steps} steps x batch {args.batch_size}")

    arch = {}
    if args.student_stages:
        try:
            arch["stages"] = tuple((int(w), int(d)) for w, d in
                                   (part.split(":") for part in args.student_stages.split(",")))
        except ValueError:
            sys.exit("error: --student-stages must look like '256:2,512:2' "
                     "(width:depth pairs)")
    if args.student_stem:
        arch["stem_patch"] = args.student_stem
    student = TpuPatchClassifier(n_classes=len(classes),
                                 dtype=None if args.f32 else torch.bfloat16, **arch)
    svars, losses = distill_patch_classifier(
        teacher_f, student, train, steps=args.steps,
        batch_size=min(args.batch_size, len(train)), learning_rate=args.lr,
        temperature=args.temperature, kl_weight=args.kl_weight, verbose=True)
    del train

    agr_patch = patch_agreement(teacher_f, student, hold)
    del hold, teacher_f
    print(f"holdout patch agreement (f argmax): {agr_patch:.4f}")
    info = {"patch_agreement": agr_patch, "steps": args.steps, "final_loss": losses[-1]}
    write_distilled_model_dir(args.out, meta, classes, tvars, svars, student, info)

    # the end-to-end parity: the teacher's registrar against the written
    # student directory's, per array
    reg_t = image_registrar_from_meta(meta, classes, tvars, device=dev)
    s_meta, s_classes, s_vars = load_model_dir(args.out)
    reg_s = image_registrar_from_meta(s_meta, s_classes, s_vars, device=dev)
    agrs = []
    for srd, im in zip(args.spaceranger, args.images):
        wsi = to_device_slide(ingest.decode_slide(im), dev)
        pos = read_positions(srd, meta.get("hd_binning"))
        agrs.append(label_agreement(reg_t(wsi, pos), reg_s(wsi, pos)))
        del wsi
    agr_label = float(np.mean(agrs))
    print(f"full-slide label agreement (teacher g vs student g): "
          f"{agr_label:.4f} over {len(agrs)} arrays")
    info["label_agreement"] = agr_label
    out_meta = write_distilled_model_dir(args.out, meta, classes, tvars, svars, student, info)
    if (args.min_agreement is not None
            and info.get("label_agreement", info["patch_agreement"]) < args.min_agreement):
        sys.exit(f"error: agreement below --min-agreement "
                 f"{args.min_agreement}: {info}")
    print(f"distilled model dir written to {args.out} (model {out_meta['model']})")
    return info


# -- serving surfaces: export, serve-artifact, serve ---------------------------------


def _cmd_export(args):
    """A trained model's registration as a ``torch.export`` artifact (the
    bytes of a ``.pt2``, weights inside, the kernels as ``gridnext::`` ops;
    reload with ``serving.load_exported_registration``, no model code) and
    its JSON sidecar. Image models export slide -> labels (``--wsi-shape``;
    ``--dense``: an exact HD lattice); count and multimodal models their
    grid -> labels forward (shapes from model.json). The artifact runs on
    ``--device``'s type only."""
    import json

    from gridnext_tpu_torch import geometry
    from gridnext_tpu_torch.compat.from_jax import load_model_dir
    from gridnext_tpu_torch.modeldir import grid_model_from_meta, image_registrar_from_meta
    from gridnext_tpu_torch.server import ARTIFACT_FORMAT
    from gridnext_tpu_torch.serving import export_grid_forward, resolve_device

    device = resolve_device(args.device)
    meta, classes, variables = load_model_dir(args.model)
    model_name = meta.get("model", "")
    grid_dims = meta.get("grid_dims")
    h_st, w_st = (tuple(grid_dims) if grid_dims
                  else (geometry.VISIUM_H_ST, geometry.VISIUM_W_ST))
    sidecar = {"classes": classes, "h_st": int(h_st), "w_st": int(w_st),
               "platforms": args.platforms, "model": model_name,
               "format": ARTIFACT_FORMAT, "device": device.type}
    try:
        if model_name.endswith(("DenseNet121", "TpuPatchClassifier")):
            if args.wsi_shape is None:
                sys.exit("error: image-model export needs --wsi-shape H W")
            registrar = image_registrar_from_meta(meta, classes, variables, device=device)
            h, w = args.wsi_shape
            shape = (int(h), int(w), 3)
            sidecar.update(wsi_shape=list(shape), window_px=registrar.window_size,
                           hex_coords=registrar.hex_coords,
                           hd_binning=meta.get("hd_binning"))
            if args.dense:
                # an exact integer-pitch lattice only: the fractional-pitch
                # resample stays a live-registrar path
                if not args.spaceranger:
                    sys.exit("error: export --dense needs --spaceranger SRD (a "
                             "representative array to fit the bin lattice)")
                from gridnext_tpu_torch.io import read_positions
                from gridnext_tpu_torch.serving import fit_dense_lattice

                pos = read_positions(args.spaceranger[0], meta.get("hd_binning"))
                plan = fit_dense_lattice(pos, registrar.h_st, registrar.w_st,
                                         registrar.window_size, shape)
                if plan is None or plan[0] != "exact":
                    sys.exit("error: --dense needs an exact integer-pitch lattice "
                             "within --wsi-shape; fractional-pitch HD lattices use the "
                             "banded resample (a live-registrar path) -- use "
                             "`register`, or export the per-spot artifact with a "
                             "large-enough --n-spots")
                _, _, _, _, ey, ex = plan
                blob = registrar.export_dense(shape, ey, ex, platforms=args.platforms)
                sidecar.update(kind="dense", extent=[int(ey), int(ex)],
                               inputs="(wsi, oy0, ox0, fg) from an exact "
                                      "serving.fit_dense_lattice plan")
            else:
                blob = registrar.export(shape, n_spots=args.n_spots,
                                        platforms=args.platforms)
                sidecar.update(n_spots=args.n_spots,
                               inputs="(wsi, oy, ox, y_px, x_px); see "
                                      "serving.artifact_spot_inputs")
        elif model_name in ("GridNetHexMM", "GridNetMM"):
            g = grid_model_from_meta(meta, classes, variables, device=device)
            p = meta.get("patch_px", 128)
            scbert = meta.get("count_f") == "scbert"
            n_c = meta["scbert_vocab"] if scbert else meta["n_genes"]
            shapes = ((h_st, w_st, p, p, 3), (h_st, w_st, n_c))
            # scBERT's gene2vec reindex zeroes unmapped genes, so the tissue
            # comes in as a mask (from the raw counts, as register takes it)
            blob = export_grid_forward(g, shapes, platforms=args.platforms,
                                       explicit_fg=scbert)
            if scbert:
                inputs = ("(image_grid, count_grid, fg_mask) batched (1, ...); "
                          "counts gene2vec-transformed (preprocess_scbert), "
                          "fg_mask int32 from RAW counts (raw.sum(-1) > 0)")
            elif meta.get("log1p"):
                inputs = "(image_grid, count_grid) batched (1, ...); counts log1p-transformed"
            else:
                inputs = "(image_grid, count_grid) batched (1, ...)"
            sidecar.update(grid_shapes=[list(s) for s in shapes], explicit_fg=scbert,
                           inputs=inputs)
        elif model_name.endswith("CountMLP"):
            g = grid_model_from_meta(meta, classes, variables, device=device)
            shape = (h_st, w_st, meta["n_genes"])
            blob = export_grid_forward(g, shape, platforms=args.platforms)
            inputs = "(count_grid,) batched (1, H, W, n_genes)"
            if meta.get("log1p"):
                inputs += "; log1p-transformed"
            sidecar.update(grid_shapes=[list(shape)], inputs=inputs)
        else:
            sys.exit(f"error: don't know how to export model {model_name!r}")
    except ValueError as e:
        sys.exit(f"error: {e}")
    with open(args.out, "wb") as fh:
        fh.write(blob)
    with open(args.out + ".json", "w") as fh:
        json.dump(sidecar, fh, indent=1)
    print(f"wrote {args.out} ({len(blob) / 1e6:.1f} MB) + sidecar {args.out}.json")


def _cmd_serve_artifact(args):
    """Register slides through an exported artifact: decode and staging on
    ``SlideSource``'s thread, the fixed-shape inputs from the sidecar, one
    artifact call a slide, a Loupe CSV each. Builds no model."""
    from gridnext_tpu_torch.ingest import SlideSource
    from gridnext_tpu_torch.server import artifact_inputs, load_artifact, run_artifact
    from gridnext_tpu_torch.serving import resolve_device

    _require_one_image_per_dir(args.images, args.spaceranger)
    device = resolve_device(args.device)
    try:
        fn, side = load_artifact(args.artifact, device)
    except (FileNotFoundError, ValueError) as e:
        sys.exit(f"error: {e}")
    hexc = side.get("hex_coords", True)
    source = SlideSource(args.images, args.spaceranger, hd_binning=side.get("hd_binning"),
                         device=device)
    for i, wsi, pos in source:
        try:
            inputs = artifact_inputs(side, wsi.shape, pos, args.images[i], args.spaceranger[i])
        except ValueError as e:
            sys.exit(f"error: {e}")
        labels = run_artifact(fn, wsi, inputs, device)
        _write_loupe(labels, args.spaceranger[i], args, side["classes"],
                     hd_binning=side.get("hd_binning"), hex_coords=hexc, index=i)


def _cmd_serve(args):
    """The resident registration server (``server.py``): the model (or
    artifact) loaded once onto ``--device``, then one registration per HTTP
    request."""
    import time

    from gridnext_tpu_torch.server import RegistrationService, make_server

    try:
        if args.artifact:
            if args.mesh is not None:
                sys.exit("error: --mesh applies to --model serving; "
                         "artifacts serialize the single-device path "
                         "(re-export is not mesh-aware)")
            service = RegistrationService.from_artifact(args.artifact, device=args.device)
        else:
            service = RegistrationService.from_model_dir(
                args.model, max_batch=args.max_batch, device=args.device,
                mesh=_serving_mesh(args))
    except (ValueError, FileNotFoundError) as e:
        sys.exit(f"error: {e}")

    if args.warmup:
        # the first request's set-up (kernel builds, the allocator's first
        # blocks) before listening
        if service.needs_image and len(args.warmup) != 2:
            sys.exit("error: --warmup needs IMAGE SPACERANGER for this model "
                     "(it registers slides)")
        if not service.needs_image and len(args.warmup) != 1:
            sys.exit("error: --warmup needs just SPACERANGER for a count model")
        image, srd = ((args.warmup[0], args.warmup[1]) if service.needs_image
                      else (None, args.warmup[0]))
        t0 = time.perf_counter()
        try:
            service.register(srd, image=image)
        except (ValueError, FileNotFoundError) as e:
            sys.exit(f"error: warmup failed: {e}")
        print(f"warmup register: {time.perf_counter() - t0:.1f}s (includes the "
              "kernels' first use); subsequent requests skip it")
        # /metrics describes steady serving, not the warm-up request
        service.reset_metrics()

    httpd = make_server(service, args.host, args.port, verbose=args.verbose)
    host, port = httpd.server_address[:2]
    info = service.info()
    print(f"serving {info['model']} ({len(service.classes)} classes, backend "
          f"{info['backend']}, {info['device_name']}) on http://{host}:{port} -- "
          "GET /healthz | /metrics, POST /register", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        print("shutting down")
    finally:
        httpd.server_close()


def build_parser():
    """The port's argument parser (one subparser per ported command)."""
    ap = argparse.ArgumentParser(prog="gridnext_tpu_torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--profile-dir", default=None, metavar="DIR",
                    help="trace the whole command with torch.profiler into DIR (a Chrome "
                         "trace JSON: host ops, and the card's kernels under CUDA; open it "
                         "in chrome://tracing or ui.perfetto.dev); goes BEFORE the "
                         "subcommand: gridnext_tpu_torch --profile-dir /tmp/tr register ...")
    ap.add_argument("--multihost", action="store_true",
                    help="join the process group torchrun describes (MASTER_ADDR, "
                         "MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK) before the "
                         "command; training commands only")
    ap.add_argument("--coordinator", default=None,
                    help="wire the process group by hand: 'host:port,num_processes,"
                         "process_id' (implies --multihost)")
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
    s.add_argument("--mesh", default=None,
                   help="image models: register over the visible cards ('auto' or "
                        "axis sizes like 'data=4,spot=2'); the flat spot axis splits "
                        "over every mesh axis, labels as on one card")
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
    s.add_argument("--scbert-ckpt", default=None,
                   help="start the scBERT count f from a checkpoint: a torch .pth "
                        "(converted on the fly) or a flax msgpack (pretrain-scbert's "
                        "scbert_lm.msgpack); mismatched entries (the classifier head, a "
                        "truncated vocabulary) re-initialise")
    s.add_argument("--scbert-finetune", action="store_true",
                   help="freeze all but the final norm, the last-but-one performer "
                        "layer and the head, in the spot and the grid stage")
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

    s = sub.add_parser("train-graph",
                       help="train the HexGCN node classifier over the cohort hex graph")
    s.add_argument("--spaceranger", nargs="+", required=True)
    s.add_argument("--annots", nargs="+", required=True)
    s.add_argument("--out", required=True)
    s.add_argument("--steps", type=int, default=200,
                   help="full-batch optimizer updates over the cohort graph")
    s.add_argument("--lr", type=float, default=5e-3)
    s.add_argument("--hidden", type=int, default=64, help="graph-conv hidden width")
    s.add_argument("--depth", type=int, default=3, help="message-passing layers")
    s.add_argument("--seed", type=int, default=0)
    _add_device_arg(s, "training")
    s.set_defaults(fn=_cmd_train_graph)

    s = sub.add_parser("pretrain-scbert",
                       help="masked-expression (MLM) pretraining of an scBERT-scale "
                            "PerformerLM on a cohort (no annotations needed); feed the "
                            "checkpoint to train-mm --count-f scbert --scbert-ckpt")
    s.add_argument("--spaceranger", nargs="+", required=True)
    s.add_argument("--out", required=True)
    s.add_argument("--epochs", type=int, default=10)
    s.add_argument("--batch-size", type=int, default=4, help="sequences per step")
    s.add_argument("--lr", type=float, default=1e-4)
    s.add_argument("--mask-prob", type=float, default=0.15)
    s.add_argument("--bin-num", type=int, default=5,
                   help="expression bins (tokens 0..bin_num; mask id bin_num+1; "
                        "vocabulary bin_num+2)")
    s.add_argument("--min-detection", type=float, default=None,
                   help="gene detection-rate filter (default 0.02)")
    s.add_argument("--hd-binning", default=None,
                   help="Visium HD binned output to read (e.g. square_008um)")
    s.add_argument("--scbert-vocab", type=int, default=16906,
                   help="gene2vec tokens (full vocabulary = 16,906; truncate for small runs)")
    s.add_argument("--scbert-dim", type=int, default=200,
                   help="model width (200 = the reference checkpoint shape)")
    s.add_argument("--scbert-depth", type=int, default=6)
    s.add_argument("--scbert-heads", type=int, default=10)
    s.add_argument("--scbert-dim-head", type=int, default=64,
                   help="per-head attention width (64 = the reference checkpoint shape)")
    s.add_argument("--scbert-features", type=int, default=None,
                   help="FAVOR random features m per head (default dim_head*ln(dim_head)); "
                        "must match between pretrain-scbert and train-mm")
    s.add_argument("--remat", action="store_true",
                   help="recompute each performer layer's activations in the backward "
                        "(less device memory; FAVOR's kernel runs twice a layer)")
    s.add_argument("--softmax-features", action="store_true",
                   help="softmax FAVOR features instead of the default generalized (ReLU) "
                        "ones, which run through the card's FAVOR kernel; the checkpoint "
                        "serves either")
    s.add_argument("--redraw-every", type=int, default=1000,
                   help="FAVOR+ projection redraw interval in steps (0 disables)")
    s.add_argument("--mesh", default=None,
                   help="multi-card mesh: 'auto' or axis sizes like 'data=8' (pure DP) or "
                        "'data=2,seq=4' (sequence-parallel: the gene-token axis and its "
                        "FAVOR sums shard over 'seq', the rows over 'data'), one process "
                        "a card (torchrun / --coordinator); without 'seq' batch rows shard "
                        "over every axis")
    s.add_argument("--split-seed", type=int, default=0,
                   help="seed for the random train/val split")
    s.add_argument("--val-arrays", nargs="+", default=None,
                   help="hold out these whole arrays (dir basenames) for "
                        "validation instead of a random split")
    s.add_argument("--resume", action="store_true",
                   help="continue an interrupted run from the '.latest' "
                        "checkpoint in --out (--epochs is the TOTAL count)")
    _add_device_arg(s, "training")
    s.set_defaults(fn=_cmd_pretrain_scbert)

    s = sub.add_parser(
        "evaluate",
        help="metrics (acc / AUROC / AUPRC / confusion) for a trained "
             "model over annotated arrays")
    s.add_argument("--spaceranger", nargs="+", required=True)
    s.add_argument("--annots", nargs="+", required=True,
                   help="Loupe annotation CSVs, one per array (the ground truth)")
    s.add_argument("--model", nargs="+", required=True,
                   help="trained model dir(s); several dirs also score their "
                        "cross-modality consensus (mean softmax)")
    s.add_argument("--out", required=True, help="metrics JSON path")
    s.add_argument("--images", nargs="*", default=None,
                   help="fullres slide images (required for image/MM models)")
    s.add_argument("--plots", default=None, metavar="DIR",
                   help="also render ROC/PR curve grid + confusion heatmap PNGs "
                        "into DIR (needs matplotlib)")
    s.add_argument("--maps", default=None, metavar="DIR",
                   help="also render per-array true/predicted label maps and "
                        "misclassification-density heatmaps into DIR (consensus "
                        "maps when several models are given; needs matplotlib)")
    s.add_argument("--f-only", action="store_true",
                   help="evaluate the spot classifier f alone (patch_predictions) "
                        "instead of the corrected grid")
    s.add_argument("--tta", action="store_true",
                   help="dihedral test-time augmentation: average softmax over all "
                        "8 flip/rotation orientations of each patch (image/MM "
                        "models; 8x compute per array)")
    _add_device_arg(s, "evaluation")
    s.set_defaults(fn=_cmd_evaluate)

    s = sub.add_parser(
        "distill",
        help="distill a trained image model's f into the TpuPatchClassifier "
             "student (g carried verbatim), or an scBERT count f into a "
             "CountMLP; agreement is measured and recorded in model.json")
    s.add_argument("--model", required=True,
                   help="teacher: a trained IMAGE model dir (DenseNet-121 or "
                        "TpuPatchClassifier f), or a multimodal dir with an scBERT "
                        "count f")
    s.add_argument("--spaceranger", nargs="+", required=True,
                   help="arrays supplying the distillation pool")
    s.add_argument("--images", nargs="+", default=None,
                   help="fullres slides (image teachers crop their pool from them; "
                        "required for the full-slide agreement report)")
    s.add_argument("--out", required=True, help="student model dir")
    s.add_argument("--steps", type=int, default=2000)
    s.add_argument("--batch-size", type=int, default=256)
    s.add_argument("--lr", type=float, default=3e-4)
    s.add_argument("--temperature", type=float, default=2.0)
    s.add_argument("--kl-weight", type=float, default=0.1)
    s.add_argument("--holdout", type=float, default=0.15,
                   help="pool fraction held out for the agreement report")
    s.add_argument("--max-patches", type=int, default=20000,
                   help="cap on the resident distillation pool (uniformly sampled "
                        "across arrays); 20k 128px f32 patches are ~3.9 GB of device "
                        "memory, count pools (N, 16907) f32 in the gene2vec view")
    s.add_argument("--split-seed", type=int, default=0)
    s.add_argument("--f32", action="store_true",
                   help="float32 student (default: bfloat16 compute, the served "
                        "configuration)")
    s.add_argument("--student-stages", default=None,
                   help="student architecture as width:depth pairs, e.g. '256:2,512:2'")
    s.add_argument("--student-stem", type=int, default=None,
                   help="student patchify-stem size (default 16; use 8 for patches "
                        "under 32px)")
    s.add_argument("--min-agreement", type=float, default=None,
                   help="fail (exit nonzero) if measured agreement is below this bound")
    _add_device_arg(s, "distillation")
    s.set_defaults(fn=_cmd_distill)

    s = sub.add_parser(
        "export",
        help="write a trained model's registration as a torch.export artifact (.pt2, "
             "weights inside, the kernels as gridnext:: custom ops; reload with "
             "serving.load_exported_registration)")
    s.add_argument("--model", required=True, help="trained model directory")
    s.add_argument("--out", required=True, help="output artifact path")
    s.add_argument("--wsi-shape", nargs=2, type=int, default=None, metavar=("H", "W"),
                   help="image models: fullres slide pixel dims the artifact is "
                        "specialized to (shapes are static); count/MM models export "
                        "the grid->labels forward and don't need it")
    s.add_argument("--n-spots", type=int, default=8192,
                   help="fixed spot-axis length; pad real spot arrays with "
                        "SlideRegistrar.spot_inputs (HD bin lattices run ~147k "
                        "in-tissue bins -- raise this, or prefer --dense)")
    s.add_argument("--dense", action="store_true",
                   help="square-HD image models: export the dense-tiling registration "
                        "(register_dense) instead of the per-spot gather; needs "
                        "--spaceranger and an exact integer-pitch lattice")
    s.add_argument("--spaceranger", nargs="*", default=None,
                   help="--dense: representative array dir(s) to fit the bin lattice "
                        "extent from")
    s.add_argument("--platforms", nargs="*", default=None,
                   help="target device types (cuda/gpu or cpu); an artifact runs on "
                        "the device type it is exported on (--device), and naming "
                        "another raises")
    _add_device_arg(s, "the export (and the artifact)")
    s.set_defaults(fn=_cmd_export)

    s = sub.add_parser(
        "serve-artifact",
        help="register slides through an exported artifact (no model code; pair of "
             "`export`)")
    s.add_argument("--artifact", required=True,
                   help="artifact path (its .json sidecar must sit beside it)")
    s.add_argument("--spaceranger", nargs="+", required=True)
    s.add_argument("--images", nargs="+", required=True)
    s.add_argument("--out", required=True)
    _add_device_arg(s, "the artifact")
    s.set_defaults(fn=_cmd_serve_artifact)

    s = sub.add_parser(
        "serve",
        help="resident HTTP registration server: the model loaded once, slides "
             "registered per request (JSON; see server.py)")
    src = s.add_mutually_exclusive_group(required=True)
    src.add_argument("--model", help="trained model directory (image, count, or "
                                     "multimodal)")
    src.add_argument("--artifact",
                     help="exported artifact (+ .json sidecar); serves with no model "
                          "code constructed")
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=8000,
                   help="0 picks a free port (printed at startup)")
    s.add_argument("--mesh", default=None,
                   help="image models: serve over the visible cards ('auto' or axis "
                        "sizes like 'data=4,spot=2'); the flat spot axis splits over "
                        "every mesh axis, labels as on one card")
    s.add_argument("--warmup", nargs="+", default=None, metavar="PATH",
                   help="register one sample before listening: IMAGE SPACERANGER for "
                        "image/MM models, SPACERANGER for count models")
    s.add_argument("--max-batch", type=int, default=8,
                   help="image models: concurrent requests that queue while a dispatch "
                        "runs micro-batch into one register_batch of up to this many "
                        "same-shape slides (1 disables)")
    s.add_argument("--verbose", action="store_true", help="log every HTTP request")
    _add_device_arg(s, "serving")
    s.set_defaults(fn=_cmd_serve)
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
    s.add_argument("--mesh", default=None,
                   help="multi-card mesh: 'auto' (data x spot over the ranks) or axis "
                        "sizes like 'data=4,spot=2', one process a card (torchrun "
                        "--multihost, or --coordinator); replicas start alike, batches "
                        "shard, gradients and BatchNorm statistics reduce over the ranks")
    s.add_argument("--grid-batch-size", type=int, default=1,
                   help="arrays per gridwise training step (must be divisible by the "
                        "mesh's data axis size)")
    s.add_argument("--split-seed", type=int, default=0,
                   help="seed for the random train/val split")
    s.add_argument("--val-arrays", nargs="+", default=None,
                   help="hold out these whole arrays (dir basenames) for "
                        "validation instead of a random split")
    s.add_argument("--resume", action="store_true",
                   help="continue an interrupted run from the '.latest' "
                        "checkpoints in --out (--epochs is the TOTAL count)")
    _add_device_arg(s, "training")


def _add_device_arg(s, what: str):
    s.add_argument("--device", default="cuda",
                   help=f"where {what} runs: 'cuda' (default; fails without a "
                        "card) or 'cpu' (the kernels' plain versions)")


# The commands that may join a process group: the trainers, whose writers are
# gated to the primary process (any other command would have every rank write
# the same paths)
_MULTIHOST_CMDS = ("_cmd_train", "_cmd_pretrain")


def _init_multihost(args) -> None:
    """--multihost / --coordinator: join the process group before the
    command; the command's device becomes this process's card."""
    from gridnext_tpu_torch.parallel.multihost import (initialize_multihost, local_device,
                                                        process_count)

    try:
        if args.coordinator is None:
            idx = initialize_multihost(device=args.device)
        else:
            try:
                coord, num, pid = args.coordinator.rsplit(",", 2)
                num, pid = int(num), int(pid)
            except ValueError:
                sys.exit("error: --coordinator must be "
                         "'host:port,num_processes,process_id'; got "
                         f"{args.coordinator!r}")
            idx = initialize_multihost(coord, num, pid, device=args.device)
    except ValueError as e:
        sys.exit(f"error: {e}")
    args.device = local_device(args.device)
    print(f"multihost: process {idx}/{process_count()}, device {args.device}",
          file=sys.stderr)


def main(argv=None):
    """Run one command; returns what it returns (the multimodal
    ``register``'s stage seconds, ``evaluate``'s metrics, ``distill``'s
    agreement info, else None). A training command that
    SIGTERM preempts exits 75 after its batch-boundary checkpoint.
    ``--multihost`` / ``--coordinator`` (training commands only) join a
    process group for the command and leave it after."""
    args = build_parser().parse_args(argv)
    multihost = args.multihost or args.coordinator is not None
    if multihost and not args.fn.__name__.startswith(_MULTIHOST_CMDS):
        sys.exit(
            "error: --multihost/--coordinator is only supported for "
            "the training subcommands (train-count, train-image, "
            "train-mm, pretrain-scbert), whose writers are gated to "
            "the primary process; run "
            f"'{args.fn.__name__.removeprefix('_cmd_').replace('_', '-')}'"
            " single-controller (it uses every local device via --mesh)")
    if not args.cmd.startswith(("train-", "pretrain-")):
        return _dispatch(args)
    from gridnext_tpu_torch.parallel.multihost import shutdown_multihost
    from gridnext_tpu_torch.serving import resolve_device
    from gridnext_tpu_torch.train.preempt import (TrainingPreempted,
                                                  install_preemption_handler,
                                                  uninstall_preemption_handler)

    args.device = resolve_device(args.device)
    if multihost:
        _init_multihost(args)
    install_preemption_handler()
    try:
        return _dispatch(args)
    except TrainingPreempted as e:
        print(f"preempted: {e}", file=sys.stderr)
        if e.checkpoint is not None:
            print("resume by rerunning with --resume", file=sys.stderr)
        raise SystemExit(75)
    finally:
        uninstall_preemption_handler()
        if multihost:
            shutdown_multihost()


def _dispatch(args):
    """Run the command, under ``--profile-dir`` inside a profiler trace."""
    if not args.profile_dir:
        return args.fn(args)
    from gridnext_tpu_torch.observability import profile_trace

    with profile_trace(args.profile_dir):
        out = args.fn(args)
    print(f"profiler trace written to {args.profile_dir} (a Chrome trace JSON: open it "
          "in chrome://tracing or ui.perfetto.dev)")
    return out


if __name__ == "__main__":
    main()
