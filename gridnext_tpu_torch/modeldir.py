"""Trained-model directories: model.json metadata -> a live model.

A model directory written by the JAX package's ``train-count``,
``train-image`` or ``train-mm`` command (``model.json`` beside
``g_state.msgpack``) serves here unchanged: read it with
:func:`gridnext_tpu_torch.compat.from_jax.load_model_dir`, then build the
image registrar with :func:`image_registrar_from_meta`, the multimodal
model with :func:`mm_model_from_meta` (registered by
:func:`gridnext_tpu_torch.serving.register_mm_grid`, its counts mapped into
scBERT's gene space by :func:`scbert_transform`, or from a cohort's
Spaceranger directories by :func:`scbert_count_transform`), the grid model
of any directory with :func:`grid_model_from_meta`, or the ``HexGCN`` of a
graph directory (``train-graph``) with :func:`graph_model_from_meta`.
:func:`image_f_from_meta` gives an image directory's spot classifier f
alone (the teacher of ``distill``), :func:`submodule_variables` one
submodule's variables out of a composed model's tree.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

from gridnext_tpu_torch.compat.from_jax import load_gridnet


def image_registrar_from_meta(meta, classes, variables, device="cuda", mesh=None):
    """SlideRegistrar for a trained image model directory's metadata.

    A ``*TpuPatchClassifier`` or ``*DenseNet121`` f (f32 modules; the window
    resized to the patch size where ``window_px`` differs) under the hex
    corrector (Visium) or, where ``grid_dims`` is set, the Cartesian
    corrector of a square ``GridNet`` whose grid is ``grid_dims`` (Visium
    HD bins, indexed by (array_row, array_col)). As in the JAX package,
    model directories serve with ``normalize=None`` (``/255``). ``mesh``: a
    serving mesh whose devices split the flat spot axis
    (:class:`~gridnext_tpu_torch.serving.SlideRegistrar`).
    """
    from gridnext_tpu_torch.models import (GridNet, GridNetHex, TpuPatchClassifier,
                                           densenet121, tpu_f_arch_kwargs)
    from gridnext_tpu_torch.serving import SlideRegistrar, resolve_device

    device = resolve_device(device)
    model_name = meta.get("model", "")
    n = len(classes)
    if model_name.endswith("TpuPatchClassifier"):
        f = TpuPatchClassifier(n_classes=n, **tpu_f_arch_kwargs(meta.get("tpu_f")))
    elif model_name.endswith("DenseNet121"):
        f = densenet121(num_classes=n)
    else:
        raise ValueError(f"not an image model dir (model={model_name!r}); the "
                         "registrar needs a GridNet[Hex]+DenseNet121 or "
                         "+TpuPatchClassifier directory")
    grid_dims = meta.get("grid_dims")
    lattice = {}
    if grid_dims is not None:
        lattice = {"h_st": int(grid_dims[0]), "w_st": int(grid_dims[1])}
    cls = GridNetHex if grid_dims is None else GridNet
    g = load_gridnet(cls(f, n_classes=n, f_dim=n, use_bn=_has_bn_corrector(variables)),
                     variables)
    return SlideRegistrar.from_gridnet(
        g, patch_size=meta.get("patch_px", 128), window_size=meta.get("window_px"),
        patch_chunk=meta.get("patch_chunk", 624), normalize=None, device=device,
        mesh=mesh, **lattice)


def submodule_variables(variables, key: str) -> dict:
    """One submodule's variables out of a composed model's tree (JAX
    layout): ``params[key]`` and ``key``'s entry of every other collection
    that has one (``batch_stats``, scBERT's ``favor``), each collection at
    the root of the result."""
    out = {"params": variables["params"][key]}
    for col, sub in variables.items():
        if col != "params" and sub is not None and key in sub:
            out[col] = sub[key]
    return out


def image_f_from_meta(meta, classes, variables, device="cuda"):
    """``(f, f_variables)`` of a trained image model directory: its spot
    classifier (a ``TpuPatchClassifier`` from ``tpu_f``, or DenseNet-121;
    the f32 module) with its weights loaded, in eval mode on ``device``, and
    its variables (``params`` and, with BatchNorm, ``batch_stats``) out of
    the ``patch_classifier`` subtree. Raises ``ValueError`` for any other
    directory."""
    from gridnext_tpu_torch.compat.from_jax import load_variables
    from gridnext_tpu_torch.models import TpuPatchClassifier, densenet121, tpu_f_arch_kwargs
    from gridnext_tpu_torch.serving import resolve_device

    device = resolve_device(device)
    model_name = meta.get("model", "")
    if model_name.endswith("TpuPatchClassifier"):
        f = TpuPatchClassifier(n_classes=len(classes), **tpu_f_arch_kwargs(meta.get("tpu_f")))
    elif model_name.endswith("DenseNet121"):
        f = densenet121(num_classes=len(classes))
    else:
        raise ValueError(
            f"not an image model dir (model={model_name!r}); the f "
            "extractor needs a GridNet[Hex]+DenseNet121 or "
            "+TpuPatchClassifier directory")
    f_vars = submodule_variables(variables, "patch_classifier")
    return load_variables(f, f_vars).to(device).eval(), f_vars


def _has_bn_corrector(variables) -> bool:
    return "batch_stats" in variables and "corrector" in variables["batch_stats"]


def mm_model_from_meta(meta, classes, variables, device="cuda"):
    """The multimodal grid model of a trained model directory, with its
    weights loaded, in eval mode on ``device``: a ``GridNetHexMM`` on the
    Visium hex lattice or a ``GridNetMM`` (``model: "GridNetMM"``, with
    ``grid_dims``) on a square HD lattice.

    The count f is scBERT (generalized ReLU attention, as ``train-mm``
    builds it) or a ``CountMLP`` (``count_mlp_bn: false`` marks the
    distilled student without BatchNorm); the image f a
    ``TpuPatchClassifier`` (``image_f: "tpu"``) or DenseNet-121, chunked as
    in training (``patch_chunk``, ``count_chunk``).
    """
    from gridnext_tpu_torch.models import (GridNetHexMM, GridNetMM, TpuPatchClassifier,
                                           densenet121, scBERT, tpu_f_arch_kwargs)
    from gridnext_tpu_torch.serving import resolve_device

    device = resolve_device(device)
    n = len(classes)
    if meta.get("count_f") == "scbert":
        f_count = scBERT(n_genes=meta["scbert_vocab"], dim=meta["scbert_dim"],
                         depth=meta["scbert_depth"], heads=meta["scbert_heads"],
                         dim_head=meta.get("scbert_dim_head", 64),
                         nb_features=meta.get("scbert_features"), n_classes=n,
                         generalized_attention=True)
    else:
        f_count = _count_mlp(variables, "count_classifier", n,
                             meta.get("count_mlp_bn", True))
    if meta.get("image_f") == "tpu":
        f_image = TpuPatchClassifier(n_classes=n, **tpu_f_arch_kwargs(meta.get("tpu_f")))
    else:
        f_image = densenet121(num_classes=n)
    cls = GridNetMM if meta.get("model") == "GridNetMM" else GridNetHexMM
    g = cls(f_image, f_count, n_classes=n, use_bn=_has_bn_corrector(variables),
            patch_chunk=meta.get("patch_chunk", 624), count_chunk=meta.get("count_chunk"))
    return load_gridnet(g, variables).to(device).eval()


def _count_mlp(variables, name: str, n_classes: int, batch_norm: bool = True):
    """A ``CountMLP`` whose input width is that of the checkpoint's first
    layer (flax infers it from the data; torch needs it up front)."""
    from gridnext_tpu_torch.models import CountMLP

    n_genes = np.shape(variables["params"][name]["Dense_0"]["kernel"])[0]
    return CountMLP(n_genes, n_classes, batch_norm=batch_norm)


def grid_model_from_meta(meta, classes, variables, device="cuda"):
    """The grid model of any trained model directory (count, image or
    multimodal), with its weights loaded, in eval mode on ``device``:
    ``GridNetHex`` (Visium) or ``GridNet`` (``grid_dims``: square HD bins)
    over a ``TpuPatchClassifier``, DenseNet-121 or ``CountMLP`` f, or a
    multimodal model through :func:`mm_model_from_meta`.
    """
    from gridnext_tpu_torch.models import (GridNet, GridNetHex, TpuPatchClassifier,
                                           densenet121, tpu_f_arch_kwargs)
    from gridnext_tpu_torch.serving import resolve_device

    model_name = meta.get("model", "")
    if model_name in ("GridNetHexMM", "GridNetMM"):
        return mm_model_from_meta(meta, classes, variables, device=device)
    device = resolve_device(device)
    n = len(classes)
    chunk = meta.get("patch_chunk", 624)
    if model_name.endswith("TpuPatchClassifier"):
        f = TpuPatchClassifier(n_classes=n, **tpu_f_arch_kwargs(meta.get("tpu_f")))
    elif model_name.endswith("DenseNet121"):
        f = densenet121(num_classes=n)
    else:
        f = _count_mlp(variables, "patch_classifier", n, meta.get("count_mlp_bn", True))
        chunk = None
    cls = GridNetHex if meta.get("grid_dims") is None else GridNet
    g = cls(f, n_classes=n, f_dim=n, use_bn=_has_bn_corrector(variables),
            patch_chunk=chunk)
    return load_gridnet(g, variables).to(device).eval()


def scbert_transform(symbols: Sequence[str], vocab: int) -> Callable:
    """Count preprocessing into scBERT's gene space.

    ``symbols`` name the cohort's genes (the count grids' last axis);
    ``vocab`` is the model's ``scbert_vocab`` (the first ``vocab`` gene2vec
    names). The returned transform maps any ``(..., n_cohort_genes)`` raw
    count array to ``(..., vocab)`` float32: reindexed into gene2vec order,
    depth-normalized to 1e4 and ``log2(1 + x)``. Raises ``ValueError`` when
    no cohort gene is in the vocabulary.
    """
    from gridnext_tpu_torch.models.scbert import load_gene2vec_names, preprocess_scbert

    symbols = [str(s) for s in symbols]
    target = load_gene2vec_names()[:vocab]
    if not set(symbols) & set(target):
        raise ValueError("no cohort gene symbols found in the gene2vec vocabulary: "
                         "scBERT inputs would be all zeros")

    def transform(x):
        x = np.asarray(x, np.float32)
        out, _ = preprocess_scbert(x.reshape(-1, x.shape[-1]), symbols,
                                   target_genes=target)
        return out.reshape(x.shape[:-1] + (len(target),))

    return transform


def scbert_count_transform(spaceranger_dirs, hd_binning, vocab: int):
    """:func:`scbert_transform` for a cohort's unified count caches:
    ``(transform, n_tokens)``.

    The caches index genes by feature ID; gene2vec uses symbols, so the
    genes of the first cache are mapped to symbols through the first
    array's ``features.tsv.gz`` (IDs without a symbol, or every ID when the
    features file cannot be read, stay as they are). Raises ``ValueError``
    with the JAX package's message when no cohort gene maps into the
    vocabulary.
    """
    import csv

    from gridnext_tpu_torch.io.spaceranger import read_feature_names
    from gridnext_tpu_torch.io.unify import read_unified_genes, unified_cache_path
    from gridnext_tpu_torch.models.scbert import load_gene2vec_names

    # the first cache only: register validated every cache's gene axis
    genes = read_unified_genes(unified_cache_path(spaceranger_dirs[0], hd_binning))
    try:
        names = read_feature_names(spaceranger_dirs[0], hd_binning=hd_binning)
        symbols = [str(names.get(g, g)) for g in genes]
    except (OSError, EOFError, ValueError, IndexError, csv.Error):
        symbols = [str(g) for g in genes]
    target = load_gene2vec_names()[:vocab]
    overlap = len(set(symbols) & set(target))
    if overlap == 0:
        raise ValueError(
            "no cohort gene symbols found in the gene2vec vocabulary -- "
            "scBERT inputs would be all zeros (check features.tsv.gz "
            "symbols / --scbert-vocab)")
    print(f"scBERT input space: {len(target)} gene2vec tokens, "
          f"{overlap}/{len(symbols)} cohort genes mapped")
    return scbert_transform(symbols, vocab), len(target)


def graph_model_from_meta(meta, classes, variables, device="cuda"):
    """The ``HexGCN`` node classifier of a graph model directory
    (``train-graph``: ``hidden`` and ``depth`` in ``model.json``), its
    input width that of the checkpoint's first layer, with its weights
    loaded, in eval mode on ``device``."""
    from gridnext_tpu_torch.compat.from_jax import load_hexgcn
    from gridnext_tpu_torch.models import HexGCN
    from gridnext_tpu_torch.serving import resolve_device

    device = resolve_device(device)
    n_genes = np.shape(variables["params"]["Dense_0"]["kernel"])[0]
    model = HexGCN(n_genes, len(classes), hidden=int(meta.get("hidden", 128)),
                   depth=int(meta.get("depth", 3)))
    return load_hexgcn(model, variables).to(device).eval()


def validate_graph_feature_axis(meta, spaceranger_dir):
    """Refuse an array whose MEX gene axis differs from the one the graph
    model trained on (``meta["feature_axis"]``), with the JAX package's
    ``ValueError``."""
    from gridnext_tpu_torch.data.graph_data import feature_axis_signature

    want = meta.get("feature_axis")
    if not want:
        return
    got = feature_axis_signature(spaceranger_dir)
    if got != want:
        raise ValueError(
            f"{spaceranger_dir}: feature axis {got} does not match the "
            f"model's training axis {want}; graph node features need the "
            "exact transcriptome ordering the model trained on")
