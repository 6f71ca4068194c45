"""Trained-model directories: model.json metadata -> a live registrar.

A model directory written by the JAX package's ``train-image`` command
(``model.json`` beside ``g_state.msgpack``) serves here unchanged: read it
with :func:`gridnext_tpu_torch.compat.from_jax.load_model_dir` and build the
registrar with :func:`image_registrar_from_meta`.
"""

from __future__ import annotations

from gridnext_tpu_torch.compat.from_jax import load_gridnet_hex


def image_registrar_from_meta(meta, classes, variables, device="cuda"):
    """SlideRegistrar for a trained image model directory's metadata.

    Ported: the Visium hex lattice with a ``*TpuPatchClassifier`` f. The
    DenseNet-121 f and the square-lattice (``grid_dims``) models raise
    ``NotImplementedError`` until their slices are ported. As in the JAX
    package, model directories serve with ``normalize=None`` (``/255``).
    """
    from gridnext_tpu_torch.models import (GridNetHex, TpuPatchClassifier,
                                           tpu_f_arch_kwargs)
    from gridnext_tpu_torch.serving import SlideRegistrar, resolve_device

    device = resolve_device(device)
    model_name = meta.get("model", "")
    if not model_name.endswith("TpuPatchClassifier"):
        raise NotImplementedError(
            f"model {model_name!r}: only *TpuPatchClassifier image models are "
            "ported so far (DenseNet-121 is a later slice)")
    if meta.get("grid_dims") is not None:
        raise NotImplementedError("square-lattice (grid_dims) image models are "
                                  "a later slice of the port")
    n = len(classes)
    f = TpuPatchClassifier(n_classes=n, **tpu_f_arch_kwargs(meta.get("tpu_f")))
    use_bn = "batch_stats" in variables and "corrector" in variables["batch_stats"]
    g = load_gridnet_hex(GridNetHex(f, n_classes=n, f_dim=n, use_bn=use_bn),
                         variables)
    return SlideRegistrar.from_gridnet(
        g, patch_size=meta.get("patch_px", 128),
        window_size=meta.get("window_px"),
        patch_chunk=meta.get("patch_chunk", 624), normalize=None, device=device)
