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

    Ported: the Visium hex lattice with a ``*TpuPatchClassifier`` or a
    ``*DenseNet121`` f (f32 modules; the window resized to the patch size
    where ``window_px`` differs). The square-lattice (``grid_dims``) models
    raise ``NotImplementedError`` until their slice is ported. As in the
    JAX package, model directories serve with ``normalize=None`` (``/255``).
    """
    from gridnext_tpu_torch.models import (GridNetHex, TpuPatchClassifier,
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
                         "registrar needs a GridNetHex+DenseNet121 or "
                         "+TpuPatchClassifier directory")
    if meta.get("grid_dims") is not None:
        raise NotImplementedError("square-lattice (grid_dims) image models are "
                                  "a later slice of the port")
    use_bn = "batch_stats" in variables and "corrector" in variables["batch_stats"]
    g = load_gridnet_hex(GridNetHex(f, n_classes=n, f_dim=n, use_bn=use_bn),
                         variables)
    return SlideRegistrar.from_gridnet(
        g, patch_size=meta.get("patch_px", 128),
        window_size=meta.get("window_px"),
        patch_chunk=meta.get("patch_chunk", 624), normalize=None, device=device)
