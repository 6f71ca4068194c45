"""The port's serving loop (``register_slides``, ``dispatch_group``) against
the JAX package's, on the CPU.

A mixed-shape cohort in the order A, A, B, A, A, B (A: two simulated
slides; B: the same slides cut to fewer rows) registers with
``slide_batch`` 2 and 4 through both packages. At 4 the fourth slide hits
the cap and three A slides register together, then B's pair and a single A
(groups of 3, 2 and 1). The port must yield the same indices in the same
order as JAX's, with labels equal up to near-ties (judged with JAX's
logits), the same ``stats['batched']`` (JAX's ``dispatch_group`` wrapped to
count), foreground equal to the tissue, and never more than
``slide_batch`` slides held. JAX's registrar runs its XLA gather and its
Pallas corrector interpreted, the port's on ``device="cpu"``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import gridnext_tpu.serving as jax_serving
from gridnext_tpu.data import simulate_spaceranger_dir
from gridnext_tpu.io import read_positions as jax_read_positions
from gridnext_tpu.models import GridNetHex as JaxGridNetHex
from gridnext_tpu.models import TpuPatchClassifier as JaxTpuF
from gridnext_tpu_torch import serving
from gridnext_tpu_torch.compat.from_jax import load_gridnet
from gridnext_tpu_torch.ingest import SlideSource
from gridnext_tpu_torch.io import read_positions
from gridnext_tpu_torch.models import GridNetHex, TpuPatchClassifier

N_CLASSES, PATCH = 3, 16
F_KW = dict(stages=((32, 1),), stem_patch=8)
B_ROWS = 600


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_register_slides")
    sims = [simulate_spaceranger_dir(root / f"a{i}", seed=i, n_genes=4,
                                     n_classes=N_CLASSES, image=True,
                                     tissue_fraction=frac, spot_spacing_px=10)
            for i, frac in enumerate((0.5, 0.35))]
    a = [np.asarray(Image.open(s["image_file"])) for s in sims]
    assert a[0].shape == a[1].shape and a[0].shape[0] > B_ROWS
    files = []
    for k, arr in enumerate([a[0], a[1], a[0][:B_ROWS], a[0], a[1], a[1][:B_ROWS]]):
        p = root / f"slide{k}.png"           # lossless: both packages read the same
        Image.fromarray(np.ascontiguousarray(arr)).save(p)
        files.append(str(p))
    dirs = [sims[k]["spaceranger_dir"] for k in (0, 1, 0, 0, 1, 1)]
    masks = [sims[k]["label_grid"] > 0 for k in (0, 1, 0, 0, 1, 1)]
    return files, dirs, masks


@pytest.fixture(scope="module")
def registrars():
    jg = JaxGridNetHex(patch_classifier=JaxTpuF(n_classes=N_CLASSES, **F_KW),
                       n_classes=N_CLASSES)
    variables = jax.tree_util.tree_map(np.asarray, jg.init(
        jax.random.key(0), jnp.zeros((1, 2, 2, PATCH, PATCH, 3), jnp.float32)))
    rng = np.random.default_rng(0)
    for bn in variables["batch_stats"]["corrector"].values():
        bn["mean"] = rng.normal(size=bn["mean"].shape).astype(np.float32) * 0.1
        bn["var"] = rng.uniform(0.5, 1.5, bn["var"].shape).astype(np.float32)
    jax_reg = jax_serving.SlideRegistrar.from_gridnet(
        jg, variables, patch_size=PATCH, normalize=None, patch_chunk=512, extractor="xla")
    g = load_gridnet(GridNetHex(TpuPatchClassifier(n_classes=N_CLASSES, **F_KW),
                                    n_classes=N_CLASSES, f_dim=N_CLASSES), variables)
    port_reg = serving.SlideRegistrar.from_gridnet(g, patch_size=PATCH, normalize=None,
                                                   patch_chunk=512, device="cpu")
    return jax_reg, port_reg


@pytest.fixture(scope="module")
def jax_logits(cohort, registrars):
    files, dirs, _ = cohort
    jax_reg, _ = registrars
    return [jax_reg.register_logits(jnp.asarray(np.asarray(Image.open(f))),
                                    jax_read_positions(d))[0]
            for f, d in zip(files, dirs)]


class CountingSource:
    """Counts the slides handed to the consumer (the slides held)."""

    def __init__(self, src):
        self.src, self.timer, self.consumed = src, src.timer, 0

    def __iter__(self):
        for item in self.src:
            self.consumed += 1
            yield item


@pytest.mark.parametrize("slide_batch,order,batched,dispatches",
                         [(4, [0, 1, 3, 2, 5, 4], 5, 3), (2, [0, 1, 2, 3, 4, 5], 4, 4)])
def test_register_slides_matches_jax(cohort, registrars, jax_logits, monkeypatch,
                                     slide_batch, order, batched, dispatches):
    files, dirs, masks = cohort
    jax_reg, port_reg = registrars
    jax_stats = {}
    jax_dispatch = jax_serving.dispatch_group
    monkeypatch.setattr(jax_serving, "dispatch_group",
                        lambda reg, group, **kw: jax_dispatch(reg, group, stats=jax_stats, **kw))
    want = list(jax_serving.register_slides(jax_reg, files, dirs, slide_batch=slide_batch))

    stats = {}
    source = CountingSource(SlideSource(files, dirs, prefetch=slide_batch + 1, device="cpu"))
    got, max_held = [], 0
    for item in serving.register_slides(port_reg, files, dirs, slide_batch=slide_batch,
                                        source=source, stats=stats):
        got.append(item)
        max_held = max(max_held, source.consumed - len(got))
    assert [i for i, _, _ in got] == [i for i, _, _ in want] == order
    assert stats == jax_stats == {"batched": batched}
    assert max_held < slide_batch
    for (i, labels, pos), (_, jlabels, _) in zip(got, want):
        assert labels.shape == (78, 64) and pos.barcodes == read_positions(dirs[i]).barcodes
        serving.label_parity_report(np.asarray(jlabels), labels, jax_logits[i])
        np.testing.assert_array_equal(labels > 0, masks[i])
    timer = source.timer.summary()
    assert source.timer.counts["register"] == dispatches
    assert timer["decode"] > 0 and timer["register"] > 0


def test_dispatch_group_matches_jax(cohort, registrars, jax_logits):
    files, dirs, _ = cohort
    jax_reg, port_reg = registrars
    arrays = [np.array(Image.open(f)) for f in files]
    for keys in ([0, 1, 3], [2]):
        jstats, stats = {}, {}
        want = jax_serving.dispatch_group(
            jax_reg, [(k, jnp.asarray(arrays[k]), jax_read_positions(dirs[k])) for k in keys],
            stats=jstats)
        got = serving.dispatch_group(
            port_reg, [(k, torch.from_numpy(arrays[k]), read_positions(dirs[k])) for k in keys],
            stats=stats)
        assert [k for k, _, _ in got] == [k for k, _, _ in want] == keys
        assert stats == jstats
        for (k, labels, _), (_, jlabels, _) in zip(got, want):
            serving.label_parity_report(np.asarray(jlabels), labels, jax_logits[k])
