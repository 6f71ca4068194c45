"""The port's cohort workflows, ``config.py`` and ``remove_color_cast``
against the JAX package's, on numpy-seeded inputs.

- ``config``: every dataclass saved by either package is byte-equal JSON,
  and each package loads the other's files (tuples restored);
- ``remove_color_cast``: bit-equal, and the same ``ValueError``;
- HVG: masks equal, per-gene statistics within 1e-12 relative (NaNs where
  JAX has them), over arrays and over count caches;
- PCA: ``fit_pca`` (float32, ``torch.linalg``) against JAX's (scikit-learn
  ``PCA`` on float32): the leading components up to ``n_pcs`` within
  |cos| >= 1 - 1e-4 with the same signs, ``explained_variance_ratio_``
  within 1e-5, ``n_pcs`` equal; ``pca_transform`` within 1e-4;
  ``preprocess_cohorts``' scaler and scaled tables within 1e-10; the
  ``.npz`` record read back; the gene-axis refusal where JAX's raises;
- CV: ``grouped_partitions`` / ``partition_masks`` / ``CVResult.summary``
  and their errors equal to JAX's, and ``cross_validate`` over the port's
  ``train_spotwise``.
"""

import dataclasses
import faulthandler

import numpy as np
import pytest
import torch

from gridnext_tpu import config as jax_config
from gridnext_tpu import pipeline as jax_pipeline
from gridnext_tpu.workflows import cv as jax_cv
from gridnext_tpu.workflows import hvg as jax_hvg
from gridnext_tpu.workflows import pca as jax_pca
from gridnext_tpu_torch import config, pipeline, workflows
from gridnext_tpu_torch.io.tsv_codec import write_tsv_matrix
from gridnext_tpu_torch.workflows import CountTable

CONFIGS = ("DataConfig", "SpotTrainConfig", "GridTrainConfig", "GridNetConfig",
           "DenseNetConfig")
EDITS = {"DataConfig": {"use_image": True, "select_genes": ["A", "B"]},
         "SpotTrainConfig": {"learning_rate": 3e-4, "redraw_every": 50},
         "GridTrainConfig": {"f_lr": 1e-5, "accum_iters": 4},
         "GridNetConfig": {"patch_chunk": 624, "f_dim": 9},
         "DenseNetConfig": {"block_config": (2, 3), "drop_rate": 0.1}}


MODULE_TIMEOUT = 300     # seconds the whole module may take


@pytest.fixture(scope="module", autouse=True)
def module_timeout():
    """End this test process, every thread's traceback dumped, if the
    module outlives MODULE_TIMEOUT: a hang then costs the suite this
    module, not its whole time limit."""
    faulthandler.dump_traceback_later(MODULE_TIMEOUT, exit=True)
    yield
    faulthandler.cancel_dump_traceback_later()


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: under the suite's parallel workers torch's
    thread pools contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", CONFIGS)
def test_config_json_byte_equal_and_cross_loaded(name, tmp_path):
    ours, theirs = getattr(config, name), getattr(jax_config, name)
    assert [f.name for f in dataclasses.fields(ours)] == \
        [f.name for f in dataclasses.fields(theirs)]
    for i, kw in enumerate(({}, EDITS[name])):
        a, b = tmp_path / f"port{i}.json", tmp_path / f"jax{i}.json"
        config.save_config(ours(**kw), a)
        jax_config.save_config(theirs(**kw), b)
        assert a.read_bytes() == b.read_bytes()
        got, want = config.load_config(ours, b), jax_config.load_config(theirs, a)
        assert dataclasses.asdict(got) == dataclasses.asdict(want) == \
            dataclasses.asdict(ours(**kw))
        if name == "DenseNetConfig":
            assert isinstance(got.block_config, tuple) and got == ours(**kw)


def test_remove_color_cast_bit_equal():
    rng = np.random.default_rng(0)
    for shape in ((40, 30, 3), (17, 23, 4)):
        img = rng.integers(0, 220, shape, dtype=np.uint8)
        got = pipeline.remove_color_cast(img)
        np.testing.assert_array_equal(got, jax_pipeline.remove_color_cast(img))
        assert got.dtype == np.uint8
        if shape[-1] == 4:
            np.testing.assert_array_equal(got[..., 3], img[..., 3])
    for bad in (np.zeros((8, 8), np.uint8), np.zeros((8, 8, 2), np.uint8)):
        with pytest.raises(ValueError) as ours:
            pipeline.remove_color_cast(bad)
        with pytest.raises(ValueError) as theirs:
            jax_pipeline.remove_color_cast(bad)
        assert str(ours.value) == str(theirs.value)


# -- count caches --------------------------------------------------------------------


def _cohort(tmp_path, n_arrays=3, n_genes=120, seed=0, genes=None):
    """Unified caches of Poisson counts with a low-rank class structure,
    some spots under 100 UMIs and some all-zero genes."""
    rng = np.random.default_rng(seed)
    genes = genes or [f"G{i:03d}" for i in range(n_genes)]
    files = []
    for a in range(n_arrays):
        n_spots = 90 + 10 * a
        cls = rng.integers(0, 3, n_spots)
        base = rng.gamma(1.0, 1.0, (3, len(genes))) * (rng.random(len(genes)) < 0.8)
        rate = base[cls] * rng.uniform(0.5, 3.0, (n_spots, 1))
        counts = rng.poisson(rate).T.astype(np.float64)
        counts[:, :4] = 0                                   # spots under min_counts
        cols = [f"{c}_{r}" for r, c in zip(*np.divmod(np.arange(n_spots), 64))]
        path = tmp_path / f"a{seed}_{a}.unified.tsv.gz"
        write_tsv_matrix(path, genes, cols, counts, force_int=True)
        files.append(path)
    return files


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    return _cohort(tmp_path_factory.mktemp("cohort"))


def test_filtered_norm_logcounts_matches_jax(cohort):
    got = workflows.filtered_norm_logcounts(cohort[1])
    want = jax_pca.filtered_norm_logcounts(cohort[1])
    assert got.genes == list(want.index) and got.barcodes == list(want.columns)
    np.testing.assert_allclose(got.values, want.values, rtol=1e-12, atol=0)
    assert got.values.dtype == np.float64


def _hvg_close(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    for k in ("means", "dispersions", "dispersions_norm"):
        a, b = got[1][k], want[1][k]
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        np.testing.assert_allclose(a[~np.isnan(a)], b[~np.isnan(b)], rtol=1e-12, atol=0)


@pytest.mark.parametrize("n_top,n_bins", [(30, 20), (10, 1), (50, 5)])
def test_highly_variable_genes_matches_jax(n_top, n_bins):
    rng = np.random.default_rng(n_bins)
    X = np.log1p(rng.poisson(rng.gamma(0.5, 2.0, 200), (150, 200)).astype(float))
    X[:, :3] = 0                                          # zero-mean genes: NaN dispersions
    _hvg_close(workflows.highly_variable_genes(X, n_top, n_bins),
               jax_hvg.highly_variable_genes(X, n_top, n_bins))


def test_select_hvgs_from_count_files_matches_jax(cohort, tmp_path):
    assert workflows.select_hvgs_from_count_files(cohort, n_top_genes=40) == \
        jax_hvg.select_hvgs_from_count_files(cohort, n_top_genes=40)
    bad = _cohort(tmp_path, n_arrays=1, seed=1,
                  genes=[f"G{i:03d}" for i in range(120)][::-1])
    for fn in (workflows.select_hvgs_from_count_files, jax_hvg.select_hvgs_from_count_files):
        with pytest.raises(ValueError, match="different gene list/order"):
            fn(cohort[:1] + bad)


# -- PCA ----------------------------------------------------------------------------


def _assert_pca_close(got, want, n_pcs):
    assert got.n_components_ == want.n_components_
    comp = got.components_.double().numpy()
    cos = np.sum(comp[:n_pcs] * want.components_[:n_pcs], axis=1)
    assert cos.min() >= 1 - 1e-4, cos          # same direction and same sign
    np.testing.assert_allclose(got.explained_variance_ratio_.numpy(),
                               want.explained_variance_ratio_, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.mean_.numpy(), want.mean_, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.singular_values_.numpy()[:n_pcs],
                               want.singular_values_[:n_pcs], rtol=1e-4)


@pytest.mark.parametrize("shape", [(300, 40), (60, 90)], ids=["tall", "wide"])
def test_fit_pca_matches_jax(shape, tmp_path):
    rng = np.random.default_rng(shape[0])
    n, g = shape
    k = min(n, g)
    spectrum = 4.0 * 0.8 ** np.arange(k)
    q, _ = np.linalg.qr(rng.normal(size=(g, k)))
    X = rng.normal(size=(n, k)) * spectrum @ q.T + 0.01 * rng.normal(size=(n, g)) + 2.0
    want = jax_pca.fit_pca(X)
    got = workflows.fit_pca(X, device="cpu", outfile=tmp_path / "pca.npz")
    n_pcs = workflows.n_pcs_for_variance(got, 0.9)
    assert n_pcs == jax_pca.n_pcs_for_variance(want, 0.9) > 1
    _assert_pca_close(got, want, n_pcs)
    back = workflows.load_pca(tmp_path / "pca.npz")
    for f in dataclasses.fields(back):
        a, b = getattr(back, f.name), getattr(got, f.name)
        assert torch.equal(a, b) if torch.is_tensor(b) else a == b
    # truncated fits and an unreachable variance target
    part = workflows.fit_pca(torch.as_tensor(X, dtype=torch.float32), n_components=5)
    assert part.components_.shape == (5, g) and part.noise_variance_ > 0
    assert workflows.n_pcs_for_variance(part, 0.999) == jax_pca.n_pcs_for_variance(
        jax_pca.fit_pca(X, n_components=5), 0.999) == 5
    # the projection: one matmul, JAX's within 1e-4
    comp, mean = want.components_.astype(np.float32), want.mean_.astype(np.float32)
    x = X[:7].astype(np.float32)
    np.testing.assert_allclose(workflows.pca_transform(x, comp, mean, 4,
                                                       device="cpu").numpy(),
                               np.asarray(jax_pca.pca_transform(x, comp, mean, 4)),
                               rtol=0, atol=1e-4)
    out = workflows.pca_transform(torch.as_tensor(x), got.components_, got.mean_)
    assert out.shape == (7, k) and out.dtype == torch.float32


def test_fit_pca_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        workflows.fit_pca(np.zeros((4, 3)))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        workflows.pca_transform(np.zeros((4, 3)), np.eye(3), np.zeros(3))


def test_preprocess_cohorts_matches_jax(cohort):
    train, every = cohort[:2], cohort[1:]
    got = workflows.preprocess_cohorts(train, every, variance_fraction=0.5, device="cpu")
    want = jax_pca.preprocess_cohorts(train, every, variance_fraction=0.5)
    for k in ("mean", "std"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-10, atol=1e-12)
    assert sorted(got["scaled"]) == sorted(want["scaled"]) == sorted(map(str, cohort))
    for k, df in want["scaled"].items():
        np.testing.assert_allclose(got["scaled"][k].values, df.values, rtol=1e-10, atol=1e-10)
        assert got["scaled"][k].barcodes == list(df.columns)
    assert got["n_pcs"] == want["n_pcs"]
    _assert_pca_close(got["pca"], want["pca"], got["n_pcs"])
    # the scaler alone, and tables passed in place of files
    np.testing.assert_allclose(workflows.fit_cohort_scaler(train)[0], want["mean"],
                               rtol=1e-10)
    tables = [workflows.filtered_norm_logcounts(c) for c in train]
    scaled = workflows.scale_logcounts(tables[0], want["mean"], want["std"])
    np.testing.assert_allclose(scaled.values, want["scaled"][str(train[0])].values,
                               rtol=1e-10, atol=1e-10)
    raw = [workflows.pca._load_counts(c) for c in train]
    again = workflows.preprocess_cohorts(raw, raw, device="cpu")
    assert sorted(again["scaled"]) == sorted(id(t) for t in raw)
    np.testing.assert_allclose(again["mean"], want["mean"], rtol=1e-10)


def test_gene_axis_refusal_where_jax_raises(cohort, tmp_path):
    genes = [f"G{i:03d}" for i in range(120)]
    bad = _cohort(tmp_path, n_arrays=1, seed=2, genes=genes[::-1])
    for ours, theirs in ((workflows.fit_cohort_scaler, jax_pca.fit_cohort_scaler),):
        with pytest.raises(ValueError) as a:
            ours([cohort[0], bad[0]])
        with pytest.raises(ValueError) as b:
            theirs([cohort[0], bad[0]])
        assert str(a.value) == str(b.value)
        assert "count files do not share a gene axis" in str(a.value)
    with pytest.raises(ValueError) as a:
        workflows.preprocess_cohorts(cohort[:1], [bad[0]], device="cpu")
    with pytest.raises(ValueError) as b:
        jax_pca.preprocess_cohorts(cohort[:1], [bad[0]])
    assert str(a.value) == str(b.value)
    empty = CountTable(np.zeros((3, 2)), ["a", "b", "c"], ["0_0", "1_0"])
    for fn, table in ((workflows.preprocess_cohorts, empty),):
        with pytest.raises(ValueError, match="no training spots survived"):
            fn([table], [table], device="cpu")


# -- cross-validation -------------------------------------------------------------------

GROUPS = ["s1", "s1", "s2", "s3", "s3", "s4", "s5", "s6"]


def test_partitions_and_masks_match_jax():
    for k in (2, 3, 6):
        got, want = workflows.grouped_partitions(GROUPS, k), jax_cv.grouped_partitions(GROUPS, k)
        assert [list(p) for p in got] == [list(p) for p in want]
        for (a, b), (c, d) in zip(workflows.partition_masks(GROUPS, got),
                                  jax_cv.partition_masks(GROUPS, want)):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, d)
    for ours, theirs, args in (
            (workflows.grouped_partitions, jax_cv.grouped_partitions, (GROUPS, 7)),
            (workflows.grouped_partitions, jax_cv.grouped_partitions, (GROUPS, 1))):
        with pytest.raises(ValueError) as a:
            ours(*args)
        with pytest.raises(ValueError) as b:
            theirs(*args)
        assert str(a.value) == str(b.value)
    for parts in ([["zz"]], [sorted(set(GROUPS))]):
        with pytest.raises(ValueError) as a:
            list(workflows.partition_masks(GROUPS, parts))
        with pytest.raises(ValueError) as b:
            list(jax_cv.partition_masks(GROUPS, parts))
        assert str(a.value) == str(b.value)


def test_cross_validate_over_the_port_trainer(capsys):
    """Four folds of a tiny CountMLP through the port's ``train_spotwise``:
    the stacked histories summarise as JAX's ``CVResult`` summarises them,
    and unequal fold lengths raise as JAX's do."""
    from gridnext_tpu_torch.models import CountMLP
    from gridnext_tpu_torch.train import train_spotwise

    torch.manual_seed(0)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(len(GROUPS), 12, 6)).astype(np.float32)
    y = rng.integers(0, 2, (len(GROUPS), 12))

    def fold(tr, va, i):
        dls = {"train": (x[tr].reshape(-1, 6), y[tr].reshape(-1)),
               "val": (x[va].reshape(-1, 6), y[va].reshape(-1))}
        return train_spotwise(CountMLP(6, 2, hidden=(8, 8, 8, 4)), dls, num_epochs=2,
                              batch_size=16, verbose=False, device="cpu",
                              generator=torch.Generator().manual_seed(i))

    res = workflows.cross_validate(fold, GROUPS, n_folds=4)
    assert res.train_hist.shape == res.val_hist.shape == (4, 2)
    assert "Test Partition: s1, s2" in capsys.readouterr().out
    want = jax_cv.CVResult(res.train_hist, res.val_hist, res.states, res.partitions).summary()
    got = res.summary()
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])

    def ragged(tr, va, i):
        return None, [1.0] * (i + 1), [1.0] * (i + 1)

    for cv in (workflows, jax_cv):
        with pytest.raises(ValueError, match="unequal history lengths"):
            cv.cross_validate(ragged, GROUPS, n_folds=2, verbose=False)
