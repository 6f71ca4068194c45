"""The port's observability (``profile_trace``, ``annotate``,
``MetricsLogger``, ``read_metrics``) and the global ``--profile-dir`` flag,
against the JAX package's ``observability`` on the CPU.

The JAX package writes an xplane for TensorBoard; the port writes a Chrome
trace JSON (``ROADMAP.md`` Queue 3), so the traces are checked for their
own content: an ``annotate`` region's name, and a traced ``register``
command's operators.
"""

import json

import numpy as np
import torch

from gridnext_tpu.observability import MetricsLogger as JaxMetricsLogger
from gridnext_tpu.observability import read_metrics as jax_read_metrics
from gridnext_tpu_torch import cli
from gridnext_tpu_torch.observability import (MetricsLogger, StageTimer, annotate,
                                              profile_trace, read_metrics)


def _trace_events(logdir):
    files = sorted(logdir.glob("*.json"))
    assert len(files) == 1, files
    return json.loads(files[0].read_text())["traceEvents"]


def test_profile_trace_holds_the_annotation(tmp_path):
    with profile_trace(str(tmp_path / "trace")):
        with annotate("stage"):
            torch.ones((8, 8)).sum()
    names = {e.get("name") for e in _trace_events(tmp_path / "trace")}
    assert "stage" in names and any(str(n).startswith("aten::") for n in names)


def test_metrics_logger_round_trips_as_jax(tmp_path):
    records = [dict(step=1, loss=0.5, acc=np.float32(0.25), flag=True, code="007",
                    per_class=np.array([0.9, 0.8]), nested={"a": [1, 2]}, none=None),
               dict(step=np.int64(2), phase="val", t=torch.tensor(1.5), grid=np.eye(2),
                    word=np.str_("x"))]
    for cls, path in ((MetricsLogger, tmp_path / "port.jsonl"),
                      (JaxMetricsLogger, tmp_path / "jax.jsonl")):
        with cls(path) as ml:
            for rec in records:
                ml.log(**rec)
    ours, theirs = read_metrics(tmp_path / "port.jsonl"), jax_read_metrics(tmp_path / "jax.jsonl")
    for rec in ours + theirs:
        assert rec.pop("wall_s") >= 0
    assert ours == theirs
    assert ours[0]["flag"] is True and ours[0]["code"] == "007"
    assert ours[0]["per_class"] == [0.9, 0.8] and ours[1]["grid"] == [[1.0, 0.0], [0.0, 1.0]]
    timer = StageTimer()
    with timer("a"):
        pass
    assert set(timer.summary()) == {"a"}


def test_profile_dir_traces_a_register_command(tmp_path, capsys):
    from gridnext_tpu_torch.compat.from_jax import jax_variables, save_model_dir
    from gridnext_tpu_torch.io.unify import read_unified_genes
    from gridnext_tpu_torch.models import CountMLP, GridNetHex
    from gridnext_tpu_torch.train.init import flax_init_

    cli.main(["simulate", "--out", str(tmp_path / "sim"), "--arrays", "1", "--genes", "12",
              "--classes", "3", "--seed", "3"])
    srd = str(tmp_path / "sim" / "a0")
    cli.main(["prepare", "--spaceranger", srd])
    genes = read_unified_genes(str(tmp_path / "sim" / "a0" / "a0.unified.tsv.gz"))
    g = flax_init_(GridNetHex(CountMLP(len(genes), 3), 3, 3), torch.Generator().manual_seed(0))
    save_model_dir(str(tmp_path / "m"), {"classes": ["A", "B", "C"], "n_genes": len(genes),
                                         "genes": genes, "log1p": True, "hd_binning": None,
                                         "grid_dims": None, "model": "GridNetHex+CountMLP"},
                   jax_variables(g))
    capsys.readouterr()
    cli.main(["--profile-dir", str(tmp_path / "tr"), "register", "--device", "cpu", "--model",
              str(tmp_path / "m"), "--spaceranger", srd, "--out", str(tmp_path / "l.csv")])
    out = capsys.readouterr().out
    assert f"profiler trace written to {tmp_path / 'tr'}" in out
    assert (tmp_path / "l.csv").read_text().startswith("Barcode,AARs")
    names = {str(e.get("name")) for e in _trace_events(tmp_path / "tr")}
    assert any(n.startswith("aten::") for n in names)
