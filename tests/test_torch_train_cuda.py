"""The port's training on a card against the same training on the CPU.

Every test here is marked ``cuda`` and skips without a CUDA device. The
file imports neither JAX nor the JAX package, so it runs on a machine with
only the port's dependencies::

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_train_cuda.py

Covered: FAVOR's autograd wiring through the kernel (the backward is the
plain version's VJP at the saved inputs: q, k, v gradients within 1e-3
relative of the plain version's; the forward counted once per call),
a ``SlideSpotDataset`` batch cropped in one gather launch with the CPU's
bytes (``/ 255`` within one float32 ulp), and two epochs of ``train_gridwise`` on a GridNetHex +
CountMLP from the same weights on the card and on the CPU (histories
within 1e-4 relative; the weights outside the zero-gradient biases within
1e-4, those within 2 lr a step).
"""

import numpy as np
import pytest
import torch

from gridnext_tpu_torch.compat.from_jax import jax_variables, load_variables
from gridnext_tpu_torch.models import CountMLP, GridNetHex
from gridnext_tpu_torch.ops import favor_cuda
from gridnext_tpu_torch.ops import patch_gather_cuda as gather
from gridnext_tpu_torch.ops.favor import orthogonal_gaussian_matrix
from gridnext_tpu_torch.train import loops as tl
from gridnext_tpu_torch.train.init import flax_init_

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    """The card; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def test_favor_kernel_gradients_match_plain(dev):
    rng = np.random.default_rng(0)
    q, k, v = (torch.as_tensor(rng.normal(size=(2, 3, 500, 64)).astype(np.float32),
                               device=dev).requires_grad_() for _ in range(3))
    proj = orthogonal_gaussian_matrix(266, 64, generator=torch.Generator().manual_seed(1))
    proj = proj.to(dev)
    grad_out = torch.as_tensor(rng.normal(size=(2, 3, 500, 64)).astype(np.float32), device=dev)
    before = favor_cuda.launches
    got = torch.autograd.grad(favor_cuda.fused_generalized_linear_attention(q, k, v, proj),
                              (q, k, v), grad_out)
    assert favor_cuda.launches == before + 1
    want = torch.autograd.grad(favor_cuda.favor_attention_plain(q, k, v, proj), (q, k, v),
                               grad_out)
    for g, w in zip(got, want):
        assert float((g - w).norm() / w.norm()) <= 1e-3


def _grid_model():
    return GridNetHex(CountMLP(10, 3, hidden=(12, 8, 8, 6)), n_classes=3, f_dim=3)


def test_train_gridwise_on_the_card_matches_the_cpu(dev):
    rng = np.random.default_rng(9)
    x = rng.normal(1.0, 2.0, size=(7, 6, 5, 10)).astype(np.float32)
    y = 1 + (x[..., 0] > 1).astype(np.int64) + (x[..., 1] > 2).astype(np.int64)
    y[:, :, 0] = 0
    data = {"train": (x[:5], y[:5]), "val": (x[5:], y[5:])}
    variables = jax_variables(flax_init_(_grid_model(), torch.Generator().manual_seed(0)))
    runs = {}
    for where in (dev, torch.device("cpu")):
        model = _grid_model()
        state = tl.create_train_state(model, tl.make_gridwise_optimizer(1e-3, f_lr=5e-4),
                                      device=where, init=False)
        load_variables(model, variables)
        _, vh, th = tl.train_gridwise(model, data, state=state, num_epochs=2, batch_size=2,
                                      verbose=False, device=where)
        runs[where.type] = (vh, th, jax_variables(model))
    (vh_c, th_c, v_c), (vh, th, v) = runs["cuda"], runs["cpu"]
    np.testing.assert_allclose(th_c, th, rtol=1e-4)
    np.testing.assert_allclose(vh_c, vh, rtol=0, atol=2e-3 * 6)
    sign_limit = ("Dense_0", "Dense_1", "Dense_2", "Dense_3", "HexConv_1", "HexConv_3")

    def walk(a, b, path=()):
        if isinstance(a, dict):
            for key in a:
                walk(a[key], b[key], path + (key,))
            return
        limited = path[-1] == "bias" and path[-2] in sign_limit or path[-1] == "mean"
        np.testing.assert_allclose(a, b, rtol=0 if limited else 1e-3,
                                   atol=2e-3 * 6 if limited else 1e-4,
                                   err_msg="/".join(path))

    walk(v_c, v)


def test_slide_spot_batch_is_one_gather(dev, tmp_path, monkeypatch):
    from gridnext_tpu_torch import ingest
    from gridnext_tpu_torch.data import SlideSpotDataset

    monkeypatch.setattr(ingest, "decode_slide", np.load)

    rng = np.random.default_rng(3)
    srd = tmp_path / "a0"
    (srd / "outs" / "spatial").mkdir(parents=True)
    rows = [f"B{i:03d}-1,1,{r},{c},{40 + 20 * r},{40 + 20 * (c // 2)}"
            for i, (r, c) in enumerate((r, c) for r in range(8) for c in range(r % 2, 16, 2))]
    (srd / "outs" / "spatial" / "tissue_positions.csv").write_text(
        "barcode,in_tissue,array_row,array_col,pxl_row_in_fullres,pxl_col_in_fullres\n"
        + "\n".join(rows) + "\n")
    slide = rng.integers(0, 256, (240, 240, 3), dtype=np.uint8)
    np.save(tmp_path / "s.npy", slide)
    on_card = SlideSpotDataset([tmp_path / "s.npy"], [srd], patch_size=32, device=dev)
    on_cpu = SlideSpotDataset([tmp_path / "s.npy"], [srd], patch_size=32, device="cpu")
    idx = rng.permutation(len(on_card))[:20]
    before = gather.launches
    x, _ = on_card.batch(idx)
    assert gather.launches == before + 1
    want = on_cpu.batch(idx)[0]
    # the same bytes; ``/ 255`` on the card may round the last bit otherwise
    torch.testing.assert_close((x.cpu() * 255).round(), (want * 255).round(), rtol=0, atol=0)
    torch.testing.assert_close(x.cpu(), want, rtol=0, atol=1.2e-7)
