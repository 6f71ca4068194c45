"""The reference's PyTorch checkpoints into the port
(``compat/torch_convert.py``), and the small public leftovers
(``geometry.hex_neighbor_table``, ``io.positions_to_coord_strings``),
against the JAX package on the CPU.

Each converter reads a synthetic state dict under the reference's names
(random weights from a numpy seed, BatchNorm statistics included) and is
held against the JAX package's converter followed by ``compat/from_jax``:
the trees equal leaf for leaf, and the port's module loaded either way
gives logits within 1e-5 (the same bits here). The hexagdly kernel maps
(radius 1 and 2) equal JAX's exactly, and a ``.pth`` written by
``torch.save`` loads through ``read_torch_checkpoint`` (no pickled code)
into the same logits.
"""

import numpy as np
import pytest
import torch

from gridnext_tpu.compat import torch_convert as jax_convert
from gridnext_tpu_torch.compat import torch_convert
from gridnext_tpu_torch.compat.from_jax import jax_variables, load_variables
from gridnext_tpu_torch.models import CountMLP, DenseNet, GridNet, GridNetHex, GridNetHexMM

SMALL = dict(growth_rate=4, block_config=(2, 2), num_init_features=8, num_classes=3)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", np.asarray(v)


def _same_tree(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def _bn(rng, sd, prefix, width):
    sd[f"{prefix}.weight"] = rng.normal(1.0, 0.1, width).astype(np.float32)
    sd[f"{prefix}.bias"] = rng.normal(0.0, 0.1, width).astype(np.float32)
    sd[f"{prefix}.running_mean"] = rng.normal(0.0, 0.1, width).astype(np.float32)
    sd[f"{prefix}.running_var"] = rng.uniform(0.5, 2.0, width).astype(np.float32)


def _densenet_sd(rng, small_inputs):
    """The reference DenseNet's names (densenet.py:100-138) at SMALL's widths."""
    f = DenseNet(**SMALL, small_inputs=small_inputs)
    sd = {"features.conv0.weight": rng.normal(0, 0.2, f.conv0.weight.shape)}
    if not small_inputs:
        _bn(rng, sd, "features.norm0", f.norm0.weight.shape[0])
    for bi, block in enumerate(f.blocks, start=1):
        for li, layer in enumerate(block, start=1):
            pre = f"features.denseblock{bi}.denselayer{li}"
            _bn(rng, sd, f"{pre}.norm1", layer.norm1.weight.shape[0])
            _bn(rng, sd, f"{pre}.norm2", layer.norm2.weight.shape[0])
            sd[f"{pre}.conv1.weight"] = rng.normal(0, 0.2, layer.conv1.weight.shape)
            sd[f"{pre}.conv2.weight"] = rng.normal(0, 0.2, layer.conv2.weight.shape)
        if bi <= len(f.transitions):
            t = f.transitions[bi - 1]
            _bn(rng, sd, f"features.transition{bi}.norm", t.norm.weight.shape[0])
            sd[f"features.transition{bi}.conv.weight"] = rng.normal(0, 0.2, t.conv.weight.shape)
    _bn(rng, sd, "features.norm_final", f.norm_final.weight.shape[0])
    sd["classifier.weight"] = rng.normal(0, 0.2, f.classifier.weight.shape)
    sd["classifier.bias"] = rng.normal(0, 0.2, f.classifier.bias.shape)
    return {k: torch.as_tensor(np.asarray(v, np.float32)) for k, v in sd.items()}


def _count_mlp_sd(rng, n_genes, n_classes):
    """The tutorial's count MLP ``nn.Sequential`` (Linear 0, 1, BN 2, Linear
    4, 5, BN 6, Linear 8)."""
    seq = torch.nn.Sequential(
        torch.nn.Linear(n_genes, 500), torch.nn.Linear(500, 100), torch.nn.BatchNorm1d(100),
        torch.nn.ReLU(), torch.nn.Linear(100, 100), torch.nn.Linear(100, 50),
        torch.nn.BatchNorm1d(50), torch.nn.ReLU(), torch.nn.Linear(50, n_classes))
    sd = {k: torch.as_tensor(rng.normal(0, 0.1, v.shape).astype(np.float32))
          for k, v in seq.state_dict().items() if "num_batches" not in k}
    for i, w in ((2, 100), (6, 50)):
        sd[f"{i}.running_var"] = torch.as_tensor(rng.uniform(0.5, 2.0, w).astype(np.float32))
    return sd


def _hex_corrector_sd(rng, f_dim, n_classes, width=32):
    """The reference GridNetHex corrector's names: hexagdly convs 0, 1, 4,
    5, 8 (kernel0 (out, in, 3, 1), kernel1 (out, in, 2, 2), bias), BN 2, 6."""
    sd = {}
    dims = [(f_dim, width), (width, width), (width, width), (width, width), (width, n_classes)]
    for mi, (ci, co) in zip((0, 1, 4, 5, 8), dims):
        sd[f"corrector.{mi}.kernel0"] = rng.normal(0, 0.2, (co, ci, 3, 1))
        sd[f"corrector.{mi}.kernel1"] = rng.normal(0, 0.2, (co, ci, 2, 2))
        sd[f"corrector.{mi}.bias"] = rng.normal(0, 0.2, co)
    for mi in (2, 6):
        _bn(rng, sd, f"corrector.{mi}", width)
    return {k: torch.as_tensor(np.asarray(v, np.float32)) for k, v in sd.items()}


def _cartesian_corrector_sd(rng, model):
    """The reference Cartesian corrector's names (Conv 0, 3, 6, 9, BN 1, 4,
    7), at the shapes of ``model``'s corrector."""
    tree = jax_variables(model)["params"]["corrector"]
    sd = {}
    for i, mi in enumerate((0, 3, 6, 9)):
        k = tree[f"Conv_{i}"]["kernel"]
        sd[f"corrector.{mi}.weight"] = rng.normal(0, 0.1, k.transpose(3, 2, 0, 1).shape)
        sd[f"corrector.{mi}.bias"] = rng.normal(0, 0.1, k.shape[-1])
    for j, mi in enumerate((1, 4, 7)):
        _bn(rng, sd, f"corrector.{mi}", tree[f"BatchNorm_{j}"]["scale"].shape[0])
    return {k: torch.as_tensor(np.asarray(v, np.float32)) for k, v in sd.items()}


def _logits_both_ways(make, ours, theirs, x):
    """The port's module loaded from ``ours`` and from ``theirs`` (JAX's
    converter's tree through ``from_jax``): their logits, held within 1e-5."""
    _same_tree(ours, theirs)
    with torch.no_grad():
        a = load_variables(make(), ours).eval()(x)
        b = load_variables(make(), theirs).eval()(x)
    torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
    return a


@pytest.mark.parametrize("small_inputs", [True, False], ids=["small_inputs", "stem"])
def test_densenet_from_torch(small_inputs):
    rng = np.random.default_rng(0)
    sd = _densenet_sd(rng, small_inputs)
    bc = SMALL["block_config"]
    x = torch.as_tensor(rng.uniform(0, 1, (3, 32, 32, 3)).astype(np.float32))
    _logits_both_ways(lambda: DenseNet(**SMALL, small_inputs=small_inputs),
                      torch_convert.densenet_from_torch(sd, block_config=bc,
                                                        small_inputs=small_inputs),
                      jax_convert.densenet_from_torch(sd, block_config=bc,
                                                      small_inputs=small_inputs), x)
    features = torch_convert.densenet_from_torch(sd, block_config=bc, classify=False,
                                                 small_inputs=small_inputs)
    assert "classifier" not in features["params"]


def test_count_mlp_from_torch():
    rng = np.random.default_rng(1)
    sd = _count_mlp_sd(rng, 12, 4)
    x = torch.as_tensor(rng.normal(size=(5, 12)).astype(np.float32))
    _logits_both_ways(lambda: CountMLP(12, 4), torch_convert.count_mlp_from_torch(sd),
                      jax_convert.count_mlp_from_torch(sd), x)


def test_gridnet_from_torch():
    rng = np.random.default_rng(2)
    make = lambda: GridNet(CountMLP(12, 4), 4, 4)         # noqa: E731
    sd = _cartesian_corrector_sd(rng, make())
    f_vars = torch_convert.count_mlp_from_torch(_count_mlp_sd(rng, 12, 4))
    x = torch.as_tensor(rng.normal(size=(1, 9, 7, 12)).astype(np.float32))
    _logits_both_ways(make, torch_convert.gridnet_from_torch(sd, f_vars),
                      jax_convert.gridnet_from_torch(sd, f_vars), x)


def test_hex_kernel_maps_equal_jax():
    rng = np.random.default_rng(3)
    k0, k1, k2 = (rng.normal(size=s).astype(np.float32)
                  for s in ((4, 3, 3, 1), (4, 3, 2, 2), (4, 3, 5, 1)))
    got = torch_convert.hex_kernel_from_hexagdly(torch.as_tensor(k0), k1)
    np.testing.assert_array_equal(got, jax_convert.hex_kernel_from_hexagdly(k0, k1))
    assert got.shape == (7, 3, 4)
    k1b = rng.normal(size=(4, 3, 4, 2)).astype(np.float32)
    k2b = rng.normal(size=(4, 3, 3, 2)).astype(np.float32)
    got2 = torch_convert.hex_kernel_from_hexagdly_k2(k2, k1b, k2b)
    np.testing.assert_array_equal(got2, jax_convert.hex_kernel_from_hexagdly_k2(k2, k1b, k2b))
    assert got2.shape == (19, 3, 4)


def test_gridnethex_from_torch():
    rng = np.random.default_rng(4)
    f_vars = torch_convert.count_mlp_from_torch(_count_mlp_sd(rng, 12, 4))
    sd = _hex_corrector_sd(rng, 4, 4)
    x = torch.as_tensor(rng.normal(size=(1, 8, 6, 12)).astype(np.float32))
    _logits_both_ways(lambda: GridNetHex(CountMLP(12, 4), 4, 4),
                      torch_convert.gridnethex_from_torch(sd, f_vars),
                      jax_convert.gridnethex_from_torch(sd, f_vars), x)


def test_gridnethexmm_from_torch():
    rng = np.random.default_rng(5)
    img = torch_convert.densenet_from_torch(_densenet_sd(rng, True),
                                            block_config=SMALL["block_config"],
                                            small_inputs=True)
    cnt = torch_convert.count_mlp_from_torch(_count_mlp_sd(rng, 10, 3))
    sd = _hex_corrector_sd(rng, 6, 3)
    x = (torch.as_tensor(rng.uniform(0, 1, (1, 4, 3, 32, 32, 3)).astype(np.float32)),
         torch.as_tensor(rng.normal(size=(1, 4, 3, 10)).astype(np.float32)))
    _logits_both_ways(lambda: GridNetHexMM(DenseNet(**SMALL), CountMLP(10, 3), 3),
                      torch_convert.gridnethexmm_from_torch(sd, img, cnt),
                      jax_convert.gridnethexmm_from_torch(sd, img, cnt), x)


def test_pth_round_trip(tmp_path):
    rng = np.random.default_rng(6)
    sd = _densenet_sd(rng, False)
    path = tmp_path / "densenet_ref.pth"
    torch.save({"model_state_dict": sd}, path)
    bc = SMALL["block_config"]
    got = torch_convert.load_torch_checkpoint(DenseNet(**SMALL, small_inputs=False), path,
                                              torch_convert.densenet_from_torch,
                                              block_config=bc).eval()
    want = load_variables(DenseNet(**SMALL, small_inputs=False),
                          jax_convert.densenet_from_torch(sd, block_config=bc)).eval()
    x = torch.as_tensor(rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32))
    with torch.no_grad():
        torch.testing.assert_close(got(x), want(x), rtol=0, atol=1e-5)
    # a pickled object that is not a tensor tree is refused, not run
    torch.save({"model_state_dict": sd, "hook": np.random.default_rng}, path)
    with pytest.raises(Exception, match="[Ww]eights only"):
        torch_convert.read_torch_checkpoint(path)


# -- the small leftovers ---------------------------------------------------------------


@pytest.mark.parametrize("shape", [(78, 64), (9, 7), (1, 1)])
def test_hex_neighbor_table_matches_jax(shape):
    from gridnext_tpu import geometry as jax_geometry
    from gridnext_tpu_torch import geometry

    for got, want in zip(geometry.hex_neighbor_table(*shape),
                         jax_geometry.hex_neighbor_table(*shape)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_positions_to_coord_strings_matches_jax(tmp_path):
    from gridnext_tpu.data import simulate_spaceranger_dir
    from gridnext_tpu.io import read_positions as jax_read_positions
    from gridnext_tpu.io.spaceranger import positions_to_coord_strings as jax_coords
    from gridnext_tpu_torch.io import positions_to_coord_strings, read_positions

    sim = simulate_spaceranger_dir(tmp_path / "a", seed=0, n_genes=5, n_classes=2)
    srd = sim["spaceranger_dir"]
    pos, jpos = read_positions(srd), jax_read_positions(srd)
    barcodes = list(np.random.default_rng(0).permutation(pos.barcodes)[:50])
    assert positions_to_coord_strings(pos, barcodes) == jax_coords(jpos, barcodes)
    assert positions_to_coord_strings(pos, []) == []
    with pytest.raises(KeyError):
        positions_to_coord_strings(pos, ["NOT-A-BARCODE"])
    with pytest.raises(KeyError):
        jax_coords(jpos, ["NOT-A-BARCODE"])
