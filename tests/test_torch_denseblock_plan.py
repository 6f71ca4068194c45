"""The dense-block kernel's tile planner (``plan_dense_block``), on the CPU.

The kernel derives each CTA's pixels from its block index as
``plan_ctas`` does; these tests hold every plan the port makes (DenseNet-121's
four blocks at the 624-patch chunk and at small batches, and every shape the
card tests run) to what the kernel needs: each output pixel written by
exactly one CTA, every 3x3 neighbour inside its patch held in that CTA's u,
whole 64-row wgmma tiles, the shared memory a block may use, and no halo
where a CTA holds whole patches.
"""

import pytest

from gridnext_tpu_torch.ops import denseblock_cuda as dense

# (b, side, cb, plan overrides): DenseNet-121's blocks at B = 624 and the
# shapes of tests/test_torch_cuda.py
CASES = [
    (624, 32, 128, {}), (624, 16, 128, {}), (624, 8, 128, {}), (624, 4, 128, {}),
    (3, 32, 128, {}), (1, 32, 128, {}), (2, 32, 128, {}), (5, 16, 128, {}),
    (7, 8, 128, {}), (9, 4, 128, {}), (5, 4, 128, {}), (2, 12, 32, {}), (13, 8, 128, {}),
    (3, 9, 48, {}), (4, 7, 24, {}), (1, 150, 16, {}), (3, 16, 128, {}),
    (2, 32, 128, {"band_rows": 6}), (2, 32, 128, {"band_rows": 8}),
    (2, 32, 128, {"band_rows": 16}), (5, 4, 128, {"patches": 4}),
    (7, 8, 128, {"patches": 4}), (624, 32, 128, {"band_rows": 8}),
]
IDS = [f"b{b}-{s}x{s}-cb{cb}" + "".join(f"-{k}{v}" for k, v in o.items())
       for b, s, cb, o in CASES]


@pytest.mark.parametrize("b,side,cb,override", CASES, ids=IDS)
def test_plan_covers_each_output_once_with_its_taps(b, side, cb, override):
    h = w = side
    hw, m = h * w, b * h * w
    plan = dense.plan_dense_block(b, h, w, cb, **override)
    ctas = list(dense.plan_ctas(plan, b, h, w))
    assert len(ctas) == plan.ctas
    written = [0] * m
    for u0, nu, o0, no in ctas:
        assert nu <= plan.u_pix and no >= 1
        assert u0 <= o0 and o0 + no <= u0 + nu          # outputs inside the u range
        for q in range(o0, o0 + no):
            written[q] += 1
            y, x = (q % hw) // w, q % w
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    if 0 <= y + dy < h and 0 <= x + dx < w:
                        assert u0 <= q + dy * w + dx < u0 + nu
    assert written == [1] * m


@pytest.mark.parametrize("b,side,cb,override", CASES, ids=IDS)
def test_plan_tiles_and_shared_memory(b, side, cb, override):
    plan = dense.plan_dense_block(b, side, side, cb, **override)
    assert plan.smem_bytes == dense.smem_bytes(plan.u_pix, cb, plan.warpgroups, plan.stages)
    assert plan.smem_bytes <= dense.SMEM_LIMIT == 232_448
    assert 1 <= plan.warpgroups <= dense.MAX_WARPGROUPS and 2 <= plan.stages <= 4
    tiles = -(-plan.u_pix // dense.TILE)
    # u is allocated in whole 64-row tiles; a round gives each warpgroup one
    assert plan.warpgroups == min(dense.MAX_WARPGROUPS, tiles)
    cbp = -(-cb // 16) * 16
    assert plan.smem_bytes >= (tiles * dense.TILE + 1) * (cbp + 8) * 2
    if plan.band_rows == 0:                              # whole patches: no halo
        hw = side * side
        assert plan.u_pix == plan.patches * hw
        for u0, nu, o0, no in dense.plan_ctas(plan, b, side, side):
            assert u0 == o0 and u0 % hw == 0 and nu % hw == 0
    else:
        assert plan.u_pix == (plan.band_rows + 2) * side


def test_densenet121_plans():
    """The rule at DenseNet-121's chunk: block 1 in bands of 14 rows, blocks
    2-4 in whole patches, block 4 eight patches (two 64-pixel tiles) a CTA."""
    plans = [dense.plan_dense_block(624, s, s, 128) for s in (32, 16, 8, 4)]
    assert [(p.band_rows, p.patches, p.warpgroups, p.ctas) for p in plans] == [
        (14, 1, 4, 1872), (0, 1, 4, 624), (0, 4, 4, 156), (0, 8, 2, 78)]


def test_plan_refuses_rows_too_wide_for_shared_memory():
    with pytest.raises(ValueError, match="cannot hold u"):
        dense.plan_dense_block(1, 4, 400, 128)
