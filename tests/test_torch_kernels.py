"""Parity of the torch port's kernel twins with the JAX package.

Each twin in ``cluster_tools_tpu_torch.ops.kernels`` is held, with zero
tolerance, against the Pallas kernel it replaces (run in interpret mode,
as the JAX package's own tests run it) and against the JAX package's plain
twin.  The hand-written CUDA kernels are held against the same twins on the
card (``gpu`` tests, skipped where there is no CUDA device).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cluster_tools_tpu.ops import edt as jedt
from cluster_tools_tpu.ops import tile_ws as jws
from cluster_tools_tpu.ops.pallas_kernels import (
    apply_remap_pallas,
    edt_cascade_pallas,
    tile_ccl_pallas,
    tile_ws_propagate_pallas,
)
from cluster_tools_tpu.ops.tile_ccl import resolve_labels_gather, tile_local_labels_xla
from cluster_tools_tpu_torch.ops import edt as tedt
from cluster_tools_tpu_torch.ops import kernels as K
from cluster_tools_tpu_torch.ops import tile_ccl as tccl
from cluster_tools_tpu_torch.ops import tile_ws as tws
from cluster_tools_tpu_torch.utils.reference_io import from_reference
from cluster_tools_tpu_torch.utils.synthetic import (
    REMAP_KINDS,
    adversarial_flow_np,
    adversarial_remap_np,
    adversarial_tiles_np,
    flow_edits_np,
    synthetic_boundaries_np,
)

TILE = (16, 16, 128)
SHAPE = (16, 32, 256)

# one intra-op thread: the suite runs many test processes side by side, and
# torch's default thread pool oversubscribes the cores under that load
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _pin_modes(monkeypatch):
    monkeypatch.setenv("CT_TIER_MODE", "cond")
    monkeypatch.setenv("CT_FILL_MODE", "capacity")
    monkeypatch.setenv("CT_SEED_CCL", "tiled")


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def volume():
    return synthetic_boundaries_np(SHAPE, seed=7, passes=2)


@pytest.fixture(scope="module")
def masks(volume):
    rng = np.random.default_rng(3)
    return {
        "smooth": volume < np.median(volume),
        "noise": rng.random(SHAPE) < 0.45,
    }


@pytest.fixture(scope="module")
def flow_inputs(volume):
    """A descent field and seed map shaped like the flow stage's inputs."""
    rng = np.random.default_rng(5)
    seeds = np.zeros(SHAPE, np.int32)
    pts = rng.integers(0, SHAPE, size=(12, 3))
    seeds[tuple(pts.T)] = np.arange(1, 13)
    valid = rng.random(SHAPE) < 0.95
    dirs = np.asarray(jws.descent_directions(jnp.asarray(volume), jnp.asarray(seeds > 0), jnp.asarray(valid)))
    sv = np.where(valid, seeds, -1).astype(np.int32)
    return dirs.astype(np.int32), sv


@pytest.mark.parametrize("kind", ["smooth", "noise"])
def test_tile_ccl_twin_matches_pallas_and_reference_twin(masks, kind):
    m = masks[kind]
    want = np.asarray(tile_ccl_pallas(jnp.asarray(m), tile=TILE, interpret=True))
    got = K.tile_ccl(_t(m), TILE).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(tile_local_labels_xla(jnp.asarray(m), TILE)))
    assert got.dtype == np.int32


# the reference's own adversarial masks for the run-doubling kernel
# (tests/test_tile_ccl.py), then the smooth and noise masks above
DOUBLING_CASES = ["p0.5-seed0", "p0.75-seed1", "p0.2-seed2", "smooth", "noise"]


def _ccl_case(masks, case):
    if case in masks:
        return masks[case]
    p, seed = case.split("-")
    return np.random.default_rng(int(seed[4:])).random(SHAPE) < float(p[1:])


@pytest.mark.parametrize("formulation", ["doubling", "runs"])
@pytest.mark.parametrize("case", DOUBLING_CASES)
def test_tile_ccl_doubling_twin_matches_pallas_doubling(masks, case, formulation):
    m = _ccl_case(masks, case)
    want = np.asarray(tile_ccl_pallas(jnp.asarray(m), tile=TILE, interpret=True, doubling=True))
    np.testing.assert_array_equal(K.tile_ccl_doubling_torch(_t(m), TILE, formulation).numpy(), want)
    got = K.tile_ccl(_t(m), TILE, doubling=True).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32


# small tiles: unaligned rows and odd ty (4x5x30), and an axis of extent 1
SMALL_CCL_TILES = [(4, 5, 30), (4, 8, 32), (1, 16, 128)]


@pytest.mark.parametrize("tile", SMALL_CCL_TILES, ids=lambda t: "x".join(map(str, t)))
def test_tile_ccl_doubling_formulations_match_pallas_on_adversarial_tiles(tile):
    m = adversarial_tiles_np(tile)
    want = np.asarray(tile_ccl_pallas(jnp.asarray(m), tile=tile, interpret=True, doubling=True))
    lab, iters = {}, {}
    for form in ("doubling", "runs"):
        lab[form], iters[form] = K.tile_ccl_doubling_torch(_t(m), tile, form, return_iterations=True)
        np.testing.assert_array_equal(lab[form].numpy(), want)
    # the same state after every iteration, so the same count a tile
    assert torch.equal(iters["doubling"], iters["runs"])
    assert iters["runs"].dtype == torch.int32 and iters["runs"].shape == (8,)
    assert int(iters["runs"][0]) == 2 and int(iters["runs"][7]) == 1  # all foreground; empty
    assert int(iters["runs"].max()) > 2  # the serpentines take many


@pytest.mark.parametrize("doubling", [False, True])
@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_tile_ccl_refuses_2_30_voxels(doubling, impl):
    mask = torch.empty((1024, 1024, 1024), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match=r"2\*\*30 voxels"):
        K.tile_ccl(mask, TILE, impl=impl, doubling=doubling)


def test_descent_directions_match(volume, flow_inputs):
    dirs, sv = flow_inputs
    got = tws.descent_directions(_t(volume), _t(sv > 0), _t(sv >= 0))
    np.testing.assert_array_equal(got.numpy(), dirs)


@pytest.mark.parametrize("formulation", ["jump", "stepping"])
def test_tile_ws_propagate_twin_matches_pallas_and_reference_twin(flow_inputs, formulation):
    dirs, sv = flow_inputs
    want = np.asarray(tile_ws_propagate_pallas(jnp.asarray(dirs), jnp.asarray(sv), tile=TILE, interpret=True))
    got = K.tile_ws_propagate_torch(_t(dirs), _t(sv), TILE, formulation).numpy()
    np.testing.assert_array_equal(got, want)
    ref_twin = np.asarray(jws.tile_ws_propagate_xla(jnp.asarray(dirs), jnp.asarray(sv), TILE))
    np.testing.assert_array_equal(got, ref_twin)


@pytest.fixture(scope="module")
def flow_repair(flow_inputs):
    """The flow inputs with voxels the flow stage never makes: seeded and
    invalid voxels pointing at an unseeded in-tile terminal, seeded,
    invalid and unseeded exits, and codes outside 0..6."""
    return flow_edits_np(*flow_inputs, TILE, seed=0)


@pytest.mark.parametrize("formulation", ["jump", "stepping"])
def test_tile_ws_propagate_twin_matches_pallas_off_the_flow_stage_domain(flow_inputs, flow_repair, formulation):
    dirs, sv = flow_repair
    edited = (dirs != flow_inputs[0]) | (sv != flow_inputs[1])
    assert ((sv > 0) & (dirs != 0) & edited).sum() >= 8  # seeded non-terminals, in-tile and exits
    assert ((sv < 0) & (dirs != 0)).sum() >= 8
    assert ((dirs < 0) | (dirs > 6)).any()
    want = np.asarray(tile_ws_propagate_pallas(jnp.asarray(dirs), jnp.asarray(sv), tile=TILE, interpret=True))
    got = K.tile_ws_propagate_torch(_t(dirs), _t(sv), TILE, formulation).numpy()
    np.testing.assert_array_equal(got, want)


# small tiles keep the stepping loops short; 4x5x30 has unaligned rows and odd ty
FLOW_TILES = [(4, 8, 32), (4, 5, 30), (8, 8, 64)]


@pytest.mark.parametrize("tile", FLOW_TILES, ids=lambda t: "x".join(map(str, t)))
@pytest.mark.parametrize("formulation", ["jump", "stepping"])
def test_tile_ws_propagate_twin_matches_pallas_on_adversarial_fields(tile, formulation):
    dirs, sv = adversarial_flow_np(tile)
    want = np.asarray(tile_ws_propagate_pallas(jnp.asarray(dirs), jnp.asarray(sv), tile=tile, interpret=True))
    got = K.tile_ws_propagate(_t(dirs), _t(sv), tile) if formulation == "jump" else (
        K.tile_ws_propagate_torch(_t(dirs), _t(sv), tile, formulation))
    np.testing.assert_array_equal(got.numpy(), want)


EDT_SHAPE = (16, 24, 256)


@pytest.fixture(scope="module")
def edt_input():
    m = np.random.default_rng(11).random(EDT_SHAPE) < 0.8
    return np.where(m, np.float32(1e12), np.float32(0.0)).astype(np.float32)


@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("radius", ["32", "n-1"])
def test_edt_cascade_twin_matches_pallas_bit_for_bit(edt_input, axis, radius):
    n = EDT_SHAPE[axis]
    r = min(32, n - 1) if radius == "32" else n - 1
    w = (40.0**2, 4.0**2, 1.5**2)[axis]  # anisotropic sampling (40, 4, 1.5)
    want = np.asarray(edt_cascade_pallas(jnp.asarray(edt_input), axis, r, w, 1e12, interpret=True))
    got = K.edt_cascade(_t(edt_input), axis, r, w, 1e12).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("radius", ["32", "n-1"])
def test_edt_axis_matches_reference_twin_bit_for_bit(edt_input, axis, radius):
    # n-1 on the x axis (255 > 160) takes the one-shot broadcast branch
    n = EDT_SHAPE[axis]
    r = 32 if radius == "32" else n - 1
    w = (40.0**2, 4.0**2, 1.5**2)[axis]
    want = np.asarray(jedt._edt_1d_axis(jnp.asarray(edt_input), axis, w, r))
    got = tedt._edt_1d_axis(_t(edt_input), axis, w, r).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sampling,radii", [((1.0, 1.0, 1.0), (8, 8, 8)), ((40.0, 4.0, 4.0), (3, 12, 12))])
def test_dt_squared_matches_both_reference_routes(sampling, radii):
    mask = np.random.default_rng(2).random((10, 20, 130)) < 0.7
    want_xla = np.asarray(jedt._dt_squared_impl(jnp.asarray(mask), sampling, radii, impl="xla"))
    want_pallas = np.asarray(
        jedt._dt_squared_impl(jnp.asarray(mask), sampling, radii, impl="pallas", interpret=True)
    )
    got = tedt.dt_squared(_t(mask), sampling, radii).numpy()
    np.testing.assert_array_equal(got, want_xla)
    np.testing.assert_array_equal(got, want_pallas)


@pytest.fixture(scope="module")
def remap_case(masks):
    """Labels plus tables with -1 slots, a chained pair and no-op slots."""
    lab = np.asarray(tile_ccl_pallas(jnp.asarray(masks["smooth"]), tile=TILE, interpret=True))
    n_tiles = (SHAPE[0] // 16) * (SHAPE[1] // 16) * (SHAPE[2] // 128)
    old = np.full((n_tiles, 64), -1, np.int32)
    new = np.full((n_tiles, 64), -1, np.int32)
    rng = np.random.default_rng(9)
    present = np.unique(lab)
    for t in range(n_tiles):
        k = int(rng.integers(1, 12))
        slots = rng.choice(64, size=k, replace=False)
        old[t, slots] = rng.choice(present, size=k)
        new[t, slots] = old[t, slots] + 3
    # chain: a -> b in slot 40, then b -> c in slot 41 (order matters)
    old[0, 40], new[0, 40] = present[0], present[1]
    old[0, 41], new[0, 41] = present[1], present[2]
    old[1, 50] = new[1, 50] = present[3]  # a no-op slot
    return lab, old, new


def test_apply_remap_twin_matches_pallas(remap_case):
    lab, old, new = remap_case
    want = np.asarray(
        apply_remap_pallas(jnp.asarray(lab), jnp.asarray(old), jnp.asarray(new), tile=TILE, cap=64, interpret=True)
    )
    got = K.apply_remap(_t(lab), _t(old), _t(new), TILE, 64).numpy()
    np.testing.assert_array_equal(got, want)


REMAP_TILE = (4, 8, 32)


@pytest.fixture(scope="module")
def remap_labels():
    """Tile-CCL labels over 12 small tiles (room for every table kind)."""
    m = np.random.default_rng(12).random((8, 16, 96)) < 0.6
    return np.asarray(tile_ccl_pallas(jnp.asarray(m), tile=REMAP_TILE, interpret=True))


@pytest.mark.parametrize("kind", REMAP_KINDS + ("mixed",))
def test_apply_remap_twin_matches_pallas_on_adversarial_tables(remap_labels, kind):
    lab, old, new = adversarial_remap_np(remap_labels, REMAP_TILE, kind)
    want = np.asarray(apply_remap_pallas(jnp.asarray(lab), jnp.asarray(old), jnp.asarray(new),
                                         tile=REMAP_TILE, cap=64, interpret=True))
    got = K.apply_remap(_t(lab), _t(old), _t(new), REMAP_TILE, 64).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got != lab).any()


def test_gather_rungs_match_reference(masks):
    """The rungs B4 falls back to (the reference twins of B4)."""
    m = masks["noise"]
    lab = K.tile_ccl(_t(m), TILE)
    ea, eb, ra, rb, _, ovf = tccl.merge_face_pairs(lab, TILE, pair_cap=16384, edge_cap=16384)
    assert not bool(ovf)
    want = np.asarray(resolve_labels_gather(*(jnp.asarray(x.numpy()) for x in (lab, ea, eb, ra, rb))))
    np.testing.assert_array_equal(tccl.resolve_labels_gather(lab, ea, eb, ra, rb).numpy(), want)

    rng = np.random.default_rng(4)
    values = -rng.integers(2, lab.numel() + 2, size=SHAPE).astype(np.int32)
    values[rng.random(SHAPE) < 0.3] = 5
    codes = np.unique(values[values <= -2])[:500].astype(np.int32)
    codes = np.concatenate([codes, np.full(100, 2**30, np.int32)])
    finals = rng.integers(0, 50, size=codes.shape).astype(np.int32)
    want = np.asarray(jws._resolve_codes_gather(jnp.asarray(values), jnp.asarray(codes), jnp.asarray(finals)))
    got = tws._resolve_codes_gather(_t(values), _t(codes), _t(finals)).numpy()
    np.testing.assert_array_equal(got, want)


def _row_scan_input(kind: str, rows: int, n: int, gen: torch.Generator) -> torch.Tensor:
    """A ``[rows, n]`` input of the row scan: ``sum`` random int32 (its
    sums wrap), ``wrap`` every entry 2^30 (the sum passes 2^31 at the third
    entry), ``bool`` flags, ``max`` -1 rows with a sparse 1e-3 of them the
    column index (as the stages' running-max sites have them), ``-1 max``
    only -1."""
    dev = gen.device
    if kind == "wrap":
        return torch.full((rows, n), 2**30, dtype=torch.int32, device=dev)
    if kind == "bool":
        return torch.rand((rows, n), generator=gen, device=dev) < 0.3
    if kind == "-1 max":
        return torch.full((rows, n), -1, dtype=torch.int32, device=dev)
    if kind == "max":
        col = torch.arange(n, dtype=torch.int32, device=dev).expand(rows, n)
        return torch.where(torch.rand((rows, n), generator=gen, device=dev) < 1e-3, col, -1)
    return torch.randint(-(2**31), 2**31 - 1, (rows, n), generator=gen, dtype=torch.int32, device=dev)


@pytest.mark.parametrize("rows", [1, 8])
@pytest.mark.parametrize("n", [0, 1, 4097])
@pytest.mark.parametrize("kind", ["sum", "wrap", "bool", "max", "-1 max"])
def test_row_scan_twin_matches_numpy(rows, n, kind):
    """The row scan's twin (the route a CPU tensor takes) against numpy,
    row by row: int32 sums wrap as numpy's int32 sums do."""
    x = _row_scan_input(kind, rows, n, torch.Generator().manual_seed(rows * 10007 + n))
    op = "max" if kind.endswith("max") else "sum"
    got = K.row_scan(x, op)
    assert got.dtype == torch.int32 and got.shape == (rows, n)
    for r, row in enumerate(x.numpy()):
        want = np.maximum.accumulate(row) if op == "max" else np.cumsum(row, dtype=np.int32)
        np.testing.assert_array_equal(got[r].numpy(), want.astype(np.int32), err_msg=f"row {r}")


def test_reference_io_roundtrip(volume):
    tensors, kwargs = from_reference(volume, seeds=np.zeros(SHAPE, np.int64), device="cpu",
                                     impl="pallas", interpret=True, threshold=0.4, sigma_seeds=0.0)
    assert tensors["volume"].dtype == torch.float32 and tensors["seeds"].dtype == torch.int32
    np.testing.assert_array_equal(tensors["volume"].numpy(), volume)
    assert kwargs == {"impl": "auto", "threshold": 0.4, "device": torch.device("cpu")}
    with pytest.raises(NotImplementedError):
        from_reference(volume, device="cpu", sigma_seeds=1.0)


# ---- the CUDA kernels against their twins (on the card only) ----


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only on the card")
    return torch.device("cuda")


def _gpu_ccl_masks(masks):
    """The parity masks plus tiles that stress in-tile CCL: all foreground,
    checkerboard, isolated voxels, serpentines (one-voxel-wide paths
    filling a tile), random and empty tiles."""
    out = {case: _ccl_case(masks, case) for case in DOUBLING_CASES}
    out["adversarial"] = adversarial_tiles_np(TILE)
    return out


@pytest.mark.gpu
def test_cuda_tile_ccl_matches_twin(cuda, masks):
    for case, m in _gpu_ccl_masks(masks).items():
        m = _t(m).to(cuda)
        assert torch.equal(K.tile_ccl(m, TILE, impl="cuda"), K.tile_ccl_torch(m, TILE)), case


@pytest.mark.gpu
def test_cuda_tile_ccl_doubling_matches_both_twins(cuda, masks):
    cases = [(case, m, TILE) for case, m in _gpu_ccl_masks(masks).items()]
    # small tiles; an axis of extent 1 (the tile's z, or its rows); columns
    # longer than the kernel holds in registers; rows that span a warp
    tiles = SMALL_CCL_TILES + [(16, 16, 1), (40, 24, 16), (1, 4, 512)]
    cases += [(f"adversarial {t}", adversarial_tiles_np(t), t) for t in tiles]
    for case, m, tile in cases:
        m = _t(m).to(cuda)
        got, iters = K.tile_ccl(m, tile, impl="cuda", doubling=True, return_iterations=True)
        for form in ("doubling", "runs"):
            want, want_iters = K.tile_ccl_doubling_torch(m, tile, form, return_iterations=True)
            assert torch.equal(got, want), (case, form)
            assert torch.equal(iters, want_iters), (case, form)
        assert torch.equal(got, K.tile_ccl_torch(m, tile)), case
        assert torch.equal(K.tile_ccl(m, tile, impl="cuda", doubling=True), got), case


@pytest.mark.gpu
def test_cuda_tile_ws_propagate_matches_twin(cuda, flow_inputs):
    dirs, sv = (_t(a).to(cuda) for a in flow_inputs)
    assert torch.equal(K.tile_ws_propagate(dirs, sv, TILE, impl="cuda"), K.tile_ws_propagate_torch(dirs, sv, TILE))


@pytest.mark.gpu
def test_cuda_tile_ws_propagate_matches_pallas_off_the_flow_stage_domain(cuda, flow_repair):
    dirs, sv = flow_repair
    want = np.asarray(tile_ws_propagate_pallas(jnp.asarray(dirs), jnp.asarray(sv), tile=TILE, interpret=True))
    got = K.tile_ws_propagate(_t(dirs).to(cuda), _t(sv).to(cuda), TILE, impl="cuda")
    np.testing.assert_array_equal(got.cpu().numpy(), want)


@pytest.mark.gpu
def test_cuda_tile_ws_propagate_matches_twins_on_adversarial_fields(cuda):
    for tile in FLOW_TILES + [TILE]:
        dirs, sv = (_t(a).to(cuda) for a in adversarial_flow_np(tile))
        got = K.tile_ws_propagate(dirs, sv, tile, impl="cuda")
        assert torch.equal(got, K.tile_ws_propagate_torch(dirs, sv, tile, "jump")), tile
        assert torch.equal(got, K.tile_ws_propagate_torch(dirs, sv, tile, "stepping")), tile


@pytest.mark.gpu
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_cuda_edt_cascade_matches_twin(cuda, edt_input, axis):
    f = _t(edt_input).to(cuda)
    for r, w in ((32, 1.0), (EDT_SHAPE[axis] - 1, 2.25)):
        r = min(r, EDT_SHAPE[axis] - 1)
        assert torch.equal(K.edt_cascade(f, axis, r, w, 1e12, impl="cuda"), K.edt_cascade_torch(f, axis, r, w, 1e12))
    # short, odd and long lines (n not a multiple of 32, n < 32, radius
    # n - 1 above 32, n = 1100 above the register paths) with the
    # anisotropic weights
    w = (40.0**2, 4.0**2, 1.5**2)[axis]
    rng = np.random.default_rng(13)
    for n in (1, 7, 31, 33, 127, 576, 1100):
        dims = [6, 9, 45]
        dims[axis] = n
        g = np.where(rng.random(dims) < 0.8, np.float32(1e12), rng.random(dims, np.float32) * 100)
        g = _t(g.astype(np.float32)).to(cuda)
        for r in sorted({0, 1, min(32, n - 1), n - 1}):
            got = K.edt_cascade(g, axis, r, w, 1e12, impl="cuda")
            assert torch.equal(got, K.edt_cascade_torch(g, axis, r, w, 1e12)), (n, r)


@pytest.mark.gpu
def test_cuda_apply_remap_matches_twin(cuda, remap_case):
    lab, old, new = (_t(a).to(cuda) for a in remap_case)
    assert torch.equal(K.apply_remap(lab, old, new, TILE, 64, impl="cuda"), K.apply_remap_torch(lab, old, new, TILE, 64))


@pytest.mark.gpu
def test_cuda_apply_remap_matches_twin_on_adversarial_tables(cuda, remap_labels, remap_case):
    for labels, tile in ((remap_labels, REMAP_TILE), (remap_case[0], TILE)):
        for kind in REMAP_KINDS + ("mixed",):
            lab, old, new = (_t(a).to(cuda) for a in adversarial_remap_np(labels, tile, kind))
            got = K.apply_remap(lab, old, new, tile, 64, impl="cuda")
            assert torch.equal(got, K.apply_remap_torch(lab, old, new, tile, 64)), (tile, kind)


def _int32(x: torch.Tensor) -> torch.Tensor:
    """int64 values wrapped to int32, as the kernels' int32 arithmetic wraps."""
    return ((x + 2**31) % 2**32 - 2**31).to(torch.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["tile_ws_propagate", "apply_remap"])
def test_cuda_row_kernels_address_volumes_of_2_31_voxels_or_more(cuda, kernel):
    """B2 and B4 on a volume whose last z-slab of tiles lies past 2^31
    voxels: the first and the last slab equal the twin run on that slab
    alone (B2's exit and terminal codes shifted by the slab's global
    offset)."""
    shape = (2064, 1024, 1024)  # 2^31 + 2^24 voxels; z >= 2048 is past 2^31
    per_slab = (shape[1] // TILE[1]) * (shape[2] // TILE[2])
    gen = torch.Generator(device=cuda).manual_seed(3)
    slabs = (slice(0, TILE[0]), slice(shape[0] - TILE[0], shape[0]))
    if kernel == "apply_remap":
        lab = torch.randint(0, 50, shape, generator=gen, dtype=torch.int32, device=cuda)
        n_tiles = per_slab * shape[0] // TILE[0]
        old, new = (torch.randint(0, 50, (n_tiles, 64), generator=gen, dtype=torch.int32, device=cuda) for _ in range(2))
        got = K.apply_remap(lab, old, new, TILE, 64, impl="cuda")
        for i, sl in zip((0, n_tiles // per_slab - 1), slabs):
            tab = slice(i * per_slab, (i + 1) * per_slab)
            assert torch.equal(got[sl], K.apply_remap_torch(lab[sl], old[tab], new[tab], TILE, 64)), i
    else:
        # codes 0, +z, +y, +x only: every path climbs the flat index, so the
        # field is acyclic; a quarter terminals, seeds 1..2, invalid -1
        dirs = torch.randint(0, 4, shape, generator=gen, dtype=torch.int32, device=cuda).mul_(2)
        sv = torch.randint(-1, 3, shape, generator=gen, dtype=torch.int32, device=cuda)
        got = K.tile_ws_propagate(dirs, sv, TILE, impl="cuda")
        for sl in slabs:
            want = K.tile_ws_propagate_torch(dirs[sl], sv[sl], TILE).to(torch.int64)
            base = sl.start * shape[1] * shape[2]
            want = torch.where(want < -1, want - base, want)  # -(g + 2) codes
            assert torch.equal(got[sl], _int32(want)), sl


ROW_SCAN_CASES = [
    ((1, 576**3), "sum"), ((1, 576**3), "bool"), ((1, 576**3), "max"),
    ((8, 114 * 576 * 576), "sum"), ((8, 114 * 576 * 576), "bool"), ((8, 114 * 576 * 576), "max"),
    ((3, 1_000_003), "sum"), ((3, 1_000_003), "bool"), ((3, 1_000_003), "max"),
    ((3, 1_000_003), "wrap"), ((3, 1_000_003), "-1 max"),
] + [((2, n), kind) for n in (0, 1, K.ROW_SCAN_TILE - 1, K.ROW_SCAN_TILE + 1)
     for kind in ("sum", "bool", "max", "-1 max")]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,kind", ROW_SCAN_CASES, ids=lambda c: "x".join(map(str, c)) if isinstance(c, tuple) else c)
def test_cuda_row_scan_matches_twin(cuda, shape, kind):
    """The row scan against its twin (torch's own scans on the card), bit
    for bit: the stages' shapes (a 576^3 row, eight 114x576x576 rows), a
    ragged row, rows of 0, 1 and a tile +- 1 elements, bool flags, a sum
    that wraps past 2^31 and rows of -1 alone."""
    x = _row_scan_input(kind, *shape, torch.Generator(device=cuda).manual_seed(shape[1] % 1000 + shape[0]))
    op = "max" if kind.endswith("max") else "sum"
    K.reset_counts()
    got = K.row_scan(x, op, impl="cuda")
    torch.cuda.synchronize()
    assert K.LAUNCHES[f"row_scan.{op}"] == (1 if x.numel() else 0)
    assert torch.equal(got, K.row_scan_torch(x, op))


@pytest.mark.gpu
def test_cuda_step_scans_rows_on_the_row_scan(cuda):
    """A traced tiny step (the benchmark configuration's CPU size) launches
    no torch row scan, counts row-scan launches, and returns the CPU twins'
    labels bit for bit; the same step with ``impl="torch"`` on the card
    launches no kernel."""
    import json
    from pathlib import Path

    from torch.profiler import ProfilerActivity, profile

    from cluster_tools_tpu_torch.parallel.split_pipeline import make_ws_ccl_split

    config = json.loads((Path(__file__).resolve().parents[1] / "port_bench/configs/ws_cc_step_512.json").read_text())
    kw = dict(config["step"], **config["tiny"]["step"])
    vol = _t(synthetic_boundaries_np((1,) + tuple(config["tiny"]["volume_shape"]), seed=11))
    make_ws_ccl_split(device="cuda", **kw)(vol.to(cuda))  # loads the kernels
    K.reset_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        got = make_ws_ccl_split(device="cuda", **kw)(vol.to(cuda))
        torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    names = {e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA}
    assert not [n for n in names if "tensor_kernel_scan_innermost_dim" in n], sorted(names)
    assert launches.get("row_scan.max", 0) > 0 and launches.get("row_scan.sum", 0) > 0, launches
    want = make_ws_ccl_split(device="cpu", **dict(kw, fill_mode="capacity"))(vol)
    for what, a, b in zip(("ws", "cc", "n_fg", "overflow"), got, want):
        assert torch.equal(torch.as_tensor(a).cpu(), torch.as_tensor(b)), what
    K.reset_counts()
    make_ws_ccl_split(device="cuda", impl="torch", **kw)(vol.to(cuda))
    torch.cuda.synchronize()
    assert not sum(K.LAUNCHES.values()), dict(K.LAUNCHES)


def test_cuda_route_refuses_cpu_tensors(masks):
    with pytest.raises(ValueError):
        K.tile_ccl(_t(masks["smooth"]), TILE, impl="cuda")
