"""The port's distributed CCL and mesh-exact EDT against the JAX package's
on the 8-device CPU mesh, and against scipy: labels bit for bit (the
legacy labeller and the tiled one), connectivity 1-3 across slab, two-axis
and diagonal shards, compaction and its overflow flag, the pair-dedup
branch and its fallback; the squared EDT bit for bit, exact and capped, on
one and two sharded axes."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP
from scipy import ndimage

from cluster_tools_tpu.compat import shard_map as j_shard_map
from cluster_tools_tpu.parallel import distributed_connected_components as j_dcc
from cluster_tools_tpu.parallel import distributed_distance_transform as j_edt
from cluster_tools_tpu.parallel import make_mesh as j_make_mesh
from cluster_tools_tpu.parallel.distributed_ccl import sharded_label_components as j_slc
from cluster_tools_tpu_torch.parallel import distributed_ccl as dc
from cluster_tools_tpu_torch.parallel import spmd
from cluster_tools_tpu_torch.parallel.distributed_ccl import distributed_connected_components
from cluster_tools_tpu_torch.parallel.distributed_edt import (
    distributed_distance_transform,
    distributed_distance_transform_squared,
)
from cluster_tools_tpu_torch.parallel.mesh import make_mesh
from cluster_tools_tpu_torch.parallel.spmd import P

from .helpers import assert_labels_equivalent, random_blobs

torch.set_num_threads(1)


def _meshes(axes):
    return (j_make_mesh(8, axis_names=axes, devices=jax.devices("cpu")),
            make_mesh(8, axis_names=axes, devices=["cpu"] * 8))


def _scipy(mask, connectivity=1):
    return ndimage.label(mask, structure=ndimage.generate_binary_structure(mask.ndim, connectivity))[0]


def _check(mask, axes, sp_axis, connectivity=1, reference=True, **kw):
    """The port's labels with the legacy labeller and (at connectivity 1)
    the tiled one, against scipy's partition and, with ``reference``, bit
    for bit against the JAX package's legacy run.  Both labellers give a
    component its minimum flat index, so one reference run holds both (a
    JAX run re-traces at every call: ~10 s here)."""
    jm, pm = _meshes(axes)
    want = None
    if reference:
        want = np.asarray(j_dcc(mask, jm, sp_axis=sp_axis, connectivity=connectivity, impl="legacy", **kw))
    for impl in ("legacy", "auto") if connectivity == 1 else ("legacy",):
        got = distributed_connected_components(mask, pm, sp_axis=sp_axis, connectivity=connectivity,
                                               impl=impl, **kw)
        assert got.dtype == torch.int32
        if want is not None:
            np.testing.assert_array_equal(got.numpy(), want)
        assert_labels_equivalent(got.numpy(), _scipy(mask, connectivity))
    return got.numpy()


def test_slab_ccl_matches_reference_and_scipy():
    mask = random_blobs(np.random.default_rng(42), (8 * 8, 24, 24), p=0.4)
    _check(mask, ("sp",), "sp")


def test_two_axis_ccl_matches_reference_and_scipy():
    mask = random_blobs(np.random.default_rng(43), (2 * 6, 4 * 6, 20), p=0.45)
    _check(mask, ("spz", "spy"), ("spz", "spy"))


def test_component_spanning_all_shards():
    mask = np.zeros((8 * 4, 8, 8), bool)
    mask[:, 3, 3] = True  # one rod through every shard
    mask[0, 0, 0] = True  # plus an isolated voxel
    labels = _check(mask, ("sp",), "sp", reference=False)
    rod = labels[:, 3, 3]
    assert (rod == rod[0]).all() and rod[0] > 0
    assert labels[0, 0, 0] > 0 and labels[0, 0, 0] != rod[0]


@pytest.mark.parametrize("connectivity", [2, 3])
def test_full_connectivity_stitches_diagonals(connectivity):
    mask = random_blobs(np.random.default_rng(44 + connectivity), (8 * 6, 20, 20), p=0.25)
    _check(mask, ("sp",), "sp", connectivity=connectivity)


def test_two_axis_diagonal_shards_connectivity_3():
    """Voxels meeting only at the corner of four diagonal shards merge.
    One JAX run (~40 s here, tier-2 in the reference's own tests) holds
    the labels bit for bit, beside scipy's partition."""
    shape = (2 * 4, 4 * 4, 8)
    mask = random_blobs(np.random.default_rng(47), shape, p=0.25)
    mask[2:6, 2:6, 1:5] = False  # nothing else touches the pair below
    mask[3, 3, 2] = True  # shard (spz 0, spy 0)
    mask[4, 4, 3] = True  # shard (spz 1, spy 1)
    labels = _check(mask, ("spz", "spy"), ("spz", "spy"), connectivity=3)
    assert labels[3, 3, 2] == labels[4, 4, 3] != 0
    assert (labels == labels[3, 3, 2]).sum() == 2


def test_compacted_labels():
    mask = random_blobs(np.random.default_rng(48), (8 * 8, 24, 24), p=0.4)
    labels = _check(mask, ("sp",), "sp", max_labels_per_shard=512)
    assert labels.max() < 8 * 513, "labels escaped the compacted space"


@pytest.fixture(scope="module")
def overflow_case():
    """A shard with more components than the cap: the reference's flag and
    (aliased) labels, from inside its body."""
    jm, _ = _meshes(("sp",))
    mask = np.zeros((8 * 8, 9, 9), bool)
    mask[::2, ::2, ::2] = True  # isolated voxels: ~81 components a shard
    lab, ovf = j_shard_map(
        lambda m: j_slc(m, axis_name="sp", axis_size=8, max_labels_per_shard=8, return_overflow=True),
        mesh=jm, in_specs=JP("sp"), out_specs=(JP("sp"), JP()), check_vma=False)(mask)
    return mask, np.asarray(lab), bool(ovf)


@pytest.mark.parametrize("impl", ["legacy", "auto"])
def test_overflow_flag(overflow_case, impl):
    """The mesh-wide flag, inside the body (the reference's test) and
    through the wrapper; the compacted labels equal the reference's."""
    mask, want_lab, want_ovf = overflow_case
    pm = make_mesh(8, axis_names=("sp",), devices="cpu")
    got_lab, got_ovf = spmd.shard_map(
        lambda m: dc.sharded_label_components(m, axis_name="sp", axis_size=8, max_labels_per_shard=8,
                                              return_overflow=True, impl=impl),
        pm, P("sp"), (P("sp"), P()))(torch.from_numpy(mask))
    assert want_ovf and bool(got_ovf)
    np.testing.assert_array_equal(got_lab.numpy(), want_lab)
    _, ovf = distributed_connected_components(mask, pm, max_labels_per_shard=8, return_overflow=True, impl=impl)
    assert ovf is True
    _, ovf = distributed_connected_components(mask, pm, max_labels_per_shard=4096, return_overflow=True, impl=impl)
    assert ovf is False


def test_pair_dedup_branch_and_its_fallback(monkeypatch):
    """Faces of more than ``PAIR_CAP_FLOOR`` voxels engage the per-shard
    dedup; isolated columns give each shard more unique pairs than an
    eighth of its face, so with the floor lowered every shard takes the
    full-size fallback (chosen from the pmax-replicated count of unique
    pairs).  The dedup, the fallback and the merge without a dedup all
    equal the JAX package's labels (its default branch) bit for bit."""
    mask = random_blobs(np.random.default_rng(49), (8 * 4, 136, 136), p=0.45)
    mask[:, :, :100] = False
    mask[:, ::2, :100:2] = True  # 68 x 50 columns, each its own component a shard
    jm, pm = _meshes(("sp",))
    want = np.asarray(j_dcc(mask, jm, impl="legacy"))
    orig_pmax = dc._pmax_all
    counts = []

    def spy_pmax(v, axes):
        out = orig_pmax(v, axes)
        counts.append(int(out))
        return out

    monkeypatch.setattr(dc, "_pmax_all", spy_pmax)
    n_face = 136 * 136
    for floor in (dc.PAIR_CAP_FLOOR, 16, 1 << 30):
        monkeypatch.setattr(dc, "PAIR_CAP_FLOOR", floor)
        counts.clear()
        got = distributed_connected_components(mask, pm, impl="legacy").numpy()
        np.testing.assert_array_equal(got, want)
        if floor == 16384:  # every shard deduplicated, and all unique pairs fit
            assert len(counts) == 8 and len(set(counts)) == 1 and n_face // 8 < counts[0] <= 16384
        elif floor == 16:  # the replicated count exceeds the cap (an eighth of the face) on every shard
            assert len(counts) == 8 and len(set(counts)) == 1 and counts[0] > n_face // 8
        else:  # no dedup below the floor
            assert counts == []
    assert_labels_equivalent(want, _scipy(mask))


@pytest.mark.parametrize("sampling", [None, (3.0, 1.0, 1.5)])
def test_exact_edt_matches_reference_and_scipy(sampling):
    jm, pm = _meshes(("sp",))
    mask = np.random.default_rng(50).random((8 * 6, 12, 8 * 8)) < 0.97
    mask[0, 0, 0] = False
    got = distributed_distance_transform(mask, pm, sampling=sampling)
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_edt(mask, jm, sampling=sampling)))
    np.testing.assert_allclose(got.numpy(), ndimage.distance_transform_edt(mask, sampling=sampling),
                               rtol=1e-5, atol=1e-4)
    if sampling is None:
        sq = distributed_distance_transform_squared(mask, pm).numpy()
        np.testing.assert_array_equal(sq, np.round(ndimage.distance_transform_edt(mask) ** 2))


def test_capped_edt_matches_reference():
    jm, pm = _meshes(("sp",))
    mask = np.random.default_rng(51).random((8 * 6, 12, 8 * 8)) < 0.9
    got = distributed_distance_transform(mask, pm, max_distance=3.0).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_edt(mask, jm, max_distance=3.0)))
    want = ndimage.distance_transform_edt(mask)
    exact = want <= 3.0
    np.testing.assert_allclose(got[exact], want[exact], rtol=1e-5, atol=1e-4)
    assert (got[~exact] >= 3.0 - 1e-4).all()


@pytest.mark.parametrize("max_distance", [None, 2.0])
def test_two_axis_edt_matches_reference(max_distance):
    jm, pm = _meshes(("spz", "spy"))
    mask = np.random.default_rng(52).random((2 * 4, 4 * 4, 8 * 8)) < 0.95
    mask[0, 0, 0] = False
    kw = dict(sp_axis=("spz", "spy"), sampling=(2.0, 1.0, 1.0), max_distance=max_distance)
    got = distributed_distance_transform(mask, pm, **kw).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_edt(mask, jm, **kw)))
    if max_distance is None:
        np.testing.assert_allclose(got, ndimage.distance_transform_edt(mask, sampling=(2.0, 1.0, 1.0)),
                                   rtol=1e-5, atol=1e-4)
