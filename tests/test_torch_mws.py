"""The port's mutex watershed (``cluster_tools_tpu_torch/ops/mws.py``)
against the JAX package's (``cluster_tools_tpu/ops/mws.py``), on the CPU.

The same seeded affinities go through both packages: edge generation and
affinity values are equal, the Python constraint loop gives the same roots,
and ``mutex_watershed`` gives the same labels bit for bit on the host C++
rung of each package and on each one's Python path (``force_python``), with
and without strides (on a grid and at random), a mask, in 2-D and in 3-D.
"""

import numpy as np
import pytest

import cluster_tools_tpu.native as jnat
import cluster_tools_tpu.ops.mws as J
import cluster_tools_tpu_torch.native as pnat
import cluster_tools_tpu_torch.ops.mws as P

OFFSETS_3D = [[-1, 0, 0], [0, -1, 0], [0, 0, -1], [-4, 0, 0], [0, -4, 0], [0, 0, -4], [-3, 3, 3]]
OFFSETS_2D = [[-1, 0], [0, -1], [-3, 0], [0, -3], [-2, 2]]


def _affs(shape, offsets, seed):
    return np.random.default_rng(seed).random((len(offsets),) + tuple(shape)).astype(np.float32)


@pytest.mark.parametrize("shape,offsets", [((12, 14, 16), OFFSETS_3D), ((20, 18), OFFSETS_2D)])
def test_edges_and_values_equal(shape, offsets):
    for a, b in zip(P.offset_edges(shape, offsets), J.offset_edges(shape, offsets)):
        np.testing.assert_array_equal(a, b)
    affs = _affs(shape, offsets, 0)
    np.testing.assert_array_equal(P._affinity_values(affs, offsets), J._affinity_values(affs, offsets))


def test_python_constraint_loop_equal():
    shape = (10, 11, 12)
    affs = _affs(shape, OFFSETS_3D, 1)
    u, v, c = P.offset_edges(shape, OFFSETS_3D)
    order = np.argsort(-P._affinity_values(np.asarray(affs, np.float64), OFFSETS_3D), kind="stable")
    n = int(np.prod(shape))
    np.testing.assert_array_equal(P.python_constraint_loop(n, u, v, c < 3, order),
                                  J.python_constraint_loop(n, u, v, c < 3, order))


CASES = {
    "3d": dict(shape=(16, 16, 16), offsets=OFFSETS_3D),
    "3d-strides": dict(shape=(16, 16, 16), offsets=OFFSETS_3D, strides=[2, 2, 2]),
    "3d-random-strides": dict(shape=(16, 16, 16), offsets=OFFSETS_3D, strides=[2, 2, 2], randomize_strides=True,
                              seed=3),
    "3d-mask": dict(shape=(16, 16, 16), offsets=OFFSETS_3D, mask=True),
    "2d": dict(shape=(24, 24), offsets=OFFSETS_2D),
}


@pytest.mark.parametrize("rung", ["native", "python"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_mutex_watershed_equal(case, rung):
    kw = dict(CASES[case])
    shape, offsets = kw.pop("shape"), kw.pop("offsets")
    affs = _affs(shape, offsets, 7)
    if kw.pop("mask", False):
        kw["mask"] = np.random.default_rng(8).random(shape) < 0.8
    if rung == "native":
        pnat.reset_counts()
        got = P.mutex_watershed(affs, offsets, **kw)
        assert pnat.COUNTS["mutex_watershed"] == 1
        want = J.mutex_watershed(affs, offsets, **kw)
    else:
        with pnat.force_python(), jnat.force_python():
            got = P.mutex_watershed(affs, offsets, **kw)
            want = J.mutex_watershed(affs, offsets, **kw)
    assert got.dtype == np.int64 and got.shape == tuple(shape)
    np.testing.assert_array_equal(got, want)
    if "mask" in kw:
        assert (got[~kw["mask"]] == 0).all() and (got[kw["mask"]] > 0).all()
