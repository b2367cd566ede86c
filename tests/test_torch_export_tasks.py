"""``tasks/skeletons.py``, ``tasks/distances.py``,
``tasks/label_multisets.py``, ``tasks/paintera.py`` and
``tasks/debugging.py`` against the JAX package's ``local`` runs with zero
tolerance.

The five cases of the reference's ``tests/test_export_tasks.py`` run on
both packages on the same seeded numpy input: skeleton nodes, edges and
SWC text, pair distances, multiset CSR arrays and argmax datasets, the
paintera pyramid, label-to-block index and attributes (and the
BigDataViewer copy of it), and the debugging reports are equal bit for
bit.  Each case keeps the reference's own oracle check.  One more case
holds the multisets on a shape no factor divides (sentinel-padded cells):
the port builds each level's histograms for all cells at once where the
reference loops over cells.  The JAX runs are shared through a
module-scoped fixture.
"""

import importlib
import json
import os
import signal

import numpy as np
import pytest

from cluster_tools_tpu.runtime import supervision as jsup
from cluster_tools_tpu_torch.runtime import supervision as psup


@pytest.fixture(autouse=True, scope="module")
def _restore_drain_handlers():
    """Both packages' executors arm a SIGTERM/SIGUSR1 drain handler in the
    main thread and keep it: after this file's last case, restore both
    signals, both packages' armed flags and their drain latches, so a later
    file in this worker (the reference's preempt test above all) finds them
    as they were (ROADMAP fact 19)."""
    saved = {sig: signal.getsignal(sig) for sig in (signal.SIGTERM, signal.SIGUSR1)}
    flags = [(mod, mod._drain_installed) for mod in (jsup, psup)]
    yield
    for sig, handler in saved.items():
        signal.signal(sig, handler)
    for mod, flag in flags:
        mod._drain_installed = flag
        mod.reset_drain()


PKG = {"jax": "cluster_tools_tpu", "port": "cluster_tools_tpu_torch"}


def _mod(side, name):
    return importlib.import_module(f"{PKG[side]}.{name}")


def _reader(side):
    return _mod(side, "utils.volume_utils").file_reader


def _workspace(root):
    config_dir = os.path.join(root, "config")
    os.makedirs(config_dir, exist_ok=True)
    with open(os.path.join(config_dir, "global.config"), "w") as f:
        json.dump({"block_shape": [16, 16, 16]}, f)
    return dict(tmp_folder=os.path.join(root, "tmp"), config_dir=config_dir, max_jobs=2)


def _dataset(side, root, name, data, chunks=(16, 16, 16)):
    path = os.path.join(root, f"{name}.zarr")
    _reader(side)(path).require_dataset(name, shape=data.shape, chunks=chunks, dtype=str(data.dtype))[...] = data
    return path


def _build(side, *tasks):
    assert _mod(side, "runtime.task").build(list(tasks))


def _npz(path, prefix=""):
    with np.load(path) as f:
        return {prefix + k: f[k] for k in f.files}


def _text(path):
    return np.frombuffer(open(path, "rb").read(), np.uint8)


def _skeleton_tube(side, root):
    seg = np.zeros((8, 8, 48), np.uint64)
    seg[2:6, 2:6, 2:46] = 7
    path = _dataset(side, root, "seg", seg)
    ws = _workspace(root)
    sk = _mod(side, "tasks.skeletons")
    _build(side, sk.SkeletonWorkflow(**ws, target="local", input_path=path, input_key="seg", export_swc=True,
                                     link_radius=6.0, block_shape=[8, 8, 16]))
    d = sk.skeleton_dir(ws["tmp_folder"])
    return {**_npz(os.path.join(d, "7.npz")), "swc": _text(os.path.join(d, "7.swc"))}


def _distances(side, root):
    seg = np.zeros((16, 16, 48), np.uint64)
    seg[4:12, 4:12, 2:10] = 1
    seg[4:12, 4:12, 15:25] = 2   # gap of 5 voxels to object 1
    seg[4:12, 4:12, 44:47] = 3   # far from both
    path = _dataset(side, root, "seg", seg)
    ws = _workspace(root)
    dist = _mod(side, "tasks.distances")
    _build(side, dist.PairwiseDistanceWorkflow(**ws, target="local", input_path=path, input_key="seg",
                                               max_distance=8.0, block_shape=[16, 16, 16]))
    return _npz(dist.distances_path(ws["tmp_folder"]))


def _multiset_seg():
    return np.random.default_rng(0).integers(0, 5, (16, 16, 16)).astype(np.uint64)


def _odd_seg():
    """A shape no factor divides: sentinel-padded cells at every upper face."""
    return np.random.default_rng(1).integers(0, 4, (15, 13, 11)).astype(np.uint64)


def _multisets(side, root, seg=None, factor=(2, 2, 2), block=8):
    seg = _multiset_seg() if seg is None else seg
    path = _dataset(side, root, "seg", seg, chunks=(block,) * 3)
    ws = _workspace(root)
    ms = _mod(side, "tasks.label_multisets")
    s1 = [-(-n // f) for n, f in zip(seg.shape, factor)]
    t1 = ms.CreateMultisetLocal(**ws, input_path=path, input_key="seg", output_path=path, output_key="ms/s1",
                                scale_factor=list(factor), block_shape=[block] * 3)
    t2 = ms.DownscaleMultisetLocal(**ws, dependencies=[t1], level=1, level_shape=s1, output_path=path,
                                   output_key="ms/s2", scale_factor=list(factor), block_shape=[block] * 3)
    _build(side, t2)
    out = {}
    for level in (1, 2):
        d = ms.multiset_dir(ws["tmp_folder"], level)
        for fn in sorted(os.listdir(d)):
            out.update(_npz(os.path.join(d, fn), f"s{level}/{fn}/"))
    f = _reader(side)(path)
    for key in ("ms/s1", "ms/s2"):
        out[key] = f[key][...]
        out[key + "/attrs"] = np.asarray(json.dumps(dict(f[key].attrs), sort_keys=True))
    return out


def _paintera(side, root):
    seg = np.zeros((16, 32, 32), np.uint64)
    seg[:, :16, :] = 4
    seg[:, 16:, :16] = 9
    path = _dataset(side, root, "seg", seg)
    ws = _workspace(root)
    pt = _mod(side, "tasks.paintera")
    conv = pt.PainteraConversionWorkflow(**ws, target="local", input_path=path, input_key="seg", output_path=path,
                                         output_key_prefix="paintera", scale_factors=[[2, 2, 2]],
                                         resolution=[4.0, 4.0, 4.0], block_shape=[16, 16, 16])
    bdv_path = os.path.join(root, "bdv.n5")
    bdv = pt.PainteraToBdvWorkflow(**ws, target="local", dependencies=[conv], input_path=path, input_key="seg",
                                   input_key_prefix="paintera", output_path=bdv_path, scale_factors=[[2, 2, 2]],
                                   resolution=[4.0, 4.0, 4.0], block_shape=[16, 16, 16])
    _build(side, bdv)
    f, g = _reader(side)(path), _reader(side)(bdv_path)
    out = {"s1": f["paintera/s1"][...], **_npz(pt.label_to_blocks_path(ws["tmp_folder"]))}
    for k in ("maxId", "resolution", "offset"):
        out[f"seg/{k}"] = np.asarray(f["seg"].attrs[k])
    for level in (0, 1):
        ds = g[f"setup0/timepoint0/s{level}"]
        out[f"bdv/s{level}"] = ds[...]
        for k in ("downsamplingFactors", "resolution"):
            out[f"bdv/s{level}/{k}"] = np.asarray(ds.attrs[k])
    return out


def _debugging(side, root):
    rng = np.random.default_rng(21)
    seg = rng.integers(1, 9, (16, 16, 16)).astype(np.uint64)
    path = _dataset(side, root, "seg", seg)
    ws = _workspace(root)
    dbg, graph = _mod(side, "tasks.debugging"), _mod(side, "tasks.graph")
    g = graph.GraphWorkflow(**ws, target="local", input_path=path, input_key="seg", block_shape=[8, 8, 8])
    _build(side, dbg.CheckSubGraphsLocal(**ws, dependencies=[g], input_path=path, input_key="seg",
                                         block_shape=[8, 8, 8]))  # graphs fresh -> check passes
    report = os.path.join(ws["tmp_folder"], "check_sub_graphs.json")
    out = {"fresh": np.asarray(open(report).read())}
    # corrupt the segmentation -> stale graphs must be detected
    _reader(side)(path)["seg"][0:8, 0:8, 0:8] = np.uint64(77)
    _build(side, dbg.CheckSubGraphsLocal(**ws, input_path=path, input_key="seg", block_shape=[8, 8, 8],
                                         warn_only=True))
    out["stale"] = np.asarray(open(report).read())
    # block checker: NaNs flagged
    bad = rng.random((16, 16, 16)).astype(np.float32)
    bad[3, 3, 3] = np.nan
    path2 = _dataset(side, root, "raw", bad)
    _build(side, dbg.CheckBlocksLocal(**ws, input_path=path2, input_key="raw", block_shape=[8, 8, 8],
                                      warn_only=True))
    out["blocks"] = np.asarray(open(os.path.join(ws["tmp_folder"], "check_blocks.json")).read())
    return out


CASES = {"skeleton_tube": _skeleton_tube, "distances": _distances, "multisets": _multisets,
         "multisets_odd": lambda side, root: _multisets(side, root, _odd_seg(), (2, 3, 2), 4),
         "paintera": _paintera, "debugging": _debugging}


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX package's run of a case, once per module."""
    cache = {}

    def get(case):
        if case not in cache:
            cache[case] = CASES[case]("jax", str(tmp_path_factory.mktemp(f"jax-{case}")))
        return cache[case]

    return get


def _both(case, tmp_path, jax_run):
    got, want = CASES[case]("port", str(tmp_path)), jax_run(case)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    return got


def test_skeletonize_tube(tmp_path, jax_run):
    """Skeleton of a straight tube: nodes near the axis, spanning the tube,
    one SWC root."""
    out = _both("skeleton_tube", tmp_path, jax_run)
    nodes = out["nodes"]
    assert len(nodes) >= 3
    # medial nodes of a 4x4 tube lie near the (z, y) centre
    assert np.all(np.abs(nodes[:, 0] - 3.5) <= 1.6)
    assert np.all(np.abs(nodes[:, 1] - 3.5) <= 1.6)
    assert nodes[:, 2].max() - nodes[:, 2].min() > 30
    roots = [line for line in out["swc"].tobytes().decode().splitlines() if line.endswith(" -1")]
    assert len(roots) == 1


def test_pairwise_distances(tmp_path, jax_run):
    out = _both("distances", tmp_path, jax_run)
    table = {tuple(p): d for p, d in zip(out["pairs"], out["dists"])}
    # distance between boundary voxel centres: x=9 -> x=15
    np.testing.assert_allclose(table[(1, 2)], 6.0, atol=1e-6)
    # object 3 is farther than max_distance from everything
    assert (1, 3) not in table and (2, 3) not in table


def test_label_multisets_exact_counts(tmp_path, jax_run):
    out = _both("multisets", tmp_path, jax_run)
    # s2 multisets have exact label counts: cell (0,0,0) covers seg[0:4, 0:4, 0:4]
    offsets, labels, counts = (out[f"s2/block_0.npz/{k}"] for k in ("offsets", "labels", "counts"))
    want_u, want_c = np.unique(_multiset_seg()[0:4, 0:4, 0:4], return_counts=True)
    np.testing.assert_array_equal(labels[offsets[0]: offsets[1]], want_u)
    np.testing.assert_array_equal(counts[offsets[0]: offsets[1]], want_c)
    assert out["ms/s1"].shape == (8, 8, 8) and out["ms/s2"].shape == (4, 4, 4)


def test_label_multisets_odd_shape(tmp_path, jax_run):
    """Factors that divide no axis, blocks of 4 cells: every s1 block's
    label totals equal ``np.unique`` over its input window."""
    out = _both("multisets_odd", tmp_path, jax_run)
    seg, f = _odd_seg(), (2, 3, 2)
    assert out["ms/s1"].shape == (8, 5, 6) and out["ms/s2"].shape == (4, 2, 3)
    grid = (2, 2, 2)
    for b in range(8):
        lo = np.array(np.unravel_index(b, grid)) * 4
        window = seg[tuple(slice(a * k, (a + 4) * k) for a, k in zip(lo, f))]
        labels, counts = out[f"s1/block_{b}.npz/labels"], out[f"s1/block_{b}.npz/counts"]
        u, inv = np.unique(labels, return_inverse=True)
        want_u, want_c = np.unique(window, return_counts=True)
        np.testing.assert_array_equal(u, want_u)
        np.testing.assert_array_equal(np.bincount(inv.ravel(), weights=counts).astype(np.int64), want_c)


def test_paintera_conversion(tmp_path, jax_run):
    out = _both("paintera", tmp_path, jax_run)
    assert out["s1"].shape == (8, 16, 16)
    assert out["seg/maxId"] == 9 and out["seg/resolution"].tolist() == [4.0, 4.0, 4.0]
    np.testing.assert_array_equal(out["labels"], [4, 9])
    offsets, blocks = out["offsets"], out["blocks"]
    # label 4 occupies the y<16 half: blocks 0 and 1 (z=16, y=0:16, x 0/16)
    assert set(blocks[offsets[0]: offsets[1]].tolist()) == {0, 1}
    assert set(blocks[offsets[1]: offsets[2]].tolist()) == {2}
    np.testing.assert_array_equal(out["bdv/s1"], out["s1"])
    assert out["bdv/s1/downsamplingFactors"].tolist() == [2, 2, 2]
    assert out["bdv/s1/resolution"].tolist() == [8.0, 8.0, 8.0]


def test_debugging_checks(tmp_path, jax_run):
    out = _both("debugging", tmp_path, jax_run)
    assert json.loads(str(out["fresh"]))["violations"] == []
    assert len(json.loads(str(out["stale"]))["violations"]) >= 1
    assert any(v["error"] == "non-finite values" for v in json.loads(str(out["blocks"]))["violations"])
