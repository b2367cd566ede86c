"""The port's host C++ rung (``cluster_tools_tpu_torch/native.py`` over
``csrc/ct_native.cpp``) against the JAX package's (``cluster_tools_tpu.native``),
on the CPU, where ``g++`` builds it.

Mirrors ``tests/test_native.py``, ``tests/test_multicut.py::
test_kl_native_python_parity`` and ``tests/test_mws_stitching.py::
test_native_python_constraint_parity``: on seeded numpy inputs every
function of the port's library equals the reference's library bit for bit,
and equals the port's Python path where the reference's own tests hold
native == Python (GAEC by energy within 1e-6, the feature merge within rtol
1e-6, the EDT against scipy within rtol 1e-5, the MWS by partition: the
reference tests' own tolerances).  Also: a failed build raises and nothing
falls back, ``force_python()`` routes every caller to Python, eight threads
in ``parallel_contract`` at once give the serial labels, and the library
lands under ``.torch_ext/`` with no path under ``native/`` opened.
"""

import inspect
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import scipy.ndimage as ndi

import cluster_tools_tpu.native as jnat
import cluster_tools_tpu.ops.contraction as jcon
import cluster_tools_tpu.ops.multicut as jmc
import cluster_tools_tpu_torch.native as pnat
from cluster_tools_tpu.utils.synthetic import grid_rag
from cluster_tools_tpu_torch import build
from cluster_tools_tpu_torch.ops import contraction as pcon
from cluster_tools_tpu_torch.ops import multicut as pmc
from cluster_tools_tpu_torch.ops import mws as pmws
from cluster_tools_tpu_torch.ops import rag as prag
from cluster_tools_tpu_torch.ops.unionfind import union_find_host

ROOT = Path(__file__).resolve().parent.parent

pytestmark = pytest.mark.skipif(not jnat.available(), reason="the JAX package's native library is not built")


def _equal_tuple(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


# ---- union-find (tests/test_native.py:35) ----------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_union_find_parity(seed):
    rng = np.random.default_rng(seed)
    n = 500
    pairs = rng.integers(0, n, size=(800, 2)).astype(np.int64)
    got = pnat.union_find(pairs, n)
    np.testing.assert_array_equal(got, jnat.union_find(pairs, n))
    with pnat.force_python():
        np.testing.assert_array_equal(union_find_host(pairs, n), got)
    np.testing.assert_array_equal(union_find_host(pairs, n), got)


def test_union_find_ignores_out_of_range():
    pairs = np.array([[0, 1], [-1, 2], [3, 900]], np.int64)
    np.testing.assert_array_equal(pnat.union_find(pairs, 5), [0, 0, 2, 3, 4])
    np.testing.assert_array_equal(pnat.union_find(pairs, 5), jnat.union_find(pairs, 5))


# ---- GAEC (tests/test_native.py:51) ----------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_gaec_parity(seed):
    rng = np.random.default_rng(seed)
    n, m = 60, 250
    edges = rng.integers(0, n, size=(m, 2)).astype(np.int64)
    costs = rng.normal(size=m)
    got = pnat.greedy_additive(n, edges, costs)
    np.testing.assert_array_equal(got, jnat.greedy_additive(n, edges, costs))
    np.testing.assert_array_equal(pmc.greedy_additive(n, edges, costs), got)
    with pnat.force_python():
        want = pmc.greedy_additive(n, edges, costs)
    assert abs(pmc.multicut_energy(edges, costs, got) - pmc.multicut_energy(edges, costs, want)) < 1e-6
    assert got.min() == 0 and got.max() == len(np.unique(got)) - 1


# ---- the feature merge (tests/test_native.py:78) ---------------------------


def _feature_parts(seed=1):
    rng = np.random.default_rng(seed)
    table = np.unique(np.sort(rng.integers(1, 10**9, size=(40, 2)).astype(np.uint64), axis=1), axis=0)
    table = table[table[:, 0] != table[:, 1]]
    parts = []
    for _ in range(3):
        take = rng.random(len(table)) < 0.6
        k = int(take.sum())
        feats = np.stack([rng.random(k), rng.random(k), rng.random(k) + 1, rng.integers(1, 20, k).astype(float),
                          rng.random(k) * 0.1], axis=1).astype(np.float32)
        parts.append((table[take], feats))
    return table, parts


@pytest.mark.parametrize("seed", range(2))
def test_merge_edge_features_matches_python(seed):
    table, parts = _feature_parts(seed + 1)
    _equal_tuple(pnat.merge_edge_features(parts, table), jnat.merge_edge_features(parts, table))
    got = prag.merge_feature_lists(table, parts)
    with pnat.force_python():
        want = prag.merge_feature_lists(table, parts)
    np.testing.assert_allclose(got, want, rtol=1e-6)


# ---- the squared EDT and the flood (tests/test_native.py:122, :134, :150) --


@pytest.mark.parametrize("seed,sampling,cap", [(0, None, None), (1, (2.0, 1.0, 0.5), None), (2, None, 4.0),
                                               (3, (1.0, 3.0, 1.0), 5.0)])
def test_edt_sq_matches_scipy(seed, sampling, cap):
    fg = np.random.default_rng(seed).random((19, 23, 31)) < 0.7
    got = pnat.edt_sq(fg, sampling=sampling, cap=cap)
    np.testing.assert_array_equal(got, jnat.edt_sq(fg, sampling=sampling, cap=cap))
    want = ndi.distance_transform_edt(fg, sampling=sampling)
    if cap is not None:
        want = np.minimum(want, cap)
    np.testing.assert_allclose(got, (want * want).astype(np.float32), rtol=1e-5)


def test_edt_sq_degenerate_masks():
    np.testing.assert_array_equal(pnat.edt_sq(np.zeros((8, 9, 10), bool)), 0.0)
    fg = np.ones((8, 9, 10), bool)
    np.testing.assert_array_equal(pnat.edt_sq(fg, cap=3.0), 9.0)
    fg[4, 4, 4] = False
    got = pnat.edt_sq(fg)
    np.testing.assert_array_equal(got, jnat.edt_sq(fg))
    np.testing.assert_allclose(got, (ndi.distance_transform_edt(fg) ** 2).astype(np.float32), rtol=1e-5)


def _smooth(shape, seed):
    v = np.random.default_rng(seed).random(shape).astype(np.float32)
    for _ in range(6):
        for ax in range(3):
            v = (np.roll(v, 1, ax) + v + np.roll(v, -1, ax)) / 3
    return (v - v.min()) / (v.max() - v.min())


@pytest.mark.parametrize("seed", range(2))
def test_ws_flood_properties(seed):
    v = _smooth((24, 24, 24), seed)
    fg = v < 0.55
    dist = ndi.distance_transform_edt(fg)
    seeds, _ = ndi.label((ndi.maximum_filter(dist, size=3) == dist) & fg)
    hmap = np.clip(v * 255, 0, 255).astype(np.uint8)
    ws = pnat.ws_flood(hmap, fg, seeds.astype(np.int32))
    np.testing.assert_array_equal(ws, jnat.ws_flood(hmap, fg, seeds.astype(np.int32)))
    assert ws.shape == v.shape and ws.dtype == np.int32
    np.testing.assert_array_equal(ws[seeds > 0], seeds[seeds > 0])
    assert (ws[~fg] == 0).all()
    cc, _ = ndi.label(fg)
    seeded = np.isin(cc, np.unique(cc[seeds > 0])) & fg
    assert (ws[seeded] > 0).all() and (ws[fg & ~seeded] == 0).all()
    for lab in np.unique(ws[ws > 0])[:20]:
        assert ndi.label(ws == lab)[1] == 1


# ---- Kernighan-Lin (tests/test_multicut.py:245) ----------------------------


def _kl_problem(seed, n=60, m=220):
    r = np.random.default_rng(seed)
    edges = set()
    for _ in range(m):
        u, v = r.integers(0, n, 2)
        if u != v:
            edges.add((min(u, v), max(u, v)))
    edges = np.array(sorted(edges), np.int64)
    return n, edges, r.normal(0, 1, len(edges))


@pytest.mark.parametrize("seed", range(3))
def test_kl_native_python_parity(seed):
    n, edges, costs = _kl_problem(seed)
    init = pmc.greedy_additive(n, edges, costs)
    got = pnat.kernighan_lin(n, edges, costs, init)
    np.testing.assert_array_equal(got, jnat.kernighan_lin(n, edges, costs, init))
    got = pmc._relabel_consecutive(got)
    np.testing.assert_array_equal(got, pmc._kernighan_lin_python(n, edges, costs, init.copy()))
    assert pmc.multicut_energy(edges, costs, got) <= pmc.multicut_energy(edges, costs, init) + 1e-9


@pytest.mark.parametrize("checkpointed", [False, True])
def test_kl_entry_point_matches_reference(tmp_path, checkpointed):
    """Both branches of ``kernighan_lin`` on the native rung: one call, or
    one sweep a call with the partition saved between sweeps."""
    n, edges, costs = _kl_problem(7, n=200, m=1200)

    def ckpt(mod, name):
        return mod.SolverCheckpoint(str(tmp_path / name), edges, costs) if checkpointed else None

    pnat.reset_counts()
    got = pmc.kernighan_lin(n, edges, costs, checkpoint=ckpt(pmc, "p.npz"))
    assert pnat.COUNTS["kernighan_lin"] >= 1 and pnat.COUNTS["greedy_additive"] == 1
    np.testing.assert_array_equal(got, jmc.kernighan_lin(n, edges, costs, checkpoint=ckpt(jmc, "j.npz")))
    with pnat.force_python():
        np.testing.assert_array_equal(pmc.kernighan_lin(n, edges, costs, checkpoint=ckpt(pmc, "q.npz")), got)


# ---- the mutex watershed (tests/test_mws_stitching.py:186) -----------------


@pytest.mark.parametrize("seed", range(2))
def test_native_python_constraint_parity(seed):
    shape = (24, 24, 24)
    offsets = [[-1, 0, 0], [0, -1, 0], [0, 0, -1], [-4, 0, 0], [0, -4, 0], [0, 0, -4], [-3, 3, 3]]
    affs = np.random.default_rng(seed).random((len(offsets),) + shape).astype(np.float32)
    u, v, c = pmws.offset_edges(shape, offsets)
    w = pmws._affinity_values(np.asarray(affs, np.float64), offsets)
    att = c < 3
    order = np.argsort(-w, kind="stable")
    n = int(np.prod(shape))
    got = pnat.mutex_watershed(n, u, v, att, order)
    np.testing.assert_array_equal(got, jnat.mutex_watershed(n, u, v, att, order))
    py = pmws.python_constraint_loop(n, u, v, att, order)
    np.testing.assert_array_equal(np.unique(got, return_inverse=True)[1], np.unique(py, return_inverse=True)[1])


# ---- parallel contraction (ops/contraction.py's native rung) ---------------


def _contraction_cases():
    cases = {f"grid{s}": grid_rag(g=8, seed=s) for s in range(2)}
    n, edges, costs = grid_rag(g=6, seed=3)
    rng = np.random.default_rng(3)
    pick = rng.integers(0, len(edges), len(edges) // 3)
    cases["duplicates"] = (n, np.concatenate([edges, edges[pick][:, ::-1]]),
                           np.concatenate([costs, rng.normal(0.2, 1.0, len(pick))]))
    return cases


CONTRACTION_CASES = _contraction_cases()


@pytest.mark.parametrize("case", sorted(CONTRACTION_CASES))
def test_parallel_contract_matches_reference_and_numpy(case):
    n, edges, costs = CONTRACTION_CASES[case]
    got = pnat.parallel_contract(n, edges, costs.reshape(-1, 1), True, 0.0)
    np.testing.assert_array_equal(got, jnat.parallel_contract(n, edges, costs.reshape(-1, 1), True, 0.0))
    want = jcon.gaec_parallel(n, edges, costs, impl="numpy")
    np.testing.assert_array_equal(pcon.gaec_parallel(n, edges, costs, impl="native"), want)
    np.testing.assert_array_equal(pcon.gaec_parallel(n, edges, costs, impl="auto", device="cpu"), want)
    # average linkage: two payload columns, min mode
    probs = 1.0 / (1.0 + np.exp(costs))
    sizes = np.random.default_rng(0).integers(1, 5, len(costs)).astype(np.float64)
    np.testing.assert_array_equal(pcon.average_parallel(n, edges, probs, sizes, 0.5, impl="native"),
                                  jcon.average_parallel(n, edges, probs, sizes, 0.5, impl="native"))
    np.testing.assert_array_equal(pcon.average_parallel(n, edges, probs, sizes, 0.5, impl="native"),
                                  pcon.average_parallel(n, edges, probs, sizes, 0.5, impl="numpy"))


def test_parallel_contract_from_eight_threads_at_once():
    """The reduce tree's packet plane calls the host rung from 8 threads:
    concurrent calls give each problem its serial labels."""
    problems = [grid_rag(g=14, seed=s) for s in range(8)]
    serial = [pnat.parallel_contract(n, e, c.reshape(-1, 1), True, 0.0) for n, e, c in problems]
    with ThreadPoolExecutor(8) as pool:
        for _ in range(3):
            got = list(pool.map(lambda p: pnat.parallel_contract(p[0], p[1], p[2].reshape(-1, 1), True, 0.0),
                                problems))
            for a, b in zip(got, serial):
                np.testing.assert_array_equal(a, b)


# ---- no quiet fallback; force_python; counts --------------------------------


@pytest.mark.parametrize("compiler", ["/nonexistent/g++", "false"])
def test_a_failed_build_raises_and_nothing_falls_back(monkeypatch, tmp_path, compiler):
    monkeypatch.setattr(build, "CXX", compiler)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(pnat, "_lib", None)
    pairs = np.array([[0, 1]], np.int64)
    with pytest.raises(RuntimeError, match="build failed"):
        pnat.union_find(pairs, 2)
    with pytest.raises(RuntimeError, match="build failed"):
        union_find_host(pairs, 2)
    with pytest.raises(RuntimeError, match="build failed"):
        pcon.gaec_parallel(2, pairs, np.ones(1), impl="auto", device="cpu")
    with pytest.raises(RuntimeError, match="build failed"):
        pnat.available()
    # the oracle switch still reaches the Python paths
    with pnat.force_python():
        np.testing.assert_array_equal(union_find_host(pairs, 2), [0, 0])
    assert not list(tmp_path.glob("*.so"))


def _every_caller():
    """One call of each caller of the host rung, on small inputs."""
    from cluster_tools_tpu_torch.ops.host import host_dt_watershed
    from cluster_tools_tpu_torch.parallel.reduce_tree import _host_impl

    n, edges, costs = _kl_problem(0)
    union_find_host(edges[:10], n)
    pmc.greedy_additive(n, edges, costs)
    pmc.kernighan_lin(n, edges, costs)
    pcon.gaec_parallel(n, edges, costs, impl="auto", device="cpu")
    table, parts = _feature_parts()
    prag.merge_feature_lists(table, parts)
    host_dt_watershed(_smooth((12, 12, 12), 0), 0.5, dt_max_distance=4.0)
    pmws.mutex_watershed(np.random.default_rng(0).random((4, 6, 6, 6)), [[-1, 0, 0], [0, -1, 0], [0, 0, -1],
                                                                          [-2, 0, 0]])
    return _host_impl()


def test_force_python_routes_every_caller_to_python():
    pnat.reset_counts()
    with pnat.force_python():
        assert not pnat.available()
        assert _every_caller() == "numpy"
        assert pcon._resolve_impl("auto", "cpu") == "numpy"
    assert sum(pnat.COUNTS.values()) == 0, pnat.COUNTS
    assert _every_caller() == "native"
    # each function of the library ran once outside (KL's init is GAEC)
    assert pnat.COUNTS == {"union_find": 1, "greedy_additive": 2, "parallel_contract": 1, "kernighan_lin": 1,
                           "mutex_watershed": 1, "merge_edge_features": 1, "edt_sq": 1, "ws_flood": 1}, pnat.COUNTS


def test_library_lands_in_torch_ext_and_no_path_under_native_is_opened():
    """In a fresh process, every function of the port's library runs while
    an audit hook records each file opened and each library loaded."""
    # the callers' source without this module's reference imports
    helpers = "".join(inspect.getsource(f) for f in (_kl_problem, _feature_parts, _smooth, _every_caller))
    code = f"""
import json, os, sys
native_dir = os.path.join({str(ROOT)!r}, "native")
opened, loaded = [], []
def hook(event, args):
    if event in ("open", "ctypes.dlopen") and args and isinstance(args[0], (str, bytes, os.PathLike)):
        p = os.path.abspath(os.fsdecode(args[0]))
        (loaded if event == "ctypes.dlopen" else opened).append(p)
sys.addaudithook(hook)
import numpy as np
import cluster_tools_tpu_torch.native as pnat
from cluster_tools_tpu_torch.ops import contraction as pcon, multicut as pmc, mws as pmws, rag as prag
from cluster_tools_tpu_torch.ops.unionfind import union_find_host
{helpers}
_every_caller()
assert not any(m.split(".")[0] in ("jax", "cluster_tools_tpu") for m in sys.modules)
print(json.dumps(dict(under_native=[p for p in opened + loaded if p.startswith(native_dir + os.sep)],
                      loaded=loaded)))
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120,
                         env=env)
    assert out.returncode == 0, out.stderr
    doc = json.loads(out.stdout.strip().splitlines()[-1])
    assert doc["under_native"] == []
    ours = [p for p in doc["loaded"] if "ct_native" in os.path.basename(p)]
    assert ours == [str(build.host_library_path())], doc["loaded"]
    assert Path(ours[0]).parent == ROOT / ".torch_ext"
