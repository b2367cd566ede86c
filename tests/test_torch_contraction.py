"""The port's contraction engine (``cluster_tools_tpu_torch/ops/contraction.py``)
against the JAX package's, on the CPU.

Mirrors ``tests/test_contraction.py``.  On the reference's own instances
(the impl-ladder parity ones, ties, duplicate input edges, average
linkage) the port's torch rung (on the CPU) and its numpy rung must give
the labels of the reference's ``impl="numpy"`` and ``impl="jax"`` rungs,
bit for bit.  The reference's rungs are pinned by name: its ``auto``
depends on the backend and the build.
"""

import numpy as np
import pytest
import torch

import cluster_tools_tpu.native as native
import cluster_tools_tpu.ops.contraction as J
import cluster_tools_tpu.ops.multicut as jmc
import cluster_tools_tpu_torch.ops.contraction as P
import cluster_tools_tpu_torch.ops.multicut as pmc
from cluster_tools_tpu.ops.agglomeration import average_agglomeration as j_average
from cluster_tools_tpu.utils.synthetic import grid_rag

torch.set_num_threads(1)


def planted(n_blobs=6, per=15, seed=0):
    """Well-separated planted partition (``tests/test_contraction.py``)."""
    rng = np.random.default_rng(seed)
    n = n_blobs * per
    blob = np.arange(n) // per
    pairs = []
    for b in range(n_blobs):
        base = b * per
        for i in range(per):
            pairs.append((base + i, base + (i + 1) % per))
        chord = rng.integers(0, per, (per, 2)) + base
        pairs.extend(map(tuple, chord[chord[:, 0] != chord[:, 1]]))
    cross = rng.integers(0, n, (3 * n, 2))
    cross = cross[blob[cross[:, 0]] != blob[cross[:, 1]]]
    pairs.extend(map(tuple, cross))
    edges = np.array(pairs, np.int64)
    intra = blob[edges[:, 0]] == blob[edges[:, 1]]
    costs = np.where(intra, rng.normal(2.0, 0.3, len(edges)), rng.normal(-2.0, 0.3, len(edges)))
    return n, edges, costs, blob


def _duplicated(seed=3):
    n, edges, costs = grid_rag(g=6, seed=seed)
    rng = np.random.default_rng(seed)
    pick = rng.integers(0, len(edges), len(edges) // 3)
    return n, np.concatenate([edges, edges[pick][:, ::-1]]), np.concatenate([costs, rng.normal(0.2, 1.0, len(pick))])


def _average_instance():
    n, edges, _ = grid_rag(g=8, seed=1)
    rng = np.random.default_rng(1)
    probs = rng.integers(1, 64, len(edges)) / 64.0
    sizes = rng.integers(1, 5, len(edges)).astype(np.float64)
    return n, edges, probs, sizes


GAEC_CASES = {
    **{f"grid{s}": (lambda s=s: grid_rag(g=8, seed=s)) for s in range(3)},
    "duplicates": _duplicated,
    "ties": lambda: (6, np.array([[i, (i + 1) % 6] for i in range(6)]), np.ones(6)),
    "net_repulsive_pair": lambda: (2, np.array([[0, 1], [1, 0]]), np.array([1.0, -2.0])),
    "net_attractive_pair": lambda: (2, np.array([[0, 1], [1, 0]]), np.array([-1.0, 2.0])),
    "planted": lambda: planted(seed=1)[:3],
}


@pytest.mark.parametrize("case", sorted(GAEC_CASES))
def test_gaec_rungs_match_reference_rungs(case):
    n, edges, costs = GAEC_CASES[case]()
    want = J.gaec_parallel(n, edges, costs, impl="numpy")
    np.testing.assert_array_equal(J.gaec_parallel(n, edges, costs, impl="jax"), want)
    for impl in ("numpy", "torch"):
        got = P.gaec_parallel(n, edges, costs, impl=impl, device="cpu")
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, want, err_msg=impl)
    np.testing.assert_array_equal(P.gaec_parallel(n, edges, costs, impl="auto", device="cpu"), want)


@pytest.mark.parametrize("threshold", [0.4, 0.5])
def test_average_rungs_match_reference_rungs(threshold):
    n, edges, probs, sizes = _average_instance()
    want = J.average_parallel(n, edges, probs, sizes, threshold, impl="numpy")
    np.testing.assert_array_equal(J.average_parallel(n, edges, probs, sizes, threshold, impl="jax"), want)
    for impl in ("numpy", "torch"):
        np.testing.assert_array_equal(
            P.average_parallel(n, edges, probs, sizes, threshold, impl=impl, device="cpu"), want, err_msg=impl)


@pytest.mark.parametrize("seed", range(3))
def test_average_and_heap_on_unambiguous(seed):
    n, edges, _, blob = planted(seed=seed)
    rng = np.random.default_rng(seed)
    probs = np.where(blob[edges[:, 0]] == blob[edges[:, 1]], rng.uniform(0.05, 0.2, len(edges)),
                     rng.uniform(0.8, 0.95, len(edges)))
    sizes = rng.integers(1, 5, len(edges)).astype(np.float64)
    want = j_average(n, edges, probs, sizes, 0.5)
    np.testing.assert_array_equal(P.average_parallel(n, edges, probs, sizes, 0.5, impl="torch", device="cpu"), want)
    np.testing.assert_array_equal(P.average_parallel(n, edges, probs, sizes, 0.5, impl="heap"), want)
    with native.force_python():
        np.testing.assert_array_equal(P.gaec_parallel(n, edges, planted(seed=seed)[2], impl="heap"),
                                      jmc.greedy_additive(n, edges, planted(seed=seed)[2]))


@pytest.mark.parametrize("seed", range(2))
def test_numpy_rung_energy_within_2pct_of_heap(seed):
    n, edges, costs = grid_rag(g=10, seed=seed)
    e_par = pmc.multicut_energy(edges, costs, P.gaec_parallel(n, edges, costs, impl="torch", device="cpu"))
    e_heap = pmc.multicut_energy(edges, costs, pmc.greedy_additive(n, edges, costs))
    assert e_par <= e_heap + 0.02 * abs(e_heap)


def test_trivial_cases_and_counters():
    assert len(P.gaec_parallel(0, np.zeros((0, 2)), np.zeros(0))) == 0
    np.testing.assert_array_equal(P.gaec_parallel(3, np.zeros((0, 2), np.int64), np.zeros(0)), [0, 1, 2])
    for impl in ("numpy", "torch"):
        lab = P.gaec_parallel(3, np.array([[0, 1], [1, 2]]), np.array([-1.0, -2.0]), impl=impl, device="cpu")
        np.testing.assert_array_equal(lab, [0, 1, 2])
        lab = P.gaec_parallel(2, np.array([[0, 0], [0, 1]]), np.array([5.0, 1.0]), impl=impl, device="cpu")
        np.testing.assert_array_equal(lab, [0, 0])
    snap = P.solver_snapshot()
    n, edges, costs = grid_rag(g=6, seed=0)
    P.gaec_parallel(n, edges, costs, impl="torch", device="cpu")
    d = P.solver_delta(snap)
    assert d["solver_calls"] == 1 and d["solver_rounds"] > 0 and d["solver_edges_in"] == len(edges)


def test_the_torch_rung_is_deterministic():
    n, edges, costs = _duplicated(seed=5)
    first = P.gaec_parallel(n, edges, costs, impl="torch", device="cpu")
    for _ in range(2):
        np.testing.assert_array_equal(P.gaec_parallel(n, edges, costs, impl="torch", device="cpu"), first)


def test_sum_by_key_matches_reference():
    rng = np.random.default_rng(0)
    key = rng.integers(0, 40, 500)
    pay = rng.normal(size=(500, 2))
    for a, b in zip(P.sum_by_key(key, pay), J.sum_by_key(key, pay)):
        np.testing.assert_array_equal(a, b)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the torch rung on the card")
    return torch.device("cuda")


def _many_parallel(n=60, m=20000, seed=9):
    """Few nodes, many edges: groups of tens of parallel rows to merge."""
    rng = np.random.default_rng(seed)
    edges = rng.integers(0, n, (m, 2))
    return n, edges, rng.normal(0.0, 1.0, m)


@pytest.mark.gpu
def test_cuda_torch_rung_sums_and_labels_equal_the_numpy_rung(cuda):
    """The parallel-edge sums on the card are :func:`sum_by_key`'s bit for
    bit (groups of 4 and more rows, where a tree order would differ), and
    the torch rung on the card gives the numpy rung's labels."""
    n, edges, costs = _many_parallel()
    pay = np.stack([costs, np.abs(costs) + 0.5], 1)
    want = P._canonical_edges(n, edges, pay)
    e = torch.from_numpy(edges).to(cuda)
    got = P._canonical_edges_torch(n, e[:, 0], e[:, 1], torch.from_numpy(pay).to(cuda))
    assert np.median(np.unique(np.sort(edges, 1), axis=0, return_counts=True)[1]) >= 4
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.cpu().numpy(), b)
    for n, edges, costs in (_many_parallel(seed=10), _duplicated(seed=5), planted(seed=1)[:3]):
        np.testing.assert_array_equal(P.gaec_parallel(n, edges, costs, impl="torch", device=cuda),
                                      P.gaec_parallel(n, edges, costs, impl="numpy"))
    n, edges, probs, sizes = _average_instance()
    np.testing.assert_array_equal(P.average_parallel(n, edges, probs, sizes, 0.5, impl="torch", device=cuda),
                                  P.average_parallel(n, edges, probs, sizes, 0.5, impl="numpy"))


def test_refusals():
    n, edges, costs = grid_rag(g=4, seed=0)
    with pytest.raises(NotImplementedError, match="item 13"):
        P.gaec_parallel(n, edges, costs, impl="native")
    with pytest.raises(NotImplementedError, match="item 13"):
        P.average_parallel(n, edges, costs, impl="native", device="cpu")
    with pytest.raises(ValueError, match="mode"):
        P.parallel_contraction(2, np.array([[0, 1]]), np.ones((1, 1)), "sideways", 0.0)
    with pytest.raises(ValueError, match="unknown impl"):
        P.gaec_parallel(n, edges, costs, impl="jax", device="cpu")


@pytest.mark.parametrize("impl", ["numpy", "torch"])
def test_disjoint_union_solves_as_its_parts(impl):
    """The round engine decides at an edge's endpoints only: a disjoint
    union of problems (``SolveSubproblems`` batches its blocks so) gives
    each part the partition of its own solve."""
    parts = [grid_rag(g=5, seed=s) for s in range(3)] + [_duplicated(seed=4)]
    offsets = np.cumsum([0] + [p[0] for p in parts])
    union = P.gaec_parallel(int(offsets[-1]), np.concatenate([e + o for (_, e, _), o in zip(parts, offsets)]),
                            np.concatenate([c for _, _, c in parts]), impl=impl, device="cpu")
    for (n, edges, costs), o in zip(parts, offsets):
        alone = J.gaec_parallel(n, edges, costs, impl="numpy")
        _, got = np.unique(union[o:o + n], return_inverse=True)
        np.testing.assert_array_equal(got, alone)
