"""The port's multicut solvers and registry (``ops/multicut.py``,
``ops/agglomeration.py``, ``utils/segmentation_utils.py``) against the JAX
package's, on the CPU.

Mirrors ``tests/test_multicut.py``: on identical ``(n_nodes, edges,
costs)`` every registry key must give the reference's labels exactly.  Both
packages run their Python paths (each one's ``native.force_python``); the
contraction rungs resolve to numpy there.  The host C++ solvers are held
against each other in ``tests/test_torch_native.py``.
"""

import numpy as np
import pytest
import torch

import cluster_tools_tpu.native as native
import cluster_tools_tpu_torch.native as pnative
import cluster_tools_tpu.ops.multicut as J
import cluster_tools_tpu_torch.ops.multicut as P
from cluster_tools_tpu.ops.agglomeration import average_agglomeration as j_average
from cluster_tools_tpu.utils.segmentation_utils import get_multicut_solver as j_solver
from cluster_tools_tpu.utils.synthetic import grid_rag
from cluster_tools_tpu_torch.ops.agglomeration import average_agglomeration as p_average
from cluster_tools_tpu_torch.utils.segmentation_utils import get_multicut_solver as p_solver
from cluster_tools_tpu_torch.utils.segmentation_utils import key_to_agglomerator

torch.set_num_threads(1)


def two_cliques(n_per=4, w_in=2.0, w_out=-1.0):
    edges, costs = [], []
    n = 2 * n_per
    for a in range(n):
        for b in range(a + 1, n):
            edges.append((a, b))
            costs.append(w_in if (a < n_per) == (b < n_per) else w_out)
    return n, np.array(edges), np.array(costs)


def random_problem(seed, n_nodes=60, n_edges=240):
    rng = np.random.default_rng(seed)
    e = rng.integers(0, n_nodes, (n_edges, 2))
    e = np.unique(np.sort(e[e[:, 0] != e[:, 1]], axis=1), axis=0)
    return n_nodes, e, rng.normal(0.3, 1.0, len(e))


INSTANCES = {
    "two_cliques": two_cliques,
    "random0": lambda: random_problem(0),
    "random1": lambda: random_problem(1, 120, 600),
    "grid": lambda: grid_rag(g=5, seed=2),
}


def _device_kw(fn):
    return {"device": "cpu"} if getattr(fn, "round_engine", False) else {}


@pytest.mark.parametrize("key", sorted(key_to_agglomerator))
@pytest.mark.parametrize("inst", sorted(INSTANCES))
def test_registry_solver_matches_reference(key, inst):
    n, edges, costs = INSTANCES[inst]()
    with native.force_python():
        want = j_solver(key)(n, edges, costs)
    fn = p_solver(key)
    with pnative.force_python():
        got = fn(n, edges, costs, **_device_kw(fn))
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    if getattr(fn, "round_engine", False):
        np.testing.assert_array_equal(fn(n, edges, costs, device="cpu", impl="torch"), want)


def test_solvers_beside_the_registry_match_reference():
    n, edges, costs = random_problem(4, 80, 400)
    with native.force_python():
        want_kl = J.kernighan_lin(n, edges, costs, init_labels=np.arange(n), max_outer=3)
        want_moves = J.greedy_node_moves(n, edges, costs, init_labels=np.zeros(n, np.int64), max_passes=3)
    with pnative.force_python():
        got_kl = P.kernighan_lin(n, edges, costs, init_labels=np.arange(n), max_outer=3)
    np.testing.assert_array_equal(got_kl, want_kl)
    np.testing.assert_array_equal(
        P.greedy_node_moves(n, edges, costs, init_labels=np.zeros(n, np.int64), max_passes=3), want_moves)
    lab = np.random.default_rng(0).integers(0, 9, n)
    for a, b in zip(P.contract_graph(edges, costs, lab), J.contract_graph(edges, costs, lab)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(P.contract_graph(np.zeros((0, 2), np.int64), np.zeros(0), lab),
                    J.contract_graph(np.zeros((0, 2), np.int64), np.zeros(0), lab)):
        np.testing.assert_array_equal(a, b)
    assert P.multicut_energy(edges, costs, lab) == J.multicut_energy(edges, costs, lab)


def test_average_agglomeration_matches_reference():
    n, edges, _ = grid_rag(g=6, seed=3)
    rng = np.random.default_rng(3)
    probs = rng.random(len(edges))
    sizes = rng.integers(1, 9, len(edges)).astype(np.float64)
    np.testing.assert_array_equal(p_average(n, edges, probs, sizes, 0.45), j_average(n, edges, probs, sizes, 0.45))


class _KillAfter(Exception):
    pass


class _KillingCheckpoint:
    """Wraps a checkpoint and dies after its ``die_after``-th save."""

    def __init__(self, inner, die_after):
        self.inner, self.die_after, self.saves = inner, die_after, 0

    def load(self):
        return self.inner.load()

    def save(self, labels, sweep, energy):
        self.inner.save(labels, sweep, energy)
        self.saves += 1
        if self.saves >= self.die_after:
            raise _KillAfter(f"preempted after persist #{self.saves}")


def test_kl_checkpoint_kill_and_resume(tmp_path):
    """Kill the checkpointed KL after its second save, resume, and end with
    the reference's uninterrupted labels."""
    n, e, c = random_problem(7, 200, 1200)
    with native.force_python():
        want = J.kernighan_lin(n, e, c, checkpoint=J.SolverCheckpoint(str(tmp_path / "ref.npz"), e, c))
    path = str(tmp_path / "kl.ckpt.npz")
    with pnative.force_python():
        with pytest.raises(_KillAfter):
            P.kernighan_lin(n, e, c, checkpoint=_KillingCheckpoint(P.SolverCheckpoint(path, e, c), die_after=2))
        resume = P.SolverCheckpoint(path, e, c)
        st = resume.load()
        assert st is not None and st[1] >= 1, "no persisted sweep to resume from"
        np.testing.assert_array_equal(P.kernighan_lin(n, e, c, checkpoint=resume), want)
    resume.clear()
    assert resume.load() is None
    # a checkpoint of another problem does not seed a resume
    P.SolverCheckpoint(path, e, c).save(np.zeros(n, np.int64), 3, -1.0)
    c2 = c.copy()
    c2[0] += 1.0
    assert P.SolverCheckpoint(path, e, c2).load() is None and P.SolverCheckpoint(path, e, c).load() is not None


def test_lifted_solver_key_is_refused():
    """The registry has no lifted key, as the reference's: the lifted tasks
    call the lifted GAEC themselves, and a lifted key raises the
    reference's ``ValueError``."""
    for key in ("lifted-greedy-additive", "no-such-solver"):
        with pytest.raises(ValueError, match="unknown multicut solver") as got:
            p_solver(key)
        with pytest.raises(ValueError, match="unknown multicut solver") as want:
            j_solver(key)
        assert str(got.value) == str(want.value)
