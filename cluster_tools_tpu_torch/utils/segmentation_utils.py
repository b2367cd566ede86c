"""Segmentation helpers: the multicut-solver registry.

Port of ``cluster_tools_tpu/utils/segmentation_utils.py``: every key maps
to its counterpart in :mod:`..ops.multicut` (GAEC, Kernighan-Lin, fusion
moves, the decomposition solver, greedy node moves) or to the round-based
engine of :mod:`..ops.contraction` (``gaec_parallel``,
``average_parallel``).  The engine's solvers (flag ``round_engine``) take
the solve's ``device``; the others run on the host.  Lifted solvers are
ROADMAP Queue A item 12.
"""

from __future__ import annotations

import numpy as np

from ..ops.contraction import average_parallel, gaec_parallel
from ..ops.multicut import decompose_solve, fusion_moves, greedy_additive, greedy_node_moves, kernighan_lin


def _solve_greedy(n_nodes, edges, costs, **kw):
    return greedy_additive(n_nodes, edges, costs, **kw)


def _solve_kl(n_nodes, edges, costs, **kw):
    return kernighan_lin(n_nodes, edges, costs, **kw)


def _solve_fm(n_nodes, edges, costs, **kw):
    return fusion_moves(n_nodes, edges, costs, **kw)


def _solve_decompose(n_nodes, edges, costs, **kw):
    return decompose_solve(n_nodes, edges, costs, **kw)


def _solve_node_moves(n_nodes, edges, costs, **kw):
    return greedy_node_moves(n_nodes, edges, costs, **kw)


def _solve_gaec_parallel(n_nodes, edges, costs, **kw):
    return gaec_parallel(n_nodes, edges, costs, **kw)


def _solve_average_parallel(n_nodes, edges, costs, **kw):
    # registry solvers speak signed costs; invert the probs_to_costs
    # transform (beta = 0.5) so the linkage engine sees probabilities --
    # cost 0 maps to p = 0.5, the default merge threshold (exact only for
    # unweighted beta = 0.5 costs)
    probs = 1.0 / (1.0 + np.exp(np.asarray(costs, np.float64)))
    return average_parallel(n_nodes, edges, probs, **kw)


# solvers that take a SolverCheckpoint and persist their partition between
# outer sweeps (the task layer passes one for the global solve)
_solve_kl.supports_checkpoint = True
# the round engine's solvers: they run on the solve's device (``device=``),
# and decide each contraction at the edge's endpoints only, so a disjoint
# union of problems solves as each problem alone
_solve_gaec_parallel.round_engine = True
_solve_average_parallel.round_engine = True


key_to_agglomerator = {
    "greedy-additive": _solve_greedy,
    "kernighan-lin": _solve_kl,
    "fusion-moves": _solve_fm,
    "decomposition": _solve_decompose,
    "greedy-node-moves": _solve_node_moves,
    "gaec_parallel": _solve_gaec_parallel,
    "average_parallel": _solve_average_parallel,
}


def get_multicut_solver(key: str):
    if "lifted" in key:
        raise NotImplementedError(f"lifted multicut solver {key!r} is not ported: ROADMAP Queue A item 12")
    try:
        return key_to_agglomerator[key]
    except KeyError:
        raise ValueError(f"unknown multicut solver {key!r}; available: {sorted(key_to_agglomerator)}")


def apply_size_filter(ids: np.ndarray, sizes: np.ndarray, size_threshold: int) -> np.ndarray:
    """Mask of segment ids whose size is below ``size_threshold``."""
    return ids[sizes < size_threshold]
