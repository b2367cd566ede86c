"""The collective reduce plane on the card: a sibling mesh of 8 shards on
one device against the packet plane (on the card and on the CPU), bit for
bit, in both modes; and ``lane_frontier_rounds`` on CUDA lanes against the
same lanes on the CPU.  The CPU runs are held against the JAX package in
``tests/test_torch_reduce_plane.py``.

Torch only; every test is ``gpu``-marked and skips without a CUDA device.
Run on the card: ``python3 -m pytest tests/test_torch_reduce_card.py -m gpu``.
"""

import numpy as np
import pytest
import torch

from cluster_tools_tpu_torch.ops.contraction import lane_frontier_rounds
from cluster_tools_tpu_torch.parallel import reduce_tree as prt


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the collective reduce plane on the card")
    monkeypatch.setenv("CTT_MESH_SHARDS", "8")
    return torch.device("cuda")


def _grid_problem(g, seed, shards):
    """A grid RAG with noisy signed costs, Morton-sharded."""
    rng = np.random.default_rng(seed)
    ids = np.arange(g ** 3).reshape(g, g, g)
    edges = np.concatenate([np.stack([np.moveaxis(ids, ax, 0)[:-1].ravel(), np.moveaxis(ids, ax, 0)[1:].ravel()], 1)
                            for ax in range(3)])
    costs = rng.normal(0.2, 1.0, len(edges))
    pos = np.stack(np.unravel_index(np.arange(g ** 3), (g, g, g)), axis=1)
    return g ** 3, edges, costs, prt.morton_node_shards(pos, shards)


@pytest.mark.gpu
@pytest.mark.parametrize("mode,threshold", [("max", 0.0), ("min", 0.5)])
def test_collective_plane_on_the_card_equals_the_packet_plane(cuda, mode, threshold):
    n, edges, costs, node_shard = _grid_problem(24, 3, 8)
    payload = costs if mode == "max" else np.stack([np.abs(costs) * 3.0, np.full(len(costs), 3.0)], 1)
    kw = dict(fanout=2, mode=mode, threshold=threshold)
    want, _ = prt.sharded_solve(n, edges, payload, node_shard, reduce_plane="packet", device="cpu", **kw)
    host, _ = prt.sharded_solve(n, edges, payload, node_shard, reduce_plane="packet", device="cuda", **kw)
    snap = prt.solve_snapshot()
    got, info = prt.sharded_solve(n, edges, payload, node_shard, reduce_plane="collective", device="cuda", **kw)
    d = prt.solve_delta(snap)
    assert info["reduce_plane"] == "collective" and "degraded_plane" not in info
    assert d["collective_hops"] == len(info["levels"]) == 4 and d["packet_fallbacks"] == 0
    np.testing.assert_array_equal(host, want)
    np.testing.assert_array_equal(got, want)


@pytest.mark.gpu
def test_lane_frontier_rounds_on_the_card_equals_the_cpu(cuda):
    rng = np.random.default_rng(0)
    n_pad, we, wf = 4096, 32768, 8192
    for k, mode, thr in ((1, "max", 0.0), (2, "min", 0.5)):
        n_mem = 3000
        m, fm = 30000, 6000
        u, v = np.full(we, n_pad, np.int64), np.full(we, n_pad, np.int64)
        u[:m], v[:m] = rng.integers(0, n_mem, m), rng.integers(0, n_mem, m)
        fn, fg = np.full(wf, n_pad, np.int64), np.zeros(wf, np.int64)
        fn[:fm], fg[:fm] = rng.integers(0, n_mem, fm), rng.integers(0, 10 ** 6, fm)
        pay, fp = np.zeros((we, k)), np.zeros((wf, k))
        for p, c in ((pay, m), (fp, fm)):
            if k == 1:
                p[:c, 0] = rng.normal(0.2, 1.0, c)
            else:
                p[:c, 1] = rng.integers(1, 50, c)
                p[:c, 0] = rng.random(c) * p[:c, 1]
        args = [torch.from_numpy(a) for a in (u, v, pay, fn, fg, fp)]
        lc, rc = lane_frontier_rounds(*args, thr, n_pad=n_pad, mode=mode, k=k)
        lg, rg = lane_frontier_rounds(*[a.cuda() for a in args], thr, n_pad=n_pad, mode=mode, k=k)
        assert rg == rc > 0
        assert torch.equal(lg.cpu(), lc)
