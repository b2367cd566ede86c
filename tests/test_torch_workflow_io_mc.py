"""The multicut chain (``MulticutSegmentationWorkflow`` with its own
watershed) read from the port's zarr and N5, with the chunk cache off and
on (see ``test_torch_workflow_io.py`` for the input and the arms).

Every port run writes the same watershed, graph and segmentation bit for
bit.  Against the JAX package's run the watershed and the graph files are
equal bit for bit and the segmentation is equal up to a bijection: the
chain's costs are held within 1e-3 of the reference's
(``test_torch_workflow_mc.py``), so the solver may number its segments
otherwise.
"""

import os

import numpy as np
import pytest

from .helpers import assert_labels_equivalent
from .test_torch_workflow_io import ARMS, _pin_modes, _read, all_runs, root  # noqa: F401


@pytest.fixture(scope="module")
def runs(root):  # noqa: F811
    return all_runs(root, ("mc",))


def _graph(d):
    gdir = os.path.join(d, "tmp", "graph")
    files = sorted(f for f in os.listdir(gdir) if f.startswith(("block_", "graph", "edge_ids_")))
    out = {}
    for name in files:
        a = np.load(os.path.join(gdir, name))
        out[name] = {k: a[k] for k in a.files} if name.endswith(".npz") else {None: a}
    return out


def test_multicut_chain_equal_across_formats_cache_and_reference(runs):
    ref = runs["mc"]["jax"]
    ref_ws, ref_seg, ref_graph = _read(ref, f"ws_{ref[1]}"), _read(ref), _graph(ref[0])
    first = runs["mc"][ARMS[0]]
    seg0 = _read(first)
    assert_labels_equivalent(seg0, ref_seg)
    assert len(np.unique(seg0)) > 1
    for arm in ARMS:
        run = runs["mc"][arm]
        np.testing.assert_array_equal(_read(run, f"ws_{run[1]}"), ref_ws, err_msg=str(arm))
        graph = _graph(run[0])
        assert sorted(graph) == sorted(ref_graph)
        for name, arrays in ref_graph.items():
            for k, v in arrays.items():
                np.testing.assert_array_equal(graph[name][k], v, err_msg=f"{arm} {name} {k}")
        np.testing.assert_array_equal(_read(run), seg0, err_msg=str(arm))
