"""The grid cases of ``tests/test_torch_fused.py`` (``decomposition="grid"``:
the shards over z and y), the resume case and the refusal of extents that
do not divide, against the JAX package on its 8 CPU devices."""

import os

import numpy as np
import pytest

from cluster_tools_tpu_torch.runtime.task import build as p_build

from .test_torch_fused import _pin, _read, _run, check_equals_the_reference, root  # noqa: F401  (fixtures)


@pytest.mark.parametrize("execution", ["fused", "split"])
def test_fused_grid_task_equals_the_reference(root, execution):  # noqa: F811
    check_equals_the_reference(root, "grid", execution)


def test_fused_task_resume_is_a_noop(root):  # noqa: F811
    ok, task, path, tag = _run(root, "port", "grid", "split", cls="task", ws_key=None)
    assert ok
    first = _read("port", path, f"cc-{tag}")
    before = os.path.getmtime(task.output().path)
    assert p_build([type(task)(**{k: getattr(task, k) for k in ("tmp_folder", "config_dir", "max_jobs")},
                               **task.params)])
    assert os.path.getmtime(task.output().path) == before
    np.testing.assert_array_equal(_read("port", path, f"cc-{tag}"), first)


def test_fused_task_refuses_extents_that_do_not_divide(root, monkeypatch):  # noqa: F811
    monkeypatch.setenv("CTT_MESH_SHARDS", "3")
    ok, task, _path, _tag = _run(root, "port", "grid", "fused", cls="task", halo=1)
    assert not ok
    with pytest.raises(ValueError, match="do not divide"):
        task.run()
