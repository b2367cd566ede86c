"""The two-pass watershed read from the port's zarr and N5, with the chunk
cache off and on: its files equal each other and the JAX package's bit for
bit (see ``test_torch_workflow_io.py`` for the input and the arms)."""

import pytest

from .test_torch_workflow_io import _pin_modes, all_runs, assert_files_equal, root  # noqa: F401


@pytest.fixture(scope="module")
def runs(root):  # noqa: F811
    return all_runs(root, ("ws2",))


def test_two_pass_files_equal_across_formats_cache_and_reference(runs):
    assert_files_equal(runs, "ws2")
