"""All the voxels of the window's units over all the time of the window."""

from readers import voxels_per_s as read  # noqa: F401
