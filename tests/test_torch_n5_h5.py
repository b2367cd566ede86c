"""The port's N5 (numpy + gzip/zlib) and HDF5 (h5py) containers against the
reference's: its ``ZarrContainer`` (tensorstore's N5) and its
``H5Container``.

Both ways, bit for bit: uint8, uint64 and float32; gzip and raw; region
writes spanning chunks and partial edge chunks; chunks never written
(N5 reads them as 0 whatever ``fill_value`` was asked for); the metadata
tensorstore writes for the same request; user attributes beside the
metadata; nested keys; zlib-framed gzip; and the edge blocks the port
writes truncated to the volume (the N5 specification) beside the
full-size ones tensorstore writes.  HDF5 likewise, its async calls
resolved futures, and its refusal without ``h5py``.
"""

import json
import struct
import sys

import numpy as np
import pytest

from cluster_tools_tpu.io.containers import H5Container as JH5
from cluster_tools_tpu.io.containers import ZarrContainer as JZarr
from cluster_tools_tpu_torch.io import chunk_cache
from cluster_tools_tpu_torch.io.containers import H5Container, ZarrContainer, open_container

SHAPE = (10, 7, 13)
CHUNKS = (4, 4, 8)
DTYPES = ("uint8", "uint64", "float32")
COMPRESSIONS = ("gzip", None)
# region writes spanning chunks, partial edge chunks and a plane; the chunks
# of the corner (z 0:4, y 0:4, x 0:8) stay unwritten
BOXES = ((slice(4, 9), slice(2, 7), slice(3, 13)), (slice(9, 10), slice(0, 3), slice(5, 13)),
         (slice(0, 4), slice(4, 7), slice(8, 13)))


@pytest.fixture(autouse=True)
def _fresh_cache():
    chunk_cache.configure(max_bytes=64 << 20)
    yield
    chunk_cache.configure()


def _data(dtype, seed=0):
    a = np.random.default_rng(seed).random(SHAPE) * 300
    if dtype == "uint64":
        return (a * 1e9).astype(np.uint64) + np.uint64(2**60)
    return a.astype(dtype)


def _writes(ds, a):
    """The boxes, then one line; what the dataset must hold (0 elsewhere)."""
    want = np.zeros(SHAPE, a.dtype)
    for bb in BOXES:
        ds[bb] = a[bb]
        want[bb] = a[bb]
    ds[6, 1:6, 2] = a[6, 1:6, 2]
    want[6, 1:6, 2] = a[6, 1:6, 2]
    return want


def _attrs(path, key):
    with open(path / key / "attributes.json") as f:
        return json.load(f)


@pytest.mark.parametrize("compression", COMPRESSIONS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_reference_reads_port_n5(tmp_path, dtype, compression):
    a = _data(dtype, seed=1)
    ds = ZarrContainer(str(tmp_path / "port.n5")).create_dataset(
        "g/x", shape=SHAPE, chunks=CHUNKS, dtype=dtype, compression=compression, fill_value=5)
    want = _writes(ds, a)
    np.testing.assert_array_equal(ds[...], want)
    got = JZarr(str(tmp_path / "port.n5"))["g/x"]
    assert tuple(got.shape) == SHAPE and tuple(got.chunks) == CHUNKS and np.dtype(got.dtype) == np.dtype(dtype)
    np.testing.assert_array_equal(np.asarray(got[...]), want)
    # the metadata tensorstore writes for the same request
    JZarr(str(tmp_path / "ref.n5")).create_dataset("g/x", shape=SHAPE, chunks=CHUNKS, dtype=dtype,
                                                   compression=compression or "raw")
    assert _attrs(tmp_path / "port.n5", "g/x") == _attrs(tmp_path / "ref.n5", "g/x")
    assert json.loads((tmp_path / "port.n5" / "attributes.json").read_text()) == {"n5": "2.0.0"}
    # the corner chunk was never written: no file, read as 0 on both sides
    assert not (tmp_path / "port.n5" / "g/x" / "0" / "0" / "0").exists()


@pytest.mark.parametrize("compression", COMPRESSIONS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_port_reads_reference_n5(tmp_path, dtype, compression):
    a = _data(dtype)
    ds = JZarr(str(tmp_path / "ref.n5")).create_dataset("g/x", shape=SHAPE, chunks=CHUNKS, dtype=dtype,
                                                         compression=compression or "raw")
    want = _writes(ds, a)
    got = open_container(str(tmp_path / "ref.n5"), "r")["g/x"]
    assert got.shape == SHAPE and got.chunks == CHUNKS and got.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(got[...], want)
    np.testing.assert_array_equal(got[3:8, 1, 2:12], want[3:8, 1, 2:12])
    np.testing.assert_array_equal(got.read_async((Ellipsis, 7)).result(), want[..., 7])


def _block_dims(path):
    raw = path.read_bytes()
    mode, nd = struct.unpack(">HH", raw[:4])
    return mode, struct.unpack(f">{nd}I", raw[4:4 + 4 * nd])


def test_edge_blocks_truncated_by_the_port_full_size_by_tensorstore(tmp_path):
    """The last block along z (10 = 4 + 4 + 2), y (7 = 4 + 3) and x (13 =
    8 + 5), fastest axis first in the header: the port stores (5, 3, 2),
    tensorstore (8, 4, 4); each side reads the other's."""
    a = _data("float32")
    for name, opener in (("port", ZarrContainer), ("ref", JZarr)):
        ds = opener(str(tmp_path / f"{name}.n5")).create_dataset("x", shape=SHAPE, chunks=CHUNKS, dtype="float32")
        ds[...] = a
    assert _block_dims(tmp_path / "port.n5" / "x" / "1" / "1" / "2") == (0, (5, 3, 2))
    assert _block_dims(tmp_path / "ref.n5" / "x" / "1" / "1" / "2") == (0, (8, 4, 4))
    assert _block_dims(tmp_path / "port.n5" / "x" / "0" / "0" / "0") == (0, (8, 4, 4))
    np.testing.assert_array_equal(np.asarray(JZarr(str(tmp_path / "port.n5"))["x"][...]), a)
    np.testing.assert_array_equal(ZarrContainer(str(tmp_path / "ref.n5"), "r")["x"][...], a)


def test_zlib_framed_gzip_both_ways(tmp_path):
    """``useZlib``: the blocks are bare zlib streams, not gzip members; the
    port writes them for such a dataset, and tensorstore reads them."""
    a = _data("uint8")
    ZarrContainer(str(tmp_path / "z.n5")).create_dataset("x", shape=SHAPE, chunks=CHUNKS, dtype="uint8")
    meta_path = tmp_path / "z.n5" / "x" / "attributes.json"
    meta = json.loads(meta_path.read_text())
    meta["compression"]["useZlib"] = True
    meta_path.write_text(json.dumps(meta))
    ZarrContainer(str(tmp_path / "z.n5"))["x"][...] = a
    payload = (tmp_path / "z.n5" / "x" / "0" / "0" / "0").read_bytes()[4 + 4 * 3:]
    assert payload[:1] == b"\x78"  # a zlib header, not a gzip member
    np.testing.assert_array_equal(np.asarray(JZarr(str(tmp_path / "z.n5"))["x"][...]), a)
    np.testing.assert_array_equal(ZarrContainer(str(tmp_path / "z.n5"), "r")["x"][...], a)


def test_attributes_share_the_metadata_file_both_ways(tmp_path):
    ds = ZarrContainer(str(tmp_path / "a.n5")).create_dataset("x", shape=SHAPE, chunks=CHUNKS, dtype="uint64")
    ds.update_attrs(resolution=[40, 4, 4], offset=np.int64(3))
    ref = JZarr(str(tmp_path / "a.n5"))["x"]
    assert ref.attrs["resolution"] == [40, 4, 4] and ref.attrs["offset"] == 3
    ref.update_attrs(maxId=17)
    again = ZarrContainer(str(tmp_path / "a.n5"))["x"]
    assert again.attrs["maxId"] == 17 and again.attrs["resolution"] == [40, 4, 4]
    assert again.attrs["dimensions"] == list(SHAPE[::-1]) and again.shape == SHAPE
    with pytest.raises(ValueError, match="metadata"):
        again.update_attrs(dimensions=[1, 1, 1])
    # the reference still opens it as the same dataset
    assert tuple(JZarr(str(tmp_path / "a.n5"))["x"].shape) == SHAPE


def test_zarr_attributes_both_ways(tmp_path):
    ds = ZarrContainer(str(tmp_path / "a.zarr")).create_dataset("x", shape=SHAPE, chunks=CHUNKS, dtype="uint8")
    ds.update_attrs(maxId=5)
    assert JZarr(str(tmp_path / "a.zarr"))["x"].attrs == {"maxId": 5}
    JZarr(str(tmp_path / "a.zarr"))["x"].update_attrs(unit="nm")
    assert ZarrContainer(str(tmp_path / "a.zarr"))["x"].attrs == {"maxId": 5, "unit": "nm"}


def test_n5_refusals(tmp_path):
    f = ZarrContainer(str(tmp_path / "r.n5"))
    with pytest.raises(ValueError, match="data type"):
        f.create_dataset("b", shape=SHAPE, chunks=CHUNKS, dtype="bool")
    with pytest.raises(NotImplementedError, match="compression"):
        f.create_dataset("c", shape=SHAPE, chunks=CHUNKS, dtype="uint8", compression="bzip2")
    JZarr(str(tmp_path / "r.n5")).create_dataset("bz", shape=SHAPE, chunks=CHUNKS, dtype="uint8",
                                                 compression="bzip2")
    with pytest.raises(NotImplementedError, match="bzip2"):
        ZarrContainer(str(tmp_path / "r.n5"))["bz"]
    with pytest.raises(KeyError):
        f["missing"]
    with pytest.raises(KeyError, match="group"):
        f[""]


@pytest.mark.parametrize("dtype", DTYPES)
def test_hdf5_both_ways(tmp_path, dtype):
    a = _data(dtype)
    with H5Container(str(tmp_path / "port.h5")) as f:
        ds = f.create_dataset("g/x", shape=SHAPE, chunks=CHUNKS, dtype=dtype)
        want = _writes(ds, a)
        ds.update_attrs(maxId=3)
        assert ds.write_async((slice(0, 1),) * 3, a[:1, :1, :1]).result() is None
        want[:1, :1, :1] = a[:1, :1, :1]
        np.testing.assert_array_equal(ds.read_async((Ellipsis,)).result(), want)
    with JH5(str(tmp_path / "port.h5"), "r") as f:
        got = f["g/x"]
        assert got.chunks == CHUNKS and got.attrs == {"maxId": 3}
        np.testing.assert_array_equal(got[...], want)
    with JH5(str(tmp_path / "ref.h5")) as f:
        want = _writes(f.create_dataset("x", shape=SHAPE, chunks=CHUNKS, dtype=dtype), _data(dtype, 2))
    with open_container(str(tmp_path / "ref.h5"), "r") as f:
        got = f["x"]
        assert got.shape == SHAPE and got.chunks == CHUNKS and got.dtype == np.dtype(dtype)
        np.testing.assert_array_equal(got[2:9, :, 4], want[2:9, :, 4])
        assert "x" in f and "y" not in f
    with H5Container(str(tmp_path / "ref.h5")) as f:
        with pytest.raises(ValueError, match="tile whole chunks"):
            f.require_dataset("x", shape=SHAPE, chunks=(2, 2, 2), dtype=dtype)


@pytest.mark.parametrize("path", ["v.hdf"])
def test_hdf5_refused_without_h5py(tmp_path, monkeypatch, path):
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        open_container(str(tmp_path / path))
