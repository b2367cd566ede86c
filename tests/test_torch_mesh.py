"""The port's mesh and SPMD communicator against the JAX package's mesh and
``shard_map`` on the 8-device CPU mesh: grid factoring, the collectives,
halo exchange, ``neighbor_face``, the all-to-all reshard and
``relabel_consecutive``, all with zero tolerance; the replicated-output
fence, rendezvous deadlines and aborts; and the kernel counters and the
lazy build under threads."""

import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

from cluster_tools_tpu.compat import shard_map as j_shard_map
from cluster_tools_tpu.ops.ccl import relabel_consecutive as j_relabel
from cluster_tools_tpu.parallel import make_mesh as j_make_mesh
from cluster_tools_tpu.parallel.halo import exchange_halo as j_exchange_halo
from cluster_tools_tpu.parallel.halo import neighbor_face as j_neighbor_face
from cluster_tools_tpu.parallel.mesh import _pick_grid as j_pick_grid
from cluster_tools_tpu.parallel.reshard import transpose_sharding as j_transpose
from cluster_tools_tpu_torch import build
from cluster_tools_tpu_torch.ops import kernels as K
from cluster_tools_tpu_torch.ops.ccl import relabel_consecutive
from cluster_tools_tpu_torch.parallel import spmd
from cluster_tools_tpu_torch.parallel.halo import exchange_halo, neighbor_face
from cluster_tools_tpu_torch.parallel.mesh import _pick_grid, make_mesh, mesh_axis_sizes
from cluster_tools_tpu_torch.parallel.reshard import transpose_sharding
from cluster_tools_tpu_torch.parallel.spmd import P

torch.set_num_threads(1)


def _meshes(axes=("dp", "sp"), grid=None):
    jm = j_make_mesh(8, axis_names=axes, grid=grid, devices=jax.devices("cpu"))
    pm = make_mesh(8, axis_names=axes, grid=grid, devices=["cpu"] * 8)
    assert tuple(jm.devices.shape) == pm.grid
    return jm, pm


def test_pick_grid_matches_reference():
    for n in range(1, 17):
        for k in (1, 2, 3):
            assert _pick_grid(n, k) == j_pick_grid(n, k)


def test_make_mesh_layout_and_default_device(monkeypatch):
    mesh = make_mesh(8, devices=["cpu"] * 8)
    assert mesh.grid == (2, 4) and mesh_axis_sizes(mesh) == {"dp": 2, "sp": 4}
    assert [mesh.coords(s) for s in (0, 3, 4, 7)] == [(0, 0), (0, 3), (1, 0), (1, 3)]
    assert mesh.local_shards() == list(range(8)) and mesh.n_processes == 1
    assert make_mesh(6, axis_names=("sp",), devices="cpu").grid == (6,)
    with pytest.raises(ValueError):
        make_mesh(8, grid=(3, 3), devices="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()


def test_collectives_match_lax():
    """ppermute (zeros where nothing arrives), all_gather (stacked and
    tiled), psum, pmax and a tiled all_to_all, on a (dp, sp) = (2, 4) mesh."""
    jm, pm = _meshes()
    rng = np.random.default_rng(0)
    x = rng.integers(-50, 50, (2, 4 * 3, 8)).astype(np.int32)
    perm = [(0, 2), (2, 1), (1, 0)]  # rank 3 receives nothing

    def j_body(v):
        return (lax.ppermute(v, "sp", perm), lax.all_gather(v, "sp"), lax.all_gather(v, "sp", tiled=True),
                lax.psum(v, "sp"), lax.pmax(v, "dp"),
                lax.all_to_all(v, "sp", split_axis=2, concat_axis=1, tiled=True))

    spec = JP("dp", "sp")
    # gathered and reduced results vary over dp only: stack them along dp
    want = jax.jit(j_shard_map(j_body, mesh=jm, in_specs=spec,
                               out_specs=(spec, JP("dp"), JP("dp"), JP("dp"), JP(None, "sp"), spec),
                               check_vma=False))(jnp.asarray(x))

    def p_body(v):
        return (spmd.ppermute(v, "sp", perm), spmd.all_gather(v, "sp"), spmd.all_gather(v, "sp", tiled=True),
                spmd.psum(v, "sp"), spmd.pmax(v, "dp"), spmd.all_to_all(v, "sp", 2, 1))

    got = spmd.shard_map(p_body, pm, P("dp", "sp"),
                         (P("dp", "sp"), P("dp"), P("dp"), P("dp"), P(None, "sp"), P("dp", "sp")))(x)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


def test_axis_index_and_sharded_inputs():
    pm = make_mesh(8, devices="cpu")
    ranks = spmd.shard_map(lambda v: v + spmd.axis_index("sp") + 10 * spmd.axis_index("dp"), pm,
                           P("dp", "sp"), P("dp", "sp"))(torch.zeros(2, 4, dtype=torch.int64))
    assert ranks.tolist() == [[0, 1, 2, 3], [10, 11, 12, 13]]
    x = torch.arange(2 * 8 * 3).reshape(2, 8, 3)
    sh = spmd.shard(x, pm, P("dp", "sp"))
    assert sh.pieces[5].shape == (1, 2, 3) and torch.equal(sh.full(), x)
    back = spmd.shard_map(lambda v: v * 2, pm, P("dp", "sp"), P("dp", "sp"), keep_sharded=True)(sh)
    assert isinstance(back, spmd.Sharded) and torch.equal(back.full(), 2 * x)
    with pytest.raises(RuntimeError, match="only inside a shard_map"):
        spmd.psum(torch.ones(1), "sp")


@pytest.mark.parametrize("fill", [0, -1.0])
def test_exchange_halo_matches_pad_and_reference(fill):
    jm, pm = _meshes(("sp",))
    sp = 8
    z, halo = sp * 6, 2
    x = np.arange(z * 4 * 4, dtype=np.float32).reshape(z, 4, 4)
    want = np.asarray(j_shard_map(lambda v: j_exchange_halo(v, halo, 0, "sp", sp, fill=fill), mesh=jm,
                                  in_specs=JP("sp"), out_specs=JP("sp"))(x))
    got = spmd.shard_map(lambda v: exchange_halo(v, halo, 0, "sp", sp, fill=fill), pm, P("sp"), P("sp"))(x)
    np.testing.assert_array_equal(got.numpy(), want)
    # shard s holds rows [s*6-2, (s+1)*6+2), `fill` past the volume's ends
    slab = z // sp
    parts = []
    for s in range(sp):
        lo, hi = s * slab - halo, (s + 1) * slab + halo
        core = x[max(0, lo):min(z, hi)]
        parts.append(np.concatenate([np.full((max(0, -lo), 4, 4), fill, np.float32), core,
                                     np.full((max(0, hi - z), 4, 4), fill, np.float32)]))
    np.testing.assert_array_equal(got.numpy(), np.concatenate(parts))


def test_exchange_halo_two_axes_forwards_corners():
    """Two exchanges in a row on a (2, 4) decomposition: the corner halos
    arrive from the diagonal neighbour, as in the reference."""
    jm, pm = _meshes(("spz", "spy"))
    x = np.random.default_rng(1).random((2 * 5, 4 * 6, 7)).astype(np.float32)

    def body(v, ex, ctx_sizes):
        for a, name in ((0, "spz"), (1, "spy")):
            v = ex(v, 2, a, name, ctx_sizes[name], fill=1.0)
        return v

    sizes = {"spz": 2, "spy": 4}
    want = np.asarray(j_shard_map(lambda v: body(v, j_exchange_halo, sizes), mesh=jm, in_specs=JP("spz", "spy"),
                                  out_specs=JP("spz", "spy"))(x))
    got = spmd.shard_map(lambda v: body(v, exchange_halo, sizes), pm, P("spz", "spy"), P("spz", "spy"))(x)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("direction,fill", [(-1, 0), (1, 0), (-1, 7)])
def test_neighbor_face_matches_reference(direction, fill):
    jm, pm = _meshes(("dp", "sp"))
    x = np.random.default_rng(2).integers(1, 99, (2, 4 * 3, 5, 6)).astype(np.int32)
    spec = ("dp", "sp")
    want = np.asarray(j_shard_map(lambda v: j_neighbor_face(v, 1, "sp", 4, direction, fill), mesh=jm,
                                  in_specs=JP(*spec), out_specs=JP(*spec))(x))
    got = spmd.shard_map(lambda v: neighbor_face(v, 1, "sp", 4, direction, fill), pm, P(*spec), P(*spec))(x)
    np.testing.assert_array_equal(got.numpy(), want)


def test_reshard_axis_roundtrip_matches_reference():
    jm = j_make_mesh(4, axis_names=("sp",), devices=jax.devices("cpu"))
    pm = make_mesh(4, axis_names=("sp",), devices="cpu")
    vol = np.random.default_rng(3).random((8, 12, 16)).astype(np.float32)
    vz = jax.device_put(jnp.asarray(vol), NamedSharding(jm, JP("sp")))
    jx = j_transpose(vz, jm, "sp", from_axis=0, to_axis=2)
    px = transpose_sharding(vol, pm, "sp", from_axis=0, to_axis=2)
    assert {tuple(p.shape) for p in px.pieces.values()} == {s.data.shape for s in jx.addressable_shards} \
        == {(8, 12, 4)}
    for s in jx.addressable_shards:
        k = s.index[2].start // 4
        np.testing.assert_array_equal(px.pieces[k].numpy(), np.asarray(s.data))
    np.testing.assert_array_equal(px.full().numpy(), vol)
    back = transpose_sharding(px, pm, "sp", from_axis=2, to_axis=0)
    assert {tuple(p.shape) for p in back.pieces.values()} == {(2, 12, 16)}
    np.testing.assert_array_equal(back.full().numpy(), vol)
    np.testing.assert_array_equal(np.asarray(j_transpose(jx, jm, "sp", from_axis=2, to_axis=0)), vol)


@pytest.mark.parametrize("case", ["bitmap", "bitmap_bound", "sort", "overflow"])
def test_relabel_consecutive_matches_reference(case):
    rng = np.random.default_rng(4)
    labels = rng.choice(np.array([0, 3, 17, 17, 40, 99, 511], np.int32), size=(6, 7, 8))
    bound, cap = None, 64
    if case == "bitmap_bound":
        labels = labels * 3  # values up to 1533 > size 336: the bound keeps the bitmap path
        bound = 1533
    elif case == "sort":
        labels[0, 0, 0] = 100000  # above the default bound: the sort path
    elif case == "overflow":
        labels = rng.integers(0, 300, (6, 7, 8)).astype(np.int32)
        cap = 5
    want, n_want = j_relabel(jnp.asarray(labels), max_labels=cap, value_bound=bound)
    got, n_got = relabel_consecutive(torch.from_numpy(labels), max_labels=cap, value_bound=bound)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(n_got) == int(n_want) and got.dtype == torch.int32
    if case == "overflow":
        assert int(n_got) > cap and int(got.max()) == cap + 1


def test_replicated_output_fence():
    """A replicated output must agree on every shard: a reduced value passes,
    the un-reduced rank (the bug class the reference's fence guards) raises."""
    pm = make_mesh(8, axis_names=("sp",), devices="cpu")
    x = torch.arange(8, dtype=torch.float32)
    total = spmd.shard_map(lambda v: spmd.psum(v.sum(), "sp"), pm, P("sp"), P())(x)
    assert float(total) == 28.0
    with pytest.raises(spmd.ReplicationError, match="replicated output 0 differs"):
        spmd.shard_map(lambda v: torch.tensor(float(spmd.axis_index("sp"))), pm, P("sp"), P())(x)


def test_rendezvous_a_shard_never_reaches_raises_within_its_deadline(monkeypatch):
    pm = make_mesh(4, axis_names=("sp",), devices="cpu")
    monkeypatch.setattr(spmd, "DEFAULT_DEADLINE_S", 0.5)

    def body(v):
        if spmd.axis_index("sp") == 3:
            time.sleep(2.0)  # past the deadline, then returns without the psum
            return v
        return spmd.psum(v, "sp")

    t0 = time.monotonic()
    with pytest.raises(spmd.CollectiveTimeout, match=r"psum over axis 'sp'.*\[3\]"):
        spmd.shard_map(body, pm, P("sp"), P("sp"))(torch.ones(4))
    assert time.monotonic() - t0 < 10.0


def test_rendezvous_with_a_returned_shard_or_a_failed_shard_raises_at_once(monkeypatch):
    pm = make_mesh(4, axis_names=("sp",), devices="cpu")
    monkeypatch.setattr(spmd, "DEFAULT_DEADLINE_S", 60.0)

    def returns_early(v):
        if spmd.axis_index("sp") == 1:
            return v
        return spmd.pmax(v, "sp")

    t0 = time.monotonic()
    with pytest.raises(spmd.CollectiveError, match=r"shard\(s\) \[1\] returned without reaching it"):
        spmd.shard_map(returns_early, pm, P("sp"), P("sp"))(torch.ones(4))

    def fails(v):
        if spmd.axis_index("sp") == 2:
            raise ZeroDivisionError("shard two fails")
        return spmd.all_gather(v, "sp", tiled=True)

    with pytest.raises(ZeroDivisionError, match="shard two fails"):
        spmd.shard_map(fails, pm, P("sp"), P())(torch.ones(4))

    def mismatched(v):
        return spmd.psum(v, "sp") if spmd.axis_index("sp") else spmd.pmax(v, "sp")

    with pytest.raises(spmd.CollectiveError, match="same collectives in the same order"):
        spmd.shard_map(mismatched, pm, P("sp"), P("sp"))(torch.ones(4))
    assert time.monotonic() - t0 < 10.0


def test_counters_count_calls_bytes_and_waits():
    pm = make_mesh(8, devices="cpu")
    spmd.COUNTERS.reset()
    spmd.shard_map(lambda v: spmd.psum(spmd.ppermute(v, "sp", [(0, 1)]), "dp"), pm, P("dp", "sp"),
                   P("dp", "sp"), name="probe")(torch.zeros(2, 4, 3, dtype=torch.float32))
    snap = spmd.COUNTERS.snapshot()["probe"]
    # one ppermute per sp group (2 of them), one psum per dp group (4)
    assert snap["ppermute"]["calls"] == 2 and snap["psum"]["calls"] == 4
    assert snap["ppermute"]["bytes"] == 8 * 3 * 4 and snap["psum"]["bytes"] == 8 * 3 * 4
    assert snap["psum"]["wait_s"] >= 0.0


class _FakeLib:
    @staticmethod
    def ct_probe(*args):
        return 0


def test_kernel_counters_and_capture_under_threads(monkeypatch):
    """Many threads counting launches and rungs and recording captures
    lose nothing (the shards of a mesh run on threads)."""
    import contextlib
    import types

    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d: types.SimpleNamespace(cuda_stream=0))
    K.reset_counts()
    n_threads, per = 16, 400
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with K.capture_inputs() as captured:
            def work(i):
                t = torch.zeros(1)
                for _ in range(per):
                    K.count_rung("probe")
                    K._launch("probe", None, _FakeLib, "ct_probe")
                    K._record(f"k{i % 4}", (t,), {})
            threads = [threading.Thread(target=work, args=(i,)) for i in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert K.RUNGS["probe"] == n_threads * per and K.LAUNCHES["probe"] == n_threads * per
    assert len(captured) == n_threads * per
    K.reset_counts()


def test_lazy_build_runs_once_under_threads(monkeypatch):
    calls = []

    def fake_build():
        calls.append(threading.get_ident())
        time.sleep(0.05)
        for name in build.SOURCES:
            build._LIBS[name] = object()
        return {}

    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(build, "_build_all", fake_build)
    threads = [threading.Thread(target=build.library, args=(name,)) for name in list(build.SOURCES) * 3]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert len(calls) == 1
