"""The mesh, the collectives and the pod with their shards or processes
dealt over several cards.

CPU part (no card): the grids ``chip_smoke.py --only multicard`` runs on
the cards, at a small volume against the JAX package's mesh of the same
shape on its virtual CPU devices: dp=1 x sp=4 in one process and over a
pod of 2 processes x 2 shards (gloo).  dp=2 x sp=4 is
``tests/test_torch_sharded_step.py``'s grid and is held there.  Then the
placement rules a multi-card machine takes: ``make_mesh`` deals a bare
``"cuda"`` over the cards, ``choose_backend``/``initialize`` give process
*i* card *i* over NCCL, each launch is counted on its card, and the smoke's
multicard arm refuses fewer than two cards.

``gpu`` part (two cards or more; skips otherwise): cross-card ``psum``,
``pmax``, ``ppermute``, ``all_gather`` and ``all_to_all``, the split step
over the cards, and small NCCL pods, each equal to the same mesh on one
card.  This file imports JAX only inside the CPU part's fixture, so the
card machine runs ``python3 -m pytest tests/test_torch_multicard.py -m
gpu`` without it (on four cards of one host).
"""

import json
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from cluster_tools_tpu_torch.ops import kernels as K
from cluster_tools_tpu_torch.parallel import multihost, spmd
from cluster_tools_tpu_torch.parallel.mesh import make_mesh, sibling_mesh
from cluster_tools_tpu_torch.parallel.multihost import ENV_DEMO, launch_workers
from cluster_tools_tpu_torch.parallel.pipeline import make_ws_ccl_step
from cluster_tools_tpu_torch.parallel.split_pipeline import make_ws_ccl_split
from cluster_tools_tpu_torch.utils.synthetic import synthetic_boundaries_np

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
MODES = {"CT_FILL_MODE": "capacity", "CT_SEED_CCL": "sparse", "CT_TIER_MODE": "cond"}
CFG = dict(halo=2, threshold=0.45, dt_max_distance=4.0, min_seed_distance=1.0, fill_mode="capacity",
           seed_mode="sparse", tier_mode="cond")


@pytest.fixture(scope="module")
def volume():
    return np.stack([synthetic_boundaries_np((32, 32, 128), seed=s, passes=3) for s in (0, 1)])


@pytest.fixture(scope="module")
def reference_1x4(volume):
    """The JAX package's fused step on its dp=1 x sp=4 mesh of four virtual
    CPU devices (``impl="xla"``, mode variables pinned)."""
    import jax
    import jax.numpy as jnp

    from cluster_tools_tpu.parallel import make_mesh as j_make_mesh
    from cluster_tools_tpu.parallel.pipeline import make_ws_ccl_step as j_make_step

    mesh = j_make_mesh(4, axis_names=("dp", "sp"), grid=(1, 4), devices=jax.devices("cpu")[:4])
    cfg = {k: v for k, v in CFG.items() if k not in ("fill_mode", "seed_mode", "tier_mode")}
    with pytest.MonkeyPatch.context() as mp:
        for k, v in MODES.items():
            mp.setenv(k, v)
        out = j_make_step(mesh, impl="xla", **cfg)(jnp.asarray(volume))
    return tuple(np.asarray(o) for o in out[:2]) + (float(out[2]), bool(out[3]))


def _assert_reference(ws, cc, n_fg, overflow, want, what):
    np.testing.assert_array_equal(np.asarray(ws), want[0], err_msg=f"{what}: ws")
    np.testing.assert_array_equal(np.asarray(cc), want[1], err_msg=f"{what}: cc")
    assert float(n_fg) == want[2], what
    assert bool(overflow) is want[3], what


@pytest.mark.parametrize("builder", ["fused", "split"])
def test_dp1_sp4_grid_matches_reference(volume, reference_1x4, builder):
    """The card arm's one-shard-a-card grid, in one process."""
    build = make_ws_ccl_step if builder == "fused" else make_ws_ccl_split
    mesh = make_mesh(4, grid=(1, 4), devices=["cpu"] * 4)
    ws, cc, n_fg, overflow = build(mesh, **CFG)(volume)
    _assert_reference(ws.numpy(), cc.numpy(), n_fg, overflow, reference_1x4, f"{builder} 1x4")


def test_two_process_pod_matches_reference(tmp_path, volume, reference_1x4):
    """The card arm's 2 processes x 2 shards pod (gloo on the CPU) equals the
    JAX package's 1 x 4 mesh; each worker reports its backend, no byte
    staged through host memory and a working collective probe."""
    np.save(tmp_path / "v.npy", volume)
    job = dict(volume=str(tmp_path / "v.npy"), cfg=CFG, out=str(tmp_path / "o.npz"))
    results = launch_workers(2, "cluster_tools_tpu_torch.parallel.multihost:ws_ccl_pod_demo",
                             devices_per_process=2, timeout=120, device="cpu", extra_env={ENV_DEMO: json.dumps(job)})
    for pid, (rc, out, err) in enumerate(results):
        assert rc == 0, f"worker {pid} failed:\n{err[-2000:]}"
        ok = next(ln for ln in out.splitlines() if ln.startswith("WS_CCL_POD_OK"))
        assert "backend=gloo" in ok and "host_staged_bytes=0 " in ok and "collectives_supported=True" in ok, ok
        counters = json.loads(next(ln for ln in out.splitlines() if ln.startswith("POD_COUNTERS "))[13:])
        assert counters["seeds"]["ppermute"]["bytes"] > 0
    pod = np.load(tmp_path / "o.npz")
    _assert_reference(pod["ws"], pod["cc"], pod["n_fg"], pod["overflow"], reference_1x4, "pod 2x2")


def _fake_cards(monkeypatch, n):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n)


def test_bare_card_deals_shards_over_the_cards(monkeypatch):
    """``"cuda"`` with no index is every card (the fused task's and the
    reduce plane's meshes); ``"cuda:0"`` keeps every shard on card 0."""
    _fake_cards(monkeypatch, 4)
    monkeypatch.delenv("CTT_MESH_SHARDS", raising=False)
    want = [torch.device("cuda", s % 4) for s in range(8)]
    assert make_mesh(8, grid=(2, 4)).devices == want
    assert make_mesh(8, grid=(2, 4), devices="cuda").devices == want
    assert make_mesh(8, devices="cuda:0").devices == [torch.device("cuda", 0)] * 8
    assert make_mesh(axis_names=("sp",), devices="cuda").devices == want[:4]
    assert sibling_mesh(devices=torch.device("cuda")).devices == want[:4]
    monkeypatch.setenv("CTT_MESH_SHARDS", "2")
    assert make_mesh(axis_names=("sp",), devices="cuda").devices == want[:2]
    assert make_mesh(4, devices="cpu").devices == [torch.device("cpu")] * 4


@pytest.mark.parametrize("n_proc,backend,card", [(4, "nccl", 2), (2, "nccl", 1), (5, "gloo", 0)])
def test_initialize_gives_process_i_card_i(monkeypatch, n_proc, backend, card):
    _fake_cards(monkeypatch, 4)
    calls = {}
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: calls.setdefault("device", torch.device(d)))
    fake_dist = types.SimpleNamespace(init_process_group=lambda *a, **kw: calls.setdefault("init", (a, kw)))
    monkeypatch.setitem(sys.modules, "torch.distributed", fake_dist)
    monkeypatch.setattr(torch, "distributed", fake_dist, raising=False)
    monkeypatch.setattr(multihost, "_POD", {})
    pid = min(card if backend == "nccl" else 3, n_proc - 1)
    assert multihost.initialize("127.0.0.1:1", n_proc, pid, device=None) == backend
    assert calls["device"] == torch.device("cuda", card if backend == "nccl" else 0)
    args, kw = calls["init"]
    assert args == (backend,) and kw["world_size"] == n_proc and kw["rank"] == pid
    assert kw["timeout"].total_seconds() == spmd.DEFAULT_DEADLINE_S
    assert multihost._POD == {"device": calls["device"], "backend": backend}


class _FakeLib:
    @staticmethod
    def ct_probe(*args):
        return 0


def test_launches_are_counted_on_their_card(monkeypatch):
    import contextlib

    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d: types.SimpleNamespace(cuda_stream=0))
    K.reset_counts()
    for card in (0, 2, 2, 3):
        K._launch("probe", torch.device("cuda", card), _FakeLib, "ct_probe")
    assert K.LAUNCHES["probe"] == 4
    assert dict(K.CARD_LAUNCHES) == {("probe", "cuda:0"): 1, ("probe", "cuda:2"): 2, ("probe", "cuda:3"): 1}
    K.reset_counts()
    assert not K.CARD_LAUNCHES


@pytest.mark.parametrize("cards", [0, 1])
def test_smoke_multicard_arm_refuses_fewer_than_two_cards(tmp_path, cards):
    """``chip_smoke.py --only multicard`` exits non-zero, with its reason,
    before it builds anything, and prints no result."""
    code = (
        "import runpy, sys, torch\n"
        f"torch.cuda.is_available = lambda: {bool(cards)}\n"
        f"torch.cuda.device_count = lambda: {cards}\n"
        "sys.argv = ['chip_smoke.py', '--only', 'multicard']\n"
        f"runpy.run_path({str(ROOT / 'chip_smoke.py')!r}, run_name='__main__')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert ("needs two cards or more; 1 visible" if cards else "no CUDA device") in out.stderr
    assert '"ok": true' not in out.stdout and "[build]" not in out.stdout


# ------------------------------------------------------------ on the cards ----


@pytest.fixture
def cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two cards or more")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _collectives(x):
    i = spmd.axis_index("sp")
    n = spmd.context().axis_size("sp")
    y = x * (i + 1) + torch.arange(x.numel(), device=x.device, dtype=x.dtype).reshape(x.shape)
    perm = [(s, (s + 1) % n) for s in range(n)]
    edge = [(s, s + 1) for s in range(n - 1)]
    return (spmd.psum(y, "sp"), spmd.pmax(y, "sp"), spmd.ppermute(y, "sp", perm), spmd.ppermute(y, "sp", edge),
            spmd.all_gather(y, "sp", tiled=True), spmd.all_to_all(y, "sp", 1, 0), y > 3)


@pytest.mark.gpu
def test_cross_card_collectives_equal_one_card(cards):
    n = 2 * len(cards)
    x = torch.arange(n * 4 * n * 3, dtype=torch.float32).reshape(n * 4, n, 3)
    outs = {}
    for where, devices in (("cards", None), ("one card", [cards[0]] * n)):
        mesh = make_mesh(n, axis_names=("sp",), devices=devices)
        body = spmd.shard_map(_collectives, mesh, spmd.P("sp"), (spmd.P("sp"),) * 7, name="multicard")
        outs[where] = [o.cpu() for o in body(x)]
    assert {str(d) for d in make_mesh(n, axis_names=("sp",)).devices} == {str(c) for c in cards}
    for a, b in zip(outs["cards"], outs["one card"]):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("builder", ["fused", "split"])
def test_step_over_the_cards_equals_one_card(cards, volume, builder):
    build = make_ws_ccl_step if builder == "fused" else make_ws_ccl_split
    K.reset_counts()
    got = build(make_mesh(8, grid=(2, 4)), **CFG)(volume)
    on_cards = {c for (_, c) in K.CARD_LAUNCHES}
    want = build(make_mesh(8, grid=(2, 4), devices=[cards[0]] * 8), **CFG)(volume)
    assert on_cards == {str(c) for c in cards}
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a.cpu(), b.cpu())
    assert got[3] is want[3] is False


@pytest.mark.gpu
@pytest.mark.parametrize("per", [1, 2])
def test_nccl_pod_equals_one_card(cards, tmp_path, volume, per):
    np.save(tmp_path / "v.npy", volume)
    job = dict(volume=str(tmp_path / "v.npy"), cfg=CFG, out=str(tmp_path / "o.npz"))
    results = launch_workers(2, "cluster_tools_tpu_torch.parallel.multihost:ws_ccl_pod_demo",
                             devices_per_process=per, timeout=300, extra_env={ENV_DEMO: json.dumps(job)})
    for pid, (rc, out, err) in enumerate(results):
        assert rc == 0, f"worker {pid} failed:\n{err[-3000:]}"
        assert "torch.distributed backend nccl" in err and f"device cuda:{pid}" in err, err[-2000:]
        ok = next(ln for ln in out.splitlines() if ln.startswith("WS_CCL_POD_OK"))
        assert "host_staged_bytes=0 " in ok and "collectives_supported=True" in ok, ok
    pod = np.load(tmp_path / "o.npz")
    ws, cc, n_fg, overflow = make_ws_ccl_split(make_mesh(2 * per, grid=(1, 2 * per), devices=[cards[0]] * (2 * per)),
                                               **CFG)(volume)
    np.testing.assert_array_equal(pod["ws"], ws.cpu().numpy())
    np.testing.assert_array_equal(pod["cc"], cc.cpu().numpy())
    assert float(pod["n_fg"]) == float(n_fg) and bool(pod["overflow"]) is overflow is False
