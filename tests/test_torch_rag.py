"""The port's RAG extraction (``cluster_tools_tpu_torch/ops/rag.py``)
against the JAX package's, on the CPU.

Mirrors ``tests/test_rag.py``: seeded label blocks (numpy) go through both
packages; ``uv``, ``sizes``, ``nodes``, counts, min and max must be equal,
the mean within rtol 1e-5 a block and 1e-4 after the merge, the variance
within rtol 1e-2, and the fused costs within rtol 1e-3, atol 1e-4 -- the
reference tests' own tolerances.  The reference's feature merge runs its
Python path (``native.force_python``), the only one the port carries.
"""

import numpy as np
import pytest
import torch

import cluster_tools_tpu.native as native
import cluster_tools_tpu.ops.rag as J
import cluster_tools_tpu_torch.ops.rag as P

torch.set_num_threads(1)


def random_seg(rng, shape, n_labels=6, p_bg=0.2):
    seg = rng.integers(1, n_labels + 1, size=shape).astype(np.uint64)
    seg[rng.random(shape) < p_bg] = 0
    return seg


def _blocks(seg, vals, bs):
    """Per-block ``block_rag`` inputs with the +1 upper halo."""
    for begin in np.ndindex(*[-(-s // b) for s, b in zip(seg.shape, bs)]):
        bb = tuple(slice(p * b, min(p * b + b + 1, s)) for p, b, s in zip(begin, bs, seg.shape))
        inner = tuple(min(b, s - p * b) for p, b, s in zip(begin, bs, seg.shape))
        yield seg[bb], vals[bb], inner


def _assert_rag_equal(got, want, mean_rtol=1e-5):
    uv, sizes, feats = got[:3]
    np.testing.assert_array_equal(uv, want[0])
    assert uv.dtype == np.uint64 and sizes.dtype == np.int64
    np.testing.assert_array_equal(sizes, want[1])
    if want[2] is None:
        assert feats is None
        return
    np.testing.assert_array_equal(feats[:, 1:4], want[2][:, 1:4])
    np.testing.assert_allclose(feats[:, 0], want[2][:, 0], rtol=mean_rtol)
    np.testing.assert_allclose(feats[:, 4], want[2][:, 4], rtol=1e-2, atol=1e-6)


@pytest.mark.parametrize("shape,labels,inner", [
    ((7, 8, 9), 6, None), ((24, 32, 40), 50, (20, 30, 36)), ((9, 10, 11), 3000, (8, 9, 10)),
])
def test_block_rag_matches_reference(shape, labels, inner):
    rng = np.random.default_rng(sum(shape))
    seg = random_seg(rng, shape, n_labels=labels)
    seg = seg * np.uint64(977) + (seg > 0) * np.uint64(12345)
    vals = rng.random(shape).astype(np.float32)
    for values in (vals, None):
        want = J.block_rag(seg, values, inner_shape=inner, return_nodes=True)
        got = P.block_rag(seg, values, inner_shape=inner, return_nodes=True, device="cpu")
        _assert_rag_equal(got, want)
        np.testing.assert_array_equal(got[3], want[3])
        assert got[3].dtype == want[3].dtype


def test_block_rag_sums_in_the_reference_order():
    """The mean is the reference's bit for bit: both sum an edge's pairs in
    float32 in the stable (axis, C) order."""
    rng = np.random.default_rng(5)
    seg = random_seg(rng, (20, 21, 22), n_labels=40)
    vals = rng.random(seg.shape).astype(np.float32)
    want = J.block_rag(seg, vals)
    got = P.block_rag(seg, vals, device="cpu")
    np.testing.assert_array_equal(got[2][:, :4], want[2][:, :4])


def test_block_rag_2d_and_empty():
    rng = np.random.default_rng(1)
    seg = random_seg(rng, (12, 13))
    _assert_rag_equal(P.block_rag(seg, device="cpu"), J.block_rag(seg))
    uv, sizes, _ = P.block_rag(np.zeros((4, 4, 4), np.uint64), device="cpu")
    assert uv.shape == (0, 2) and sizes.shape == (0,)
    _, _, feats = P.block_rag(np.zeros((4, 4, 4), np.uint64), np.ones((4, 4, 4), np.float32), device="cpu")
    assert feats.shape == (0, 5)


def test_host_oracle_matches_reference_host_path():
    # (the reference's host path scans through 32-bit JAX arrays: labels
    # below 2^32 here; the port's oracle is plain numpy and takes any)
    rng = np.random.default_rng(2)
    seg = random_seg(rng, (16, 17, 18), n_labels=30) * np.uint64(977)
    vals = rng.random(seg.shape).astype(np.float32)
    for inner in ((16, 17, 18), (12, 15, 16)):
        got = P._block_rag_host(seg, vals, inner)
        want = J._block_rag_host(seg, vals, inner)
        _assert_rag_equal(got, want)
        np.testing.assert_allclose(got[2], want[2], rtol=1e-5, atol=1e-6)
        # the device path equals the host oracle (the reference's own check),
        # also with labels above 2^32
        _assert_rag_equal(P.block_rag(seg, vals, inner_shape=inner, device="cpu"), got)
        big = seg * np.uint64(2**33)
        _assert_rag_equal(P.block_rag(big, vals, inner_shape=inner, device="cpu"),
                          P._block_rag_host(big, vals, inner))


def _above_2_63(rng, shape):
    seg = random_seg(rng, shape, n_labels=20) + np.uint64(2**63)
    seg[seg == np.uint64(2**63)] = 0
    seg[0, 0, :3] = (np.uint64(5), np.uint64(2**64 - 1), np.uint64(2**63 - 1))
    return seg


def test_labels_above_2_63_densify_on_the_device():
    """The device densify orders uint64 labels as unsigned, also those of
    2^63 or more (negative as int64), and keeps 0 in slot 0."""
    rng = np.random.default_rng(3)
    seg = _above_2_63(rng, (8, 9, 10))
    vals = rng.random(seg.shape).astype(np.float32)
    _assert_rag_equal(P.block_rag(seg, vals, device="cpu"), P._block_rag_host(seg, vals, seg.shape))
    dense, table = P._densify_on(seg, torch.device("cpu"))
    table = table.numpy().view(np.uint64)
    assert table[0] == 0 and (np.diff(table) > 0).all()
    np.testing.assert_array_equal(table[dense.numpy()], seg)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the RAG's device path on the card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_rag_sums_equal_the_cpu_sums(cuda):
    """On the card an edge's pairs are summed in the CPU's order: count,
    sum, min and max equal the CPU's bit for bit on a block whose edges
    each hold hundreds of pairs; labels of 2^63 or more densify alike.
    The second moment is taken about the shift c, the mean of all pairs, a
    plain ``sum`` whose order differs between the devices, so it is held at
    rtol 1e-5.  The variance ``sq/n - (mean - c)^2`` is a cancellation
    residue on an edge with few pairs, where a shift an ulp away leaves a
    different residue: it is held per entry at the formula's own float32
    error bound, ``(n + 2) * eps32 * (sq/n + (mean - c)^2)`` (n float32
    roundings of the sequential sum, two of ``(x - c)^2``, on each device)."""
    rng = np.random.default_rng(11)
    seg = random_seg(rng, (48, 48, 48), n_labels=12, p_bg=0.05).astype(np.int32)
    vals = torch.from_numpy(rng.random(seg.shape).astype(np.float32))
    cpu = P.device_edge_aggregate(torch.from_numpy(seg), vals)
    gpu = P.device_edge_aggregate(torch.from_numpy(seg).to(cuda), vals.to(cuda))
    assert int(cpu[2].min()) >= 100
    for name, i in (("lo", 0), ("hi", 1), ("count", 2), ("sum", 3), ("min", 5), ("max", 6)):
        assert torch.equal(cpu[i], gpu[i].cpu()), name
    torch.testing.assert_close(gpu[4].cpu(), cpu[4], rtol=1e-5, atol=0)
    big = _above_2_63(rng, (16, 17, 18))
    bvals = rng.random(big.shape).astype(np.float32)
    got = P.block_rag(big, bvals, device=cuda, return_nodes=True)
    want = P.block_rag(big, bvals, device="cpu", return_nodes=True)
    for i in (0, 1, 3):
        np.testing.assert_array_equal(got[i], want[i])
    np.testing.assert_array_equal(got[2][:, :4], want[2][:, :4])
    # the bound's terms from the CPU's aggregate (its edges in block_rag's order)
    dense = P._densify_on(big, torch.device("cpu"))[0]
    _, _, n, vsum, vsumsq, _, _, c, _ = P.device_edge_aggregate(dense, torch.from_numpy(bvals))
    n, sq = n.double().numpy(), vsumsq.double().numpy()
    m = vsum.double().numpy() / n
    bound = (n + 2) * np.finfo(np.float32).eps * (sq / n + (m - float(c)) ** 2)
    err = np.abs(got[2][:, 4].astype(np.float64) - want[2][:, 4])
    assert (err <= bound).all(), (err.max(), bound[err.argmax()])


@pytest.mark.parametrize("large", [False, True])
def test_blockwise_merge_matches_reference(large):
    rng = np.random.default_rng(7)
    seg = random_seg(rng, (16, 16, 16), n_labels=30)
    if large:
        seg[seg > 0] += np.uint64(10_000_000)
    vals = rng.random(seg.shape).astype(np.float32)
    parts = {"port": ([], []), "jax": ([], [])}
    for s, v, inner in _blocks(seg, vals, (8, 8, 8)):
        for side, fn in (("port", lambda: P.block_rag(s, v, inner_shape=inner, device="cpu")),
                         ("jax", lambda: J.block_rag(s, v, inner_shape=inner))):
            uv, sizes, feats = fn()
            parts[side][0].append((uv, sizes))
            parts[side][1].append((uv, feats))
    uv_p, sz_p = P.merge_edge_lists(parts["port"][0])
    uv_j, sz_j = J.merge_edge_lists(parts["jax"][0])
    np.testing.assert_array_equal(uv_p, uv_j)
    np.testing.assert_array_equal(sz_p, sz_j)
    f_p = P.merge_feature_lists(uv_p, parts["port"][1])
    with native.force_python():
        f_j = J.merge_feature_lists(uv_j, parts["jax"][1])
    np.testing.assert_array_equal(f_p[:, 1:4], f_j[:, 1:4])
    np.testing.assert_allclose(f_p[:, 0], f_j[:, 0], rtol=1e-4)
    np.testing.assert_allclose(f_p[:, 4], f_j[:, 4], rtol=1e-2, atol=1e-6)
    # and the same merge of the reference's own parts is the reference's
    np.testing.assert_array_equal(P.merge_feature_lists(uv_j, parts["jax"][1]), f_j)


def test_merge_variance_large_mean():
    rng = np.random.default_rng(4)
    seg = (rng.integers(0, 3, (24, 24, 24)) + 1).astype(np.uint64)
    vals = (200.0 + 0.5 * rng.random((24, 24, 24))).astype(np.float32)
    parts, fparts = [], []
    for s, v, inner in _blocks(seg, vals, (12, 12, 12)):
        uv, sizes, feats = P.block_rag(s, v, inner_shape=inner, device="cpu")
        parts.append((uv, sizes))
        fparts.append((uv, feats))
    uv_m, _ = P.merge_edge_lists(parts)
    want_uv, _, want = J._block_rag_host(seg, vals, seg.shape)
    np.testing.assert_array_equal(uv_m, want_uv)
    got = P.merge_feature_lists(uv_m, fparts)
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-5)
    np.testing.assert_allclose(got[:, 4], want[:, 4], rtol=1e-2)


def test_merge_feature_lists_refuses_duplicates_and_old_formats():
    uv = np.array([[1, 2], [3, 4]], np.uint64)
    with pytest.raises(ValueError, match="duplicate"):
        P.merge_feature_lists(uv, [(uv[[0, 0]], np.ones((2, 5), np.float32))])
    with pytest.raises(ValueError, match="expected"):
        P.merge_feature_lists(uv, [(uv, np.ones((2, 4), np.float32))])


@pytest.mark.parametrize("high", [2**20, 2**40])
def test_find_edge_ids_matches_reference(high):
    """Packed keys (labels below 2^32) and the structured search (above)."""
    rng = np.random.default_rng(high % 97)
    uv = rng.integers(1, high, size=(500, 2)).astype(np.uint64)
    uv = np.unique(np.sort(uv, axis=1), axis=0)
    q = np.concatenate([uv[rng.permutation(len(uv))], np.array([[3, 5], [0, 1], [1, 2**40]], np.uint64)])
    np.testing.assert_array_equal(P.find_edge_ids(uv, q), J.find_edge_ids(uv, q))
    small = np.array([[1, 2], [1, 5], [3, 4]], np.uint64)
    np.testing.assert_array_equal(P.find_edge_ids(small, small[[2, 0]]), [2, 0])
    assert P.find_edge_ids(uv, np.zeros((0, 2), np.uint64)).shape == (0,)
    assert (P.find_edge_ids(np.zeros((0, 2), np.uint64), small) == -1).all()


@pytest.mark.parametrize("dtype,beta", [(np.int32, 0.5), (np.uint64, 0.3)])
def test_block_rag_fused_matches_reference(dtype, beta):
    rng = np.random.default_rng(11)
    seg = random_seg(rng, (20, 24, 28), n_labels=60)
    if dtype == np.uint64:
        seg = seg * np.uint64(2**35)
    seg = seg.astype(dtype)
    vals = rng.random(seg.shape).astype(np.float32)
    inner = (18, 22, 26)
    got = P.block_rag_fused(seg, vals, beta=beta, inner_shape=inner, device="cpu")
    want = J.block_rag_fused(seg, vals, beta=beta, inner_shape=inner)
    for name, g, w in zip(("nodes", "edges", "costs", "sizes", "mean"), got, want):
        assert g.dtype == w.dtype, name
        if name in ("costs", "mean"):
            np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-4, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
