"""Port (repro_torch) ≡ reference (repro): the paper's scalar baselines.

At the reference's oracle sizes, seeded numpy inputs go through the JAX
package's function and the port's: ``flatten_tree`` (byte for byte),
``select_recursive_py`` in both predicate styles (ids and counters), the
DFS walks ``make_select_dfs`` (S) and ``make_select_dfs_vector`` (V)
against the reference's jitted ``while_loop`` programs (ids in emit
order, count and every counter, overflowed walks included; on the CPU the
port runs the kernels' host twins), ``join_recursive_py`` with O3/O4 off
and on, and the best-first ``knn_best_first`` / ``knn_join_best_first``
(ids, float64 distances exactly, counters).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import flat as jflat
from repro.core import join_scalar as jjoin
from repro.core import knn_join_scalar as jkjs
from repro.core import knn_scalar as jks
from repro.core import rtree as jrtree
from repro.core import select_scalar as jss
from repro.core import select_vector as jsv
from repro_torch.core import flat as tflat
from repro_torch.core import join_scalar as tjoin
from repro_torch.core import knn_join_scalar as tkjs
from repro_torch.core import knn_scalar as tks
from repro_torch.core import rtree as trtree
from repro_torch.core import select_scalar as tss
from repro_torch.core import select_vector as tsv
from repro_torch.kernels import ops, ref

from conftest import brute_select, uniform_rects

FLAT_FIELDS = ("lx", "ly", "hx", "hy", "child", "count", "is_leaf")


def _queries(rng, b, side):
    lo = rng.random((b, 2)).astype(np.float32) * (1 - side)
    return np.concatenate([lo, lo + side], axis=1).astype(np.float32)


def _scalars(ctr):
    """A Counters' fields as Python ints (the occupancy vectors left out:
    the baselines record none)."""
    return {k: int(np.asarray(v)) for k, v in ctr.asdict().items()
            if not isinstance(v, list)}


@pytest.fixture(scope="module")
def trees():
    """The reference's select instance (20,000 points, fanout 64, height
    3) and a deeper one (6,000 rects of half-extent 0.001, fanout 16,
    height 4), each in both packages with its flat table."""
    out = {}
    cases = {"wide": (3, 20_000, 0.0, 64), "deep": (11, 6000, 0.001, 16)}
    for name, (seed, n, eps, fanout) in cases.items():
        rects = uniform_rects(np.random.default_rng(seed), n, eps=eps)
        jt = jrtree.build_rtree(rects, fanout=fanout)
        tt = trtree.build_rtree(rects, fanout=fanout, device="cpu")
        out[name] = (rects, jt, tt, jflat.flatten_tree(jt),
                     tflat.flatten_tree(tt))
    assert out["deep"][2].height == 4
    return out


@pytest.mark.parametrize("name", ["wide", "deep"])
def test_flatten_tree_byte_equal(trees, name):
    _, _, _, jf, tf = trees[name]
    for f in FLAT_FIELDS:
        a, b = np.asarray(getattr(jf, f)), getattr(tf, f).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8),
                                      err_msg=f)
        assert getattr(tf, f).is_contiguous(), f
    assert (tf.root, tf.height, tf.fanout, tf.n_nodes) == \
        (jf.root, jf.height, jf.fanout, jf.n_nodes)


@pytest.mark.parametrize("variant", ["logical", "bitwise"])
def test_select_recursive_equal(trees, variant):
    rects, jt, tt, _, _ = trees["wide"]
    for q in _queries(np.random.default_rng(4), 8, 0.05):
        jids, jctr = jss.select_recursive_py(jt, q, variant)
        tids, tctr = tss.select_recursive_py(tt, torch.from_numpy(q),
                                             variant)
        assert tids.dtype == np.int64
        np.testing.assert_array_equal(tids, jids)
        np.testing.assert_array_equal(tids, brute_select(rects, q))
        assert tctr.asdict() == jctr.asdict()
    with pytest.raises(ValueError):
        tss.select_recursive_py(tt, q, "fuzzy")


# (stack_cap, result_cap): the default, a cap every query's emits pass,
# stacks of 8 and 4 that the deep tree's walks overflow
DFS_CAPS = [(1024, 4096), (1024, 16), (8, 4096), (4, 64)]


@pytest.mark.parametrize("caps", DFS_CAPS)
@pytest.mark.parametrize("variant", ["scalar", "vector"])
def test_select_dfs_equal(trees, variant, caps):
    """res (emit order, -1 padded), rc and every counter ≡ the reference's
    jitted walk; an unsorted res sorts to brute force when nothing
    overflowed."""
    stack_cap, result_cap = caps
    rects, _, _, jf, tf = trees["deep"]
    jmake, tmake = ((jss.make_select_dfs, tss.make_select_dfs)
                    if variant == "scalar" else
                    (jsv.make_select_dfs_vector, tsv.make_select_dfs_vector))
    jfn = jmake(jf, result_cap, stack_cap)
    tfn = tmake(tf, result_cap, stack_cap)
    overflowed = 0
    for q in _queries(np.random.default_rng(12), 6, 0.12):
        jres, jrc, jctr = jfn(jnp.asarray(q))
        tres, trc, tctr = tfn(q)
        assert tres.dtype == torch.int32 and tres.shape == (result_cap,)
        np.testing.assert_array_equal(tres.numpy(), np.asarray(jres))
        assert int(trc) == int(jrc)
        assert _scalars(tctr) == _scalars(jctr)
        overflowed += int(tctr.overflow)
        if not int(tctr.overflow):
            np.testing.assert_array_equal(
                np.sort(tres.numpy()[:int(trc)]), brute_select(rects, q))
    assert (overflowed > 0) == (caps != DFS_CAPS[0]), overflowed


def test_select_dfs_stops_where_the_reference_would_not():
    """A one-slot stack under a query that holds everything re-reads its
    slot without end (the reference's loop would not end): the walk stops
    after ``dfs_max_steps`` pops with overflow set, S and V alike."""
    rects = uniform_rects(np.random.default_rng(2), 600)
    tf = tflat.flatten_tree(trtree.build_rtree(rects, fanout=8,
                                               device="cpu"))
    q = np.array([0.0, 0.0, 1.0, 1.0], np.float32)
    for make in (tss.make_select_dfs, tsv.make_select_dfs_vector):
        _, _, ctr = make(tf, 32, stack_cap=1)(q)
        assert int(ctr.nodes_visited) == tss.dfs_max_steps(tf)
        assert int(ctr.overflow) == 1


def test_select_dfs_routing(trees):
    """'auto' on a CPU table runs the twins; 'cuda' raises on CPU
    tensors; the twins agree with 'torch'."""
    _, _, _, _, tf = trees["wide"]
    q = _queries(np.random.default_rng(5), 1, 0.05)[0]
    a = tss.make_select_dfs(tf, 256)(q)
    b = tss.make_select_dfs(tf, 256, backend="torch")(q)
    np.testing.assert_array_equal(a[0].numpy(), b[0].numpy())
    with pytest.raises(RuntimeError, match="CUDA"):
        tss.make_select_dfs(tf, 256, backend="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.select_dfs("vector", tf.lx, tf.ly, tf.hx, tf.hy, tf.child,
                       tf.count, tf.is_leaf, torch.from_numpy(q),
                       root=tf.root, stack_cap=64, result_cap=64,
                       max_steps=10, backend="cuda")
    res, stats = ref.select_dfs_scalar_ref(
        tf.lx, tf.ly, tf.hx, tf.hy, tf.child, tf.count, tf.is_leaf,
        torch.from_numpy(q), root=tf.root, stack_cap=64, result_cap=256,
        max_steps=tss.dfs_max_steps(tf))
    np.testing.assert_array_equal(res.numpy(), a[0].numpy())
    assert stats.dtype == torch.int32 and stats.shape == (4,)


@pytest.fixture(scope="module")
def join_trees():
    rng = np.random.default_rng(2)
    ra = uniform_rects(rng, 3000, eps=0.004)
    rb = uniform_rects(rng, 2000, eps=0.004)
    out = []
    for fa, fb in ((16, 16), (8, 32)):          # unequal fanout and height
        out.append(tuple((jrtree.build_rtree(r, fanout=f, sort_key="lx"),
                          trtree.build_rtree(r, fanout=f, sort_key="lx",
                                             device="cpu"))
                         for r, f in ((ra, fa), (rb, fb))))
    return out


@pytest.mark.parametrize("o3,o4", [(False, False), (True, False),
                                   (True, True)])
@pytest.mark.parametrize("shape", [0, 1])
def test_join_recursive_equal(join_trees, shape, o3, o4):
    (ja, ta), (jb, tb) = join_trees[shape]
    jpairs, jctr = jjoin.join_recursive_py(ja, jb, o3=o3, o4=o4)
    tpairs, tctr = tjoin.join_recursive_py(ta, tb, o3=o3, o4=o4)
    assert tpairs.dtype == np.int64 and len(tpairs) > 0
    np.testing.assert_array_equal(tpairs, jpairs)
    assert tctr.asdict() == jctr.asdict()
    if o3:
        assert tctr.pruned_outer > 0


def test_join_recursive_needs_sorted_trees(join_trees):
    (_, ta), _ = join_trees[0]
    t = trtree.build_rtree(uniform_rects(np.random.default_rng(1), 200),
                           fanout=8, device="cpu")
    with pytest.raises(ValueError, match="sort_key"):
        tjoin.join_recursive_py(ta, t, o3=True)


@pytest.mark.parametrize("use_mmd", [True, False])
@pytest.mark.parametrize("k", [1, 8, 64])
def test_knn_best_first_equal(trees, k, use_mmd):
    _, jt, tt, _, _ = trees["deep"]
    pts = np.random.default_rng(k).random((5, 2)).astype(np.float32)
    jfn = jks.make_knn_best_first(jt, use_mmd)
    tfn = tks.make_knn_best_first(tt, use_mmd)
    for p in pts:
        ji, jd, jc = jfn(p, k)
        ti, td, tc = tfn(torch.from_numpy(p), k)
        assert ti.dtype == np.int64 and td.dtype == np.float64
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(td.view(np.int64), jd.view(np.int64))
        assert tc.asdict() == jc.asdict()
    ji, jd, jc = jks.knn_best_first(jt, pts[0], k, use_mmd)
    ti, td, tc = tks.knn_best_first(tt, pts[0], k, use_mmd)
    np.testing.assert_array_equal(ti, ji)
    assert tc.asdict() == jc.asdict()
    with pytest.raises(ValueError, match="k must be positive"):
        tfn(pts[0], 0)


@pytest.mark.parametrize("k", [1, 8, 64])
def test_knn_join_best_first_equal(trees, k):
    rects, jt, tt, _, _ = trees["deep"]
    rng = np.random.default_rng(100 + k)
    c = rng.random((6, 2)).astype(np.float32)
    outer = np.concatenate([c - np.float32(0.003), c + np.float32(0.003)],
                           axis=1)
    ji, jd, jc = jkjs.knn_join_best_first(jt, outer, k)
    ti, td, tc = tkjs.knn_join_best_first(tt, torch.from_numpy(outer), k)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(td.view(np.int64), jd.view(np.int64))
    assert tc.asdict() == jc.asdict()
    jfn = jkjs.make_knn_join_best_first(jt)
    tfn = tkjs.make_knn_join_best_first(tt)
    for r in outer[:2]:
        a, b = jfn(r, k), tfn(r, k)
        np.testing.assert_array_equal(b[0], a[0])
        np.testing.assert_array_equal(b[1], a[1])
        assert b[2].asdict() == a[2].asdict()
