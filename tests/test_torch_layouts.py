"""Port (repro_torch) ≡ reference (repro): the paper's D0 and D2 node
layouts, and the select's ``count_only``.

``level_to_d0`` / ``level_to_d2`` are held byte for byte against the
reference's (the D0 pad pointer's NaN bits included); the pair geometry
bit for bit against the reference's jitted forms and its D2 trace; every
operator on D0 and D2 (select, join, kNN, kNN-join, filtered kNN and
browse) on the host path against the reference's engine on the same
layout (its jnp path: neither package has a kernel for these layouts):
ids, counts, distance bits, overflow and every ``Counters`` field but
``dispatches``; the mesh path on D0 and D2 against the port's D1 mesh
results and its host path; the kernel backends and fused builds raise on
D0 and D2; ``serve --layout d0|d2`` on the CPU for every mode.  Inputs
are made with numpy from a seed and handed to both packages.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import geometry as jgeometry
from repro.core import join_vector as jjoin
from repro.core import knn_browse as jbrowse
from repro.core import knn_filtered as jfilt
from repro.core import knn_join_vector as jkj
from repro.core import knn_vector as jknn
from repro.core import layouts as jlayouts
from repro.core import rtree as jrtree
from repro.core import select_vector as jselect
from repro_torch.core import geometry as tgeometry
from repro_torch.core import join_vector as tjoin
from repro_torch.core import knn_browse as tbrowse
from repro_torch.core import knn_filtered as tfilt
from repro_torch.core import knn_join_vector as tkj
from repro_torch.core import knn_vector as tknn
from repro_torch.core import layouts as tlayouts
from repro_torch.core import rtree as trtree
from repro_torch.core import select_vector as tselect
from repro_torch.core.counters import Counters
from repro_torch.distributed.spatial_shard import SpatialShards as TShards
from repro_torch.launch import serve

from conftest import brute_select, uniform_rects

ENGINE_FIELDS = tuple(f.name for f in dataclasses.fields(Counters)
                      if f.name != "dispatches")
OWN_LAYOUTS = ("d0", "d2")
K, BATCH = 8, 24


def _bits(a):
    a = a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_same(got, want, ctx):
    assert _bits(got).dtype == _bits(want).dtype, ctx
    np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=ctx)


def _assert_counters(tctr, jctr, ctx):
    for f in ENGINE_FIELDS:
        np.testing.assert_array_equal(
            np.asarray(getattr(tctr, f)), np.asarray(getattr(jctr, f)),
            err_msg=f"{ctx}: {f}")


def _assert_engine(tout, jout, ctx):
    """(values..., Counters) of the port ≡ the reference's."""
    for i, (t, j) in enumerate(zip(tout[:-1], jout[:-1])):
        _assert_same(t, j, f"{ctx}: output {i}")
    _assert_counters(tout[-1], jout[-1], ctx)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Single-threaded PyTorch in this module: its tensors are small, and
    parallel test workers whose thread pools each span every core
    oversubscribe the machine (the results do not depend on it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def inst():
    """6,000 rects of half-extent 0.001, fanout 16 (height 4), in both
    packages; a batch of points and of small query rects."""
    rng = np.random.default_rng(22)
    rects = uniform_rects(rng, 6000, eps=0.001)
    jtree = jrtree.build_rtree(rects, fanout=16)
    ttree = trtree.build_rtree(rects, fanout=16, device="cpu")
    assert ttree.height == 4
    pts = rng.random((BATCH, 2)).astype(np.float32)
    lo = rng.random((BATCH, 2)).astype(np.float32) * np.float32(0.94)
    rects_q = np.concatenate([lo, lo + np.float32(0.06)], axis=1)
    return rects, jtree, ttree, pts, rects_q


@pytest.mark.parametrize("layout", OWN_LAYOUTS)
def test_d0_d2_levels_byte_equal(inst, layout):
    _, jtree, ttree, _, _ = inst
    fields = ("entries", "count") if layout == "d0" else \
        ("lo", "hi", "ptr", "count")
    for jl, tl in zip(jlayouts.tree_layout(jtree, layout),
                      tlayouts.tree_layout(ttree, layout)):
        for f in fields:
            a, b = np.asarray(getattr(jl, f)), getattr(tl, f).numpy()
            assert a.dtype == b.dtype and a.shape == b.shape, f
            np.testing.assert_array_equal(a.view(np.uint8),
                                          b.view(np.uint8), err_msg=f)
    if layout == "d0":
        # the pad pointer -1 is a NaN pattern in the float32 table; it
        # comes back as -1 through d0_unpack, as the reference's does
        e = tlayouts.tree_layout(ttree, "d0")[0].entries
        ptr_bits = e[..., 4].view(torch.int32)
        assert bool((ptr_bits == -1).any())
        assert bool(torch.isnan(e[..., 4][ptr_bits == -1]).all())
        jl0 = jlayouts.tree_layout(jtree, "d0")[0].entries
        for t, j in zip(tlayouts.d0_unpack(e), jlayouts.d0_unpack(jl0)):
            _assert_same(t, j, "d0_unpack")


def test_pair_geometry_bit_equal():
    """``intersects_pairs``, ``mindist_pairs`` and ``mindist_rect_pairs``
    ≡ the reference's jitted functions, on flat and gather-shaped pairs."""
    rng = np.random.default_rng(5)
    for shape in ((400, 2), (6, 5, 16, 2)):
        lo = rng.random(shape).astype(np.float32)
        hi = lo + rng.random(shape).astype(np.float32) * np.float32(0.1)
        p = rng.random(shape[:-2] + (1, 2)).astype(np.float32) * \
            np.float32(1.2) - np.float32(0.1)
        p = np.broadcast_to(p, shape).copy()
        q_hi = p + np.float32(0.02)
        for name, args in (("intersects_pairs", (p, q_hi, lo, hi)),
                           ("mindist_pairs", (p, lo, hi)),
                           ("mindist_rect_pairs", (p, q_hi, lo, hi))):
            want = jax.jit(getattr(jgeometry, name))(*map(jnp.asarray, args))
            got = getattr(tgeometry, name)(*map(torch.from_numpy, args))
            _assert_same(got, want, f"{name} {shape}")
    # the pair forms equal the de-interleaved D1 forms
    lx, ly, hx, hy = (torch.from_numpy(a) for a in
                      (lo[..., 0], lo[..., 1], hi[..., 0], hi[..., 1]))
    pt = torch.from_numpy(p)
    _assert_same(tgeometry.mindist_pairs(pt, torch.from_numpy(lo),
                                         torch.from_numpy(hi)),
                 tgeometry.mindist(pt[..., 0], pt[..., 1], lx, ly, hx, hy),
                 "pairs vs mindist")


@pytest.mark.parametrize("layout", OWN_LAYOUTS)
def test_d2_score_trace_forms(inst, layout):
    """The port's D0/D2 score stages ≡ the reference's jitted per-level
    scores on gather-shaped frontiers (the MINDIST and MINMAXDIST bits the
    τ prune reads), points and rects, every level."""
    _, jtree, ttree, pts, rects_q = inst
    jl = jlayouts.tree_layout(jtree, layout)
    tl = tlayouts.tree_layout(ttree, layout)
    rng = np.random.default_rng(7)
    jpt = jax.jit(jknn._dists_for_level)
    jrect = jax.jit(jkj._rect_dists_for_level, static_argnums=3)
    for li in range(ttree.height):
        ids = rng.integers(0, ttree.levels[li].n_nodes, (BATCH, 12)) \
            .astype(np.int32)
        ids[rng.random(ids.shape) < 0.2] = -1
        tids = torch.from_numpy(ids)
        want = jpt(jl[li], jnp.asarray(ids), jnp.asarray(pts))
        got = tknn._dists_for_layer(tl[li], tids, torch.from_numpy(pts),
                                    False)
        for g, w, what in zip(got, want, ("md", "mmd", "ptr")):
            _assert_same(g, w, f"kNN {layout} level {li} {what}")
        assert got[3] == want[3]
        want = jrect(jl[li], jnp.asarray(ids), jnp.asarray(rects_q), False)
        got = tkj._rect_dists_for_layer(tl[li], tids,
                                        torch.from_numpy(rects_q), False)
        for g, w, what in zip(got, want, ("md", "mmd", "ptr")):
            _assert_same(g, w, f"kNN-join {layout} level {li} {what}")


@pytest.mark.parametrize("caps_mode", ["static", "adaptive"])
@pytest.mark.parametrize("layout", OWN_LAYOUTS)
def test_select_equals_reference(inst, layout, caps_mode):
    rects, jtree, ttree, _, q = inst
    jout = jselect.make_select_bfs(jtree, layout=layout, result_cap=512,
                                   caps_mode=caps_mode)(jnp.asarray(q))
    tout = tselect.make_select_bfs(ttree, layout=layout, result_cap=512,
                                   caps_mode=caps_mode)(q)
    _assert_engine(tout, jout, f"select {layout} {caps_mode}")
    ids, counts = tout[0].numpy(), tout[1].numpy()
    for i in range(4):
        np.testing.assert_array_equal(np.sort(ids[i, :counts[i]]),
                                      brute_select(rects, q[i]))
    d1 = tselect.make_select_bfs(ttree, result_cap=512,
                                 caps_mode=caps_mode)(q)
    _assert_same(tout[0], d1[0], "ids vs d1")


@pytest.mark.parametrize("layout,fused", [
    (layout, fused) for layout in ("d0", "d1", "d2", "d3")
    for fused in (False, True) if not (fused and layout in OWN_LAYOUTS)])
def test_count_only_equals_reference(inst, layout, fused):
    """``make_select_bfs(count_only=True)`` → (counts, Counters) ≡ the
    reference's (its jnp path on D0 and D2, which have no fused
    generation, its ``backend="xla"`` path on D1 and D3, fused or not),
    and the counts ≡ the full select's, at a cap of 16 result slots that
    the full select overflows and ``count_only`` does not flag."""
    _, jtree, ttree, _, q = inst
    jkw = {} if layout in OWN_LAYOUTS else dict(backend="xla", fused=fused)
    jout = jselect.make_select_bfs(jtree, layout=layout, result_cap=16,
                                   count_only=True, **jkw)(jnp.asarray(q))
    tout = tselect.make_select_bfs(ttree, layout=layout, result_cap=16,
                                   count_only=True, fused=fused)(q)
    assert len(tout) == 2
    _assert_engine(tout, jout, f"count_only {layout}")
    full = tselect.make_select_bfs(ttree, layout=layout, result_cap=16,
                                   fused=fused)(q)
    _assert_same(tout[0], full[1], "counts vs full select")
    assert int(tout[1].overflow) == 0 and int(full[2].overflow) == 1


@pytest.mark.parametrize("o34", [False, True])
@pytest.mark.parametrize("layout", OWN_LAYOUTS)
def test_join_equals_reference(layout, o34):
    rng = np.random.default_rng(13)
    ra = uniform_rects(rng, 2500, eps=0.004)
    rb = uniform_rects(rng, 1500, eps=0.004)
    jt = [jrtree.build_rtree(r, fanout=f, sort_key="lx")
          for r, f in ((ra, 16), (rb, 8))]
    tt = [trtree.build_rtree(r, fanout=f, sort_key="lx", device="cpu")
          for r, f in ((ra, 16), (rb, 8))]
    kw = dict(o3=True, o5="gather") if o34 else {}
    jout = jjoin.make_join_bfs(*jt, layout=layout, result_cap=1 << 14,
                               **kw)()
    tout = tjoin.make_join_bfs(*tt, layout=layout, result_cap=1 << 14,
                               **kw)()
    _assert_engine(tout, jout, f"join {layout} {kw}")
    d1 = tjoin.make_join_bfs(*tt, result_cap=1 << 14, **kw)()
    _assert_same(tout[0], d1[0], "pairs vs d1")
    assert int(tout[1]) > 0 and int(tout[2].overflow) == 0


def _distance_cells():
    return [(op, layout, k) for op in ("knn", "knn_join", "knn_filtered")
            for layout in OWN_LAYOUTS
            for k in ((8,) if op == "knn_filtered" else (1, 8))]


@pytest.mark.parametrize("op,layout,k", _distance_cells())
def test_distance_operators_equal_reference(inst, op, layout, k):
    """kNN, kNN-join and filtered kNN on D0/D2, both caps tiers: ≡ the
    reference's engine on the layout, and ids and distance bits ≡ the
    port's D1 engine."""
    _, jtree, ttree, pts, rects_q = inst
    if op == "knn":
        jmake, tmake, q = jknn.make_knn_bfs, tknn.make_knn_bfs, pts
    elif op == "knn_join":
        jmake, tmake, q = jkj.make_knn_join_bfs, tkj.make_knn_join_bfs, \
            rects_q
    else:
        jmake, tmake = jfilt.make_knn_filtered_bfs, tfilt.make_knn_filtered_bfs
        e = np.float32(0.15)
        q = np.concatenate([pts, pts - e, pts + e], axis=1)
    for caps_mode in ("static", "adaptive"):
        jout = jmake(jtree, k, layout=layout,
                     caps_mode=caps_mode)(jnp.asarray(q))
        tout = tmake(ttree, k, layout=layout, caps_mode=caps_mode)(q)
        _assert_engine(tout, jout, f"{op} {layout} k={k} {caps_mode}")
    d1 = tmake(ttree, k, caps_mode=caps_mode)(q)
    _assert_same(tout[0], d1[0], "ids vs d1")
    _assert_same(tout[1], d1[1], "dists vs d1")


@pytest.mark.parametrize("layout", OWN_LAYOUTS)
def test_browse_equals_reference(inst, layout):
    """A browse session on D0/D2 step by step ≡ the reference's cursor on
    the layout: ids, distance bits, overflow and counters."""
    _, jtree, ttree, pts, _ = inst
    jcur = jbrowse.make_browse_bfs(jtree, 4, layout=layout)(
        jnp.asarray(pts))
    tcur = tbrowse.make_browse_bfs(ttree, 4, layout=layout)(pts)
    for step in range(6):
        ji, jd = jcur.next_batch()
        ti, td = tcur.next_batch()
        _assert_same(ti, ji, f"browse {layout} step {step} ids")
        _assert_same(td, jd, f"browse {layout} step {step} dists")
        np.testing.assert_array_equal(np.asarray(tcur.overflow),
                                      np.asarray(jcur.overflow))
    _assert_counters(tcur.counters, jcur.counters, f"browse {layout}")


def _fleet(rects, layout):
    return TShards.build(rects, 4, fanout=16, layout=layout,
                         device="cpu").enable_mesh()


@pytest.mark.parametrize("layout", OWN_LAYOUTS)
def test_mesh_equals_d1_mesh_and_host(layout):
    """The fleet's single-program path on D0/D2 ≡ the port's D1 mesh
    results and the D0/D2 host path: select, join, kNN, kNN-join and
    filtered kNN, and the distributed browse."""
    rng = np.random.default_rng(31)
    rects = uniform_rects(rng, 4000, eps=0.002)
    lo = rng.random((6, 2)).astype(np.float32) * np.float32(0.9)
    sel = np.concatenate([lo, lo + np.float32(0.05)], axis=1)
    probe = np.concatenate([lo, lo + np.float32(0.01)], axis=1)
    pts = rng.random((6, 2)).astype(np.float32)
    win = np.concatenate([pts, pts - np.float32(0.2),
                          pts + np.float32(0.2)], axis=1)
    fleets = {lay: _fleet(rects, lay) for lay in (layout, "d1")}

    def run(s):
        return dict(select=s.range_select(sel, result_cap=4096),
                    join=s.join(probe, result_cap=1 << 14),
                    knn=s.knn(pts, K), knn_join=s.knn_join(probe, K),
                    knn_filtered=s.knn_filtered(win, K))

    got, d1 = run(fleets[layout]), run(fleets["d1"])
    host = run(fleets[layout].host_view())
    for want, what in ((d1, "d1 mesh"), (host, "host path")):
        for a, b in zip(got["select"], want["select"]):
            np.testing.assert_array_equal(a, b, err_msg=what)
        np.testing.assert_array_equal(got["join"][0], want["join"][0])
        for op in ("knn", "knn_join", "knn_filtered"):
            np.testing.assert_array_equal(got[op][0], want[op][0],
                                          err_msg=f"{op} {what}")
            _assert_same(got[op][1], want[op][1], f"{op} {what}")
    curs = [s.browse(pts, 4) for s in (fleets[layout], fleets["d1"])]
    for step in range(3):
        (ai, ad), (bi, bd) = (c.next_batch() for c in curs)
        np.testing.assert_array_equal(ai, bi)
        _assert_same(ad, bd, f"browse step {step}")


@pytest.mark.parametrize("layout", OWN_LAYOUTS)
def test_kernel_backends_and_fused_raise(inst, layout):
    """Neither package has a kernel for D0 or D2: ``backend='cuda'`` and
    ``fused=True`` raise ValueError with the reference's words, on any
    device; the reference raises alike for its kernel backends."""
    _, jtree, ttree, _, _ = inst
    builds = (
        (tselect.make_select_bfs, jselect.make_select_bfs, (), "d1 or d3"),
        (tknn.make_knn_bfs, jknn.make_knn_bfs, (K,), "d1 or d3"),
        (tkj.make_knn_join_bfs, jkj.make_knn_join_bfs, (K,), "d1 or d3"),
        (tbrowse.make_browse_bfs, jbrowse.make_browse_bfs, (K,), "d1 or d3"),
    )
    for tmake, jmake, args, words in builds:
        with pytest.raises(ValueError, match=f"requires layout {words}"):
            tmake(ttree, *args, layout=layout, backend="cuda")
        with pytest.raises(ValueError, match=f"requires layout {words}"):
            jmake(jtree, *args, layout=layout, backend="xla")
    for tmake, args in ((tselect.make_select_bfs, ()),
                        (tknn.make_knn_bfs, (K,)),
                        (tkj.make_knn_join_bfs, (K,))):
        with pytest.raises(ValueError):
            tmake(ttree, *args, layout=layout, fused=True)
    with pytest.raises(ValueError, match="no kernel backend"):
        tfilt.make_knn_filtered_bfs(ttree, K, layout=layout, backend="cuda")
    sorted_tree = trtree.build_rtree(uniform_rects(
        np.random.default_rng(1), 300), fanout=16, sort_key="lx",
        device="cpu")
    with pytest.raises(ValueError, match="requires layout d1"):
        tjoin.make_join_bfs(sorted_tree, sorted_tree, layout=layout,
                            backend="cuda")
    with pytest.raises(ValueError, match="fused join"):
        tjoin.make_join_bfs(sorted_tree, sorted_tree, layout=layout,
                            fused=True)


@pytest.mark.parametrize("mode", ["spatial", "join", "knn", "knn-join",
                                  "knn-filtered", "browse"])
@pytest.mark.parametrize("layout", OWN_LAYOUTS)
def test_serve_d0_d2_dryrun_equals_d1(layout, mode):
    """``serve --layout d0|d2 --dryrun --device cpu`` serves every mode,
    its first batch equal to D1's."""
    argv = ["--mode", mode, "--dryrun", "--device", "cpu"]
    got = serve.main(argv + ["--layout", layout])
    want = serve.main(argv)
    assert not got.get("overflow", False)
    if mode == "join":
        assert got["pairs"] == want["pairs"] > 0
        np.testing.assert_array_equal(got["last_pairs"], want["last_pairs"])
        return
    assert got["qps"] > 0
    for a, b in zip(got["first_batch"], want["first_batch"]):
        np.testing.assert_array_equal(a, b)
