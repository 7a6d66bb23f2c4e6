"""Port (repro_torch) ≡ reference (repro): the packed forest of the fleet's
single-program path, its merges, and the serve entry point's ``--mesh``.

``pack_forest`` equals the reference's in every array (levels, rects,
``ids_map``, ``mbrs``, ``n_real``) at ``n_shards`` 1 and 4, with and
without ``order`` and ``min_height``; the flat view's D3 rows equal the
reference's per-partition D3 rows byte for byte, hold no NaN, and no
pointer reaches a padded row; ``topk_by_distance`` and
``merge_stacked_counters`` equal the reference's on ties and pads;
``host_view`` and ``disable_mesh``; and ``serve --mesh on --device cpu``
serves every fleet mode with the first batch of ``--mesh off``.  Inputs are
made with numpy from a seed and handed to both packages.
"""
import argparse

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import counters as jcounters
from repro.core import layouts as jlayouts
from repro.core.rtree import RTreeLevel as JLevel
from repro.distributed import collectives as jcoll
from repro.distributed import forest as jforest
from repro_torch.core import layouts as tlayouts
from repro_torch.core.counters import Counters
from repro_torch.core.rtree import LEVEL_FIELDS
from repro_torch.distributed import collectives as tcoll
from repro_torch.distributed import forest as tforest
from repro_torch.distributed.spatial_shard import SpatialShards as TShards
from repro_torch.launch import serve

from conftest import uniform_rects
from oracle import _shards_for


@pytest.fixture(scope="module")
def fleets():
    """One dataset's 4-partition fleet (fanout 16) in both packages: 1,026
    rects, so the tiles hold 257, 256, 257 and 256 rects and the trees
    are 3, 2, 3 and 2 levels tall (the pack elevates the short ones)."""
    rng = np.random.default_rng(5)
    rects = uniform_rects(rng, 1026, eps=0.002)
    jsh = _shards_for(rects, 4, 16, mesh=False)
    tsh = TShards.build(rects, 4, fanout=16, device="cpu")
    for j, t in zip(jsh.partitions, tsh.partitions):
        np.testing.assert_array_equal(j.ids, t.ids)
    assert [p.tree.height for p in tsh.partitions] == [3, 2, 3, 2]
    return jsh, tsh


def _pack_both(fleets, **kw):
    jsh, tsh = fleets
    return (jforest.pack_forest([p.tree for p in jsh.partitions],
                                [p.ids for p in jsh.partitions], **kw),
            tforest.pack_forest([p.tree for p in tsh.partitions],
                                [p.ids for p in tsh.partitions], **kw))


@pytest.mark.parametrize("n_shards", [1, 4, 3])
@pytest.mark.parametrize("order", [None, (2, 0, 3, 1)])
@pytest.mark.parametrize("extra_height", [0, 1])
def test_pack_forest_equals_reference(fleets, n_shards, order,
                                      extra_height):
    h = max(p.tree.height for p in fleets[1].partitions)
    jf, tf = _pack_both(fleets, n_shards=n_shards, order=order,
                        min_height=h + extra_height if extra_height else None)
    assert tf.n_real == jf.n_real == 4
    assert tf.n_partitions == jf.n_partitions == -(-4 // n_shards) * \
        n_shards
    assert tf.height == jf.height == h + extra_height
    for li, (jl, tl) in enumerate(zip(jf.tree.levels, tf.tree.levels)):
        for f in LEVEL_FIELDS:
            np.testing.assert_array_equal(
                getattr(tl, f).numpy(), np.asarray(getattr(jl, f)),
                err_msg=f"level {li} {f}")
    np.testing.assert_array_equal(tf.tree.rects.numpy(),
                                  np.asarray(jf.tree.rects))
    np.testing.assert_array_equal(tf.ids_map.numpy(), jf.ids_map)
    np.testing.assert_array_equal(tf.mbrs, jf.mbrs)
    # the flat view: levels end to end, pointers offset per partition
    p = tf.n_partitions
    for li, (sl, fl) in enumerate(zip(tf.tree.levels, tf.flat.levels)):
        n = sl.count.shape[1]
        below = (tf.tree.rects.shape[1] if li == 0
                 else tf.tree.levels[li - 1].count.shape[1])
        off = (np.arange(p) * below)[:, None, None]
        child = sl.child.numpy()
        np.testing.assert_array_equal(
            fl.child.numpy().reshape(p, n, -1),
            np.where(child >= 0, child + off, -1))
        np.testing.assert_array_equal(fl.lx.numpy().reshape(p, n, -1),
                                      sl.lx.numpy())
    np.testing.assert_array_equal(tf.ids_flat.numpy(), jf.ids_map.ravel())
    part = tf.partition_tree
    assert [lvl.n_nodes for lvl in part.levels] == \
        [lvl.count.shape[1] for lvl in tf.tree.levels]


def test_flat_d3_rows_equal_reference_and_pads_are_unreachable(fleets):
    """D3 of the flat forest: each partition's rows, its padded rows too,
    byte-equal to the reference's D3 of that partition's padded tree
    (pointers offset); no NaN anywhere; no pointer reaches a padded row."""
    jf, tf = _pack_both(fleets, n_shards=4)      # 4 real partitions
    jf3, tf3 = _pack_both(fleets, n_shards=3)    # 2 empty partitions
    for jfo, tfo in ((jf, tf), (jf3, tf3)):
        p = tfo.n_partitions
        layers = tlayouts.tree_layout(tfo.flat, "d3")
        for li, (jl, l3) in enumerate(zip(jfo.tree.levels, layers)):
            n = jl.count.shape[1]
            for f in ("scale", "bias", "slack"):
                assert not torch.isnan(getattr(l3, f)).any(), (li, f)
            for pi in range(p):
                ref = jlayouts.level_to_d3(JLevel(*(
                    getattr(jl, f)[pi] for f in LEVEL_FIELDS)))
                rows = slice(pi * n, (pi + 1) * n)
                for f in ("qlo", "qhi", "scale", "bias", "slack"):
                    assert getattr(l3, f)[rows].numpy().tobytes() == \
                        np.asarray(getattr(ref, f)).tobytes(), (li, pi, f)
                below = (tfo.tree.rects.shape[1] if li == 0
                         else jfo.tree.levels[li - 1].count.shape[1])
                ptr = np.asarray(ref.ptr)
                np.testing.assert_array_equal(
                    l3.ptr[rows].numpy(),
                    np.where(ptr >= 0, ptr + pi * below, -1))
            # reachable rows only: every pointer lands on a real row below
            ptr = l3.ptr.numpy()
            tgt = ptr[ptr >= 0]
            if li == 0:
                assert (tfo.ids_flat.numpy()[tgt] >= 0).all()
            else:
                assert (tfo.flat.levels[li - 1].count.numpy()[tgt] > 0).all()


def test_topk_by_distance_ties_and_pads_equal_reference():
    rng = np.random.default_rng(3)
    d = rng.integers(0, 6, (5, 40)).astype(np.float32) / 4
    d[:, ::7] = np.inf
    ids = rng.permutation(200)[:200].reshape(5, 40).astype(np.int32)
    ids[d == np.inf] = -1
    for k, m in ((8, 40), (12, 9)):           # m < k pads with (-1, +inf)
        ji, jd = jcoll.topk_by_distance(jnp.asarray(ids[:, :m]),
                                        jnp.asarray(d[:, :m]), k)
        ti, td = tcoll.topk_by_distance(torch.from_numpy(ids[:, :m]),
                                        torch.from_numpy(d[:, :m]), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def test_merge_stacked_counters_equals_reference():
    rng = np.random.default_rng(4)
    vals = [rng.integers(0, 1000, (3,)).astype(np.int32) for _ in range(11)]
    occ = [rng.integers(0, 50, (3, 8)).astype(np.int32) for _ in range(2)]
    jm = jcoll.merge_stacked_counters(jcounters.Counters(
        *[jnp.asarray(v) for v in vals[:10]], lanes_live=jnp.asarray(occ[0]),
        lanes_padded=jnp.asarray(occ[1]), escalations=jnp.asarray(vals[10])))
    tm = tcoll.merge_stacked_counters(Counters(
        *[torch.from_numpy(v) for v in vals[:10]],
        lanes_live=torch.from_numpy(occ[0]),
        lanes_padded=torch.from_numpy(occ[1]),
        escalations=torch.from_numpy(vals[10])))
    for f, v in tm.asdict().items():
        np.testing.assert_array_equal(v, np.asarray(getattr(jm, f)), f)


def test_host_view_and_disable_mesh():
    rng = np.random.default_rng(9)
    rects = uniform_rects(rng, 2000, eps=0.002)
    qs = rng.random((4, 2)).astype(np.float32)
    shards = TShards.build(rects, 4, fanout=16, device="cpu", mesh=True)
    assert shards.mesh_enabled
    mesh = shards.knn(qs, 4)
    twin = shards.host_view()
    assert twin is not shards and not twin.mesh_enabled
    assert twin._engines is shards._engines
    host = twin.knn(qs, 4)
    assert shards.mesh_enabled              # the view leaves it on the mesh
    for a, b in zip(mesh[:2], host[:2]):
        np.testing.assert_array_equal(a, b)
    assert shards.disable_mesh() is shards and not shards.mesh_enabled
    assert shards.host_view() is shards and not shards._mesh_programs
    for a, b in zip(shards.knn(qs, 4)[:2], host[:2]):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(RuntimeError, match="enable_mesh"):
        shards.warm("browse", 4, k=4)


def _first(out, mode):
    return out["last_pairs"] if mode == "join" else out["first_batch"]


@pytest.mark.parametrize("mode", sorted(serve.MODE_TO_SPEC))
def test_serve_mesh_on_cpu_equals_mesh_off(mode):
    """``--mesh on`` serves every fleet mode on the CPU; its first batch
    (the join's last) equals ``--mesh off``'s: the host fan-out, and for
    browse the single-tree cursor."""
    argv = ["--mode", mode, "--dryrun", "--device", "cpu"]
    on = serve.main(argv + ["--mesh", "on"])
    off = serve.main(argv + ["--mesh", "off"])
    assert not on["overflow"] and not off["overflow"]
    a, b = _first(on, mode), _first(off, mode)
    if mode in ("spatial", "select"):
        assert len(a) == len(b) and on["results"] == off["results"] > 0
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    elif mode == "join":
        assert len(a) > 0
        np.testing.assert_array_equal(a, b)
    else:
        assert on["neighbors"] == off["neighbors"] > 0
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1].view(np.int32),
                                      b[1].view(np.int32))
    # auto: the mesh path only with more than one CUDA device
    assert not serve._use_mesh(argparse.Namespace(mesh="auto",
                                                  device="cpu"))
