"""Port (repro_torch) ≡ reference (repro): tree build, caps, compaction,
layouts, and the port's import hygiene.

Every input is made with numpy from a seed and handed to both packages;
nothing on these paths does float arithmetic, so every comparison is exact.
"""
import ast
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import caps as jcaps
from repro.core import compaction as jcompaction
from repro.core import rtree as jrtree
from repro_torch.core import caps as tcaps
from repro_torch.core import compaction as tcompaction
from repro_torch.core import layouts as tlayouts
from repro_torch.core import rtree as trtree

from conftest import uniform_rects

PORT_ROOT = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"


def _jax_levels(jtree):
    return [{f: np.asarray(getattr(lvl, f)) for f in trtree.LEVEL_FIELDS}
            for lvl in jtree.levels]


def _assert_levels_equal(jtree, ttree):
    assert ttree.height == jtree.height
    assert ttree.fanout == jtree.fanout and ttree.sort_key == jtree.sort_key
    for jl, tl in zip(_jax_levels(jtree), ttree.levels):
        for f in trtree.LEVEL_FIELDS:
            got = getattr(tl, f).numpy()
            assert got.dtype == jl[f].dtype, f
            assert got.tobytes() == jl[f].tobytes(), f
    np.testing.assert_array_equal(ttree.rects.numpy(),
                                  np.asarray(jtree.rects))


@pytest.mark.parametrize("n,fanout,eps,sort_key", [
    (2500, 16, 0.002, None),
    (2500, 16, 0.002, "lx"),
    (3000, 8, 0.0, None),
    (700, 64, 0.01, "hy"),
])
def test_str_levels_byte_equal(n, fanout, eps, sort_key):
    rects = uniform_rects(np.random.default_rng(n + fanout), n, eps=eps)
    jtree = jrtree.build_rtree(rects, fanout=fanout, sort_key=sort_key)
    ttree = trtree.build_rtree(rects, fanout=fanout, sort_key=sort_key,
                               device="cpu")
    _assert_levels_equal(jtree, ttree)
    trtree.validate_structure(ttree)


def test_tree_from_arrays_carries_the_jax_tree():
    rects = uniform_rects(np.random.default_rng(5), 2500, eps=0.002)
    jtree = jrtree.build_rtree(rects, fanout=16)
    carried = trtree.tree_from_arrays(_jax_levels(jtree),
                                      np.asarray(jtree.rects), jtree.fanout,
                                      jtree.sort_key, device="cpu")
    _assert_levels_equal(jtree, carried)
    assert carried.height >= 3 and carried.device.type == "cpu"


@pytest.mark.parametrize("seed,n,fanout", [(0, 2500, 16), (1, 3000, 8),
                                           (2, 900, 4), (3, 5000, 32)])
@pytest.mark.parametrize("result_cap", [64, 4096])
def test_select_caps_equal(seed, n, fanout, result_cap):
    rects = uniform_rects(np.random.default_rng(seed), n)
    jtree = jrtree.build_rtree(rects, fanout=fanout)
    ttree = trtree.build_rtree(rects, fanout=fanout, device="cpu")
    for policy in ("static", "adaptive"):
        assert tcaps.select_frontier_caps(ttree, result_cap, policy=policy) \
            == jcaps.select_frontier_caps(jtree, result_cap, policy=policy)


def test_cap_policies_equal_over_arguments():
    sizes = (31329, 506, 9, 1)
    for target in (1, 8, 4096, 100_000):
        for fanout in (4, 16, 64):
            for final in (None, "boost", "target"):
                kw = dict(slack=4, level_sizes=sizes, final=final)
                assert tcaps.geometric_caps(3, fanout, target, min_cap=128,
                                            **kw) == \
                    jcaps.geometric_caps(3, fanout, target, min_cap=128, **kw)
                assert tcaps.adaptive_caps(3, fanout, target, **kw) == \
                    jcaps.adaptive_caps(3, fanout, target, **kw)


@pytest.mark.parametrize("cap", [1, 7, 40, 300])
def test_compact_rows_equal(cap):
    rng = np.random.default_rng(cap)
    vals = rng.integers(-5, 1000, (6, 250)).astype(np.int32)
    mask = rng.random((6, 250)) < rng.random((6, 1))   # per-row density
    jo, jc, jv = jcompaction.compact_rows(jnp.asarray(vals),
                                          jnp.asarray(mask), cap)
    to, tc, tv = tcompaction.compact_rows(torch.from_numpy(vals),
                                          torch.from_numpy(mask), cap)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert to.dtype == torch.int32 and tc.dtype == torch.int32
    assert to.is_contiguous()             # the next level's kernel input
    if cap == 7:
        assert tv.any()                   # the overflow case actually fired


def test_lane_rounding_and_layouts():
    from repro.core import layouts as jlayouts
    for n in (0, 1, 3, 5, 127, 128, 129, 1000):
        assert tlayouts.round_up_to_lanes(n) == jlayouts.round_up_to_lanes(n)
        assert tlayouts.round_up_adaptive(n) == \
            jlayouts.round_up_adaptive(n)
    for f in (1, 4, 16, 64, 200):
        assert tlayouts.lane_floor(f) == jlayouts.lane_floor(f)
    rects = uniform_rects(np.random.default_rng(9), 600, eps=0.001)
    jtree = jrtree.build_rtree(rects, fanout=16)
    ttree = trtree.build_rtree(rects, fanout=16, device="cpu")
    for jl, tl in zip(jlayouts.tree_layout(jtree, "d1"),
                      tlayouts.tree_layout(ttree, "d1")):
        np.testing.assert_array_equal(tl.coords.numpy(),
                                      np.asarray(jl.coords))
        np.testing.assert_array_equal(tl.ptr.numpy(), np.asarray(jl.ptr))
    assert tlayouts.layout_names() == jlayouts.layout_names() == \
        ("d0", "d1", "d2", "d3")
    for name in tlayouts.layout_names():
        assert tlayouts.layout_lanes(name) == jlayouts.layout_lanes(name)
    with pytest.raises(ValueError):
        tlayouts.layout_lanes("d9")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax_and_no_reference():
    files = sorted(PORT_ROOT.rglob("*.py"))
    assert len(files) > 15
    bad = [(p.name, m) for p in files for m in _imports(p)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad
    modules = sorted(
        ".".join(("repro_torch",) + p.relative_to(PORT_ROOT).with_suffix("")
                 .parts).removesuffix(".__init__") for p in files)
    code = ("import importlib, sys\n"
            f"for m in {modules!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n"
            "print(len(sys.modules))\n")
    src = str(PORT_ROOT.parent)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=src))
    assert out.returncode == 0, out.stderr
