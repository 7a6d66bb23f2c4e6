"""Port (repro_torch) ≡ reference (repro): the training pieces (ROADMAP
A14c) below the train step, on the same numpy inputs, float32.

- flash attention: the forward, its log-sum-exp and dq/dk/dv against
  ``jax.grad`` of the reference's ``flash_attention`` (its custom VJP),
  for (causal, window) ∈ {(T, 0), (T, 24), (F, 0)}, GQA, chunk 16, with
  and without a ``q_offset``;
- the schedule, global-norm clipping (float32 and bfloat16 grads) and the
  int8 error-feedback compression (bit-equal);
- ``SyntheticLM`` batches (bit-equal, a frontend included);
- one AdamW and one Adafactor update of every leaf on the reduced
  tinyllama, zamba2 and llama4: the stacked-leaf decay and factoring;
- checkpoints: the round trip (bfloat16 and a module included), a torn
  write ignored, GC, a shape mismatch raising; ``config_hash``.

Tolerances: 1e-5 relative (max |diff| / max |ref|) for layer outputs;
per leaf norm-relative 1e-4 for grads, params and optimizer state
(``train_parity``).
"""
import collections
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lm_parity import LAYER_TOL, rel
from repro.models import layers as jlayers
from repro.runtime import checkpoint as jckpt
from repro.train import compression as jcomp
from repro.train import data as jdata
from repro.train import optimizer as jopt
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as TT
from repro_torch.runtime import checkpoint as ckpt
from repro_torch.runtime import fault_tolerance as ft
from repro_torch.train import compression as tcomp
from repro_torch.train import data as tdata
from repro_torch.train import optimizer as topt
from train_parity import GRAD_TOL, configs, leaf_err, paths, port_leaves, \
    worst


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Single-threaded PyTorch in this module: its tensors are small, and
    parallel test workers' thread pools would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("causal,window", ((True, 0), (True, 24),
                                           (False, 0)))
@pytest.mark.parametrize("sq,q_offset", ((48, 0), (32, 16)))
def test_flash_attention_and_backward_equal_reference(causal, window, sq,
                                                      q_offset):
    """Forward, lse and dq/dk/dv ≡ the reference's (GQA 4 heads over 2 KV
    heads, chunk 16 over 48 keys: skipped blocks); the forward without
    grad ≡ the forward with it, bit for bit (serving's path)."""
    rng = np.random.default_rng(5)
    b, sk, h, kh, d, chunk = 2, 48, 4, 2, 16, 16
    q = rng.standard_normal((b, sq, h, d), dtype=np.float32)
    k, v = (rng.standard_normal((b, sk, kh, d), dtype=np.float32)
            for _ in range(2))
    do = rng.standard_normal((b, sq, h, d), dtype=np.float32)
    kw = dict(causal=causal, window=window, q_offset=q_offset, chunk=chunk)

    def ref_loss(q_, k_, v_):
        return jnp.sum(jlayers.flash_attention(q_, k_, v_, **kw) * do)

    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want_grads = jax.grad(ref_loss, argnums=(0, 1, 2))(jq, jk, jv)
    want, want_lse = jlayers._flash_fwd(jq, jk, jv, causal, window,
                                        q_offset, chunk, chunk)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tlayers.flash_attention(tq, tk, tv, **kw)
    out.backward(torch.from_numpy(do))
    _, lse = tlayers._flash_fwd(tq.detach(), tk.detach(), tv.detach(),
                                causal, window, q_offset, chunk, chunk)
    assert rel(out, want) < LAYER_TOL
    assert rel(lse, want_lse) < LAYER_TOL
    for name, t, g in zip("qkv", (tq, tk, tv), want_grads):
        assert leaf_err(t.grad, g) < GRAD_TOL, name
    with torch.no_grad():
        served = tlayers.flash_attention(tq, tk, tv, **kw)
    assert torch.equal(served, out.detach())


def test_schedule_clipping_and_compression_equal_reference():
    """The warmup + cosine schedule and AdamW's bias corrections as
    float32 tensors; clipping of float32 and bfloat16 grads (cast back to
    the grad's dtype); the int8 error feedback over two rounds, one scale
    over the stacked leaf: bit-equal to the reference."""
    oc = topt.OptConfig(lr=3e-4, warmup_steps=10, total_steps=100)
    joc = jopt.OptConfig(lr=3e-4, warmup_steps=10, total_steps=100)
    steps = np.arange(0, 121, 3, dtype=np.int32)
    got = topt.schedule(oc, torch.from_numpy(steps)).numpy()
    want = np.asarray(jopt.schedule(joc, jnp.asarray(steps)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[0] == 0 and abs(got[-1] - 3e-5) < 1e-10

    rng = np.random.default_rng(2)
    a = rng.standard_normal((3, 5, 7), dtype=np.float32)
    w = rng.standard_normal((40,), dtype=np.float32)
    clipped, gn = topt.clip_by_global_norm(
        [[torch.from_numpy(r) for r in a],
         [torch.from_numpy(w).to(torch.bfloat16)]], 1.0)
    want, jgn = jopt.clip_by_global_norm(
        {"a": jnp.asarray(a), "w": jnp.asarray(w, jnp.bfloat16)}, 1.0)
    assert rel(gn, jgn) < LAYER_TOL
    assert clipped[1][0].dtype == torch.bfloat16
    assert rel(torch.stack(clipped[0]), want["a"]) < LAYER_TOL
    np.testing.assert_array_equal(
        clipped[1][0].float().numpy(),
        np.asarray(want["w"].astype(jnp.float32)))

    err = [torch.zeros(5, 7) for _ in range(3)]
    jerr = jnp.zeros((3, 5, 7), jnp.float32)
    for scale in (0.1, 0.03):
        g = rng.standard_normal((3, 5, 7), dtype=np.float32) * scale
        deq, err = tcomp.compress_decompress(
            [torch.from_numpy(r) for r in g], err)
        jdeq, jerr = jcomp.compress_decompress(jnp.asarray(g), jerr)
        np.testing.assert_array_equal(torch.stack(deq).numpy(),
                                      np.asarray(jdeq))
        np.testing.assert_array_equal(torch.stack(err).numpy(),
                                      np.asarray(jerr))


def test_synthetic_lm_equal_reference():
    """``SyntheticLM`` batches ≡ the reference's bit for bit (tokens,
    labels, the frontend's embeddings), from ``iterate`` and through
    ``PrefetchIterator`` too."""
    args = (97, 24, 3)
    kw = dict(seed=4, frontend_tokens=4, d_model=8)
    got, want = tdata.SyntheticLM(*args, **kw), jdata.SyntheticLM(*args, **kw)
    it = tdata.PrefetchIterator(got.iterate(5), depth=2)
    for step in (5, 6, 7):
        b, ref_ = next(it), want.batch_at(step)
        assert set(b) == set(ref_) == {"tokens", "labels", "frontend"}
        for key in b:
            np.testing.assert_array_equal(b[key], ref_[key])
        assert b["tokens"].shape == (3, 20)


def _perturbed(arch, seed):
    """The port's modules with every parameter, and a grad a leaf, drawn
    from ``default_rng(seed)`` (the norms non-zero, so that decay shows)
    → (config, leaves, the reference's params and grads, the port's
    grads)."""
    _, cfg = configs(arch)
    leaves = TT.leaf_map(cfg, TT.Transformer(cfg, device="cpu"))
    rng = np.random.default_rng(seed)
    params, grads = {}, {}
    for leaf in leaves:
        params[leaf.path] = rng.standard_normal(leaf.shape,
                                                dtype=np.float32) * 0.1
        grads[leaf.path] = rng.standard_normal(leaf.shape,
                                               dtype=np.float32) * 1e-2
    with torch.no_grad():
        for leaf in leaves:
            for p, row in zip(leaf.params, TT.rows(
                    leaf, torch.from_numpy(params[leaf.path]))):
                p.copy_(row)

    def tree(values):
        out = {}
        for path, val in values.items():
            node = out
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = jnp.asarray(val)
        return out

    tgrads = [TT.rows(leaf, torch.from_numpy(grads[leaf.path]))
              for leaf in leaves]
    return cfg, leaves, tree(params), tree(grads), tgrads


@pytest.mark.parametrize("kind", ("adamw", "adafactor"))
@pytest.mark.parametrize("arch", ("tinyllama-1.1b", "zamba2-7b",
                                  "llama4-maverick-400b-a17b"))
def test_optimizer_update_equals_reference(arch, kind):
    """One update from the same params and grads ≡ the reference's for
    every leaf: the params, the grad norm and lr, and the state in the
    reference's stacked shapes.  Decay follows the stacked rank: every
    layer's norms ((L, d)) move by it, ``final_norm`` ((d,)) does not;
    Adafactor factors a stacked (L, d) leaf across layers (``vr`` (L,),
    ``vc`` (d,)) and zamba2's (U, period, d) into ``vr`` (U, period)."""
    cfg, leaves, jp, jg, tg = _perturbed(arch, 11)
    oc = topt.OptConfig(kind=kind, lr=1e-2, warmup_steps=1)
    joc = jopt.OptConfig(kind=kind, lr=1e-2, warmup_steps=1)
    state, metrics = topt.update(oc, leaves, tg, topt.init_opt(oc, leaves))
    jnew, jstate, jmetrics = jax.jit(lambda g, s, p: jopt.update(
        joc, g, s, p))(jg, jopt.init_opt(joc, jp), jp)
    key, err = worst(port_leaves(leaves), paths(jnew))
    assert err < GRAD_TOL, (key, err)
    for name in ("grad_norm", "lr"):
        assert rel(metrics[name], jmetrics[name]) < 1e-6, name
    assert int(state.step) == 1
    fields = ("mu", "nu") if kind == "adamw" else ("vr", "vc")
    by_key = {leaf.key: leaf.path for leaf in leaves}
    for field in fields:
        got = {by_key[k]: v for k, v in getattr(state, field).items()}
        key, err = worst(got, paths(getattr(jstate, field)))
        assert err < GRAD_TOL, (field, key, err)
    if kind == "adafactor":
        norm = next(leaf for leaf in leaves if leaf.path[0] == "blocks"
                    and leaf.path[-1] in ("ln", "ln1"))
        assert tuple(state.vr[norm.key].shape) == norm.lead
        assert tuple(state.vc[norm.key].shape) == \
            norm.lead[:-1] + (cfg.d_model,)
        assert tuple(state.vr["final_norm"].shape) == (cfg.d_model,)
        assert tuple(state.vc["final_norm"].shape) == ()
        if arch == "zamba2-7b":
            assert norm.lead == (2, 3)


Tiny = collections.namedtuple("Tiny", "step mu")


def _tree(seed):
    g = torch.Generator().manual_seed(seed)
    net = torch.nn.Linear(3, 2)
    with torch.no_grad():
        net.weight.copy_(torch.randn(2, 3, generator=g))
    return {"a": torch.randn(16, 8, generator=g),
            "nested": {"b": torch.randn(3, generator=g).to(torch.bfloat16),
                       "c": torch.tensor(7, dtype=torch.int32)},
            "t": (torch.randn(2, 2, generator=g),),
            "state": Tiny(torch.tensor(3), {"w.x": torch.randn(4,
                                                               generator=g)}),
            "none": None, "net": net}


def _leaves_equal(a, b):
    fa, fb = ckpt._flatten(a), ckpt._flatten(b)
    assert set(fa) == set(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, k
        assert torch.equal(fa[k].view(torch.int16) if fa[k].dtype ==
                           torch.bfloat16 else fa[k],
                           fb[k].view(torch.int16) if fb[k].dtype ==
                           torch.bfloat16 else fb[k]), k


def test_checkpoint_round_trip_commit_gc_and_shapes(tmp_path):
    """The round trip is exact (bfloat16 as its bits, int32, a NamedTuple,
    None, a module loaded in place; ``remesh`` onto a device); the
    manifest lists every key with its dtype; a directory without a
    manifest (a torn write) is ignored; the async writer keeps the last
    ``keep``; a shape mismatch raises ValueError and a missing key
    KeyError; ``config_hash`` ≡ the reference's."""
    d = str(tmp_path / "a")
    tree = _tree(0)
    ckpt.save(d, 5, tree, extra={"note": "x"})
    assert ckpt.latest_step(d) == 5
    like = _tree(1)
    restored, extra = ckpt.restore(d, 5, like)
    assert extra == {"note": "x"} and restored["net"] is like["net"]
    assert restored["none"] is None and isinstance(restored["state"], Tiny)
    _leaves_equal(restored, tree)
    moved, _ = ft.remesh(d, 5, _tree(2), torch.device("cpu"))
    _leaves_equal(moved, tree)
    with open(os.path.join(d, "step_000000005", "manifest.json")) as f:
        keys = __import__("json").load(f)["keys"]
    assert keys["nested::b"] == [[3], "bfloat16"]
    assert keys["net::weight"] == [[2, 3], "float32"]

    os.makedirs(os.path.join(d, "step_000000009"))      # a torn write
    assert ckpt.latest_step(d) == 5

    cp = ckpt.AsyncCheckpointer(str(tmp_path / "b"), keep=2)
    for s in (1, 2, 3, 4):
        cp.save(s, tree)
    cp.wait()
    assert sorted(os.listdir(tmp_path / "b")) == ["step_000000003",
                                                  "step_000000004"]

    bad = _tree(3)
    bad["a"] = torch.zeros(4, 4)
    with pytest.raises(ValueError):
        ckpt.restore(d, 5, bad)
    bad = _tree(3)
    bad["extra_leaf"] = torch.zeros(1)
    with pytest.raises(KeyError):
        ckpt.restore(d, 5, bad)
    for arch in ("tinyllama-1.1b", "zamba2-7b"):
        jcfg, tcfg = configs(arch)
        assert ckpt.config_hash(tcfg) == jckpt.config_hash(jcfg)
