"""Port (repro_torch) ≡ reference (repro): LM serving of the SSM and
hybrid families (ROADMAP A14b): falcon-mamba-7b (Mamba1) and zamba2-7b
(Mamba2 with one shared attention block).

The layers (``causal_conv1d``, ``selective_scan``, ``ssd_chunked``,
``rms_norm_gated``, both mixers forward and decode) on inputs from
``np.random.default_rng``, and the reduced configs (``reduced_config``,
float32) end to end on the reference's weights (``params_from_jax``).
Tolerances, relative (max |port - ref| / max |ref|): 1e-5 for the layers,
1e-4 for logits; greedy tokens equal.  bfloat16 is held at the layer
level by the share of outputs bit-equal to the reference run op by op
(``python tests/test_torch_ssm.py`` prints the readings).
"""
import dataclasses
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.transformer as JT
from lm_parity import (LAYER_TOL, LOGIT_TOL, bf16, bit_share, jbf16, pair,
                       rel, tree_leaves)
from repro.configs import registry as jreg
from repro.models import layers as jlayers
from repro.models import ssm as jssm
from repro.serve import kv_cache as jkv
from repro_torch.configs import registry as treg
from repro_torch.models import layers as tlayers
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as TT
from repro_torch.serve import kv_cache as tkv
from repro_torch.serve.serve_step import generate

SSM_ARCHS = ("falcon-mamba-7b", "zamba2-7b")
B, PROMPT, NEW = 2, 40, 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Single-threaded PyTorch in this module: its tensors are small, and
    parallel test workers' thread pools would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def built():
    """The models ``pair`` built in this module, by arch."""
    return {}


def _pair(built, arch):
    if arch not in built:
        built[arch] = pair(arch, B, PROMPT, NEW)
    return built[arch]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _mixer(arch, dtype="float32", seed=1):
    """(config, the reference's first mixer, the port's view of it, mixer
    keywords, reference forward, port forward) from the reference's
    ``init`` in ``dtype``."""
    cfg = dataclasses.replace(jreg.reduced_config(jreg.get(arch)),
                              dtype=dtype)
    mix = JT.init(cfg, jax.random.PRNGKey(seed))["blocks"]["mixer"]
    lp = jax.tree_util.tree_map(
        lambda a: a[0] if cfg.family == "ssm" else a[0, 0], mix)
    tp = types.SimpleNamespace(**{
        k: bf16(v) if v.dtype == jnp.bfloat16 else _t(v)
        for k, v in lp.items()})
    if cfg.family == "ssm":
        kw = dict(d_inner=cfg.d_inner, n_state=cfg.ssm_state,
                  dt_rank=cfg.dt_rank)
        return cfg, lp, tp, kw, jssm.mamba1_forward, tssm.mamba1_forward
    kw = dict(d_inner=cfg.d_inner, n_state=cfg.ssm_state,
              n_heads=cfg.ssm_heads, head_dim=cfg.ssm_head_dim)
    return cfg, lp, tp, kw, jssm.mamba2_forward, tssm.mamba2_forward


@pytest.mark.parametrize("with_state", (False, True))
@pytest.mark.parametrize("width", (1, 4))
def test_causal_conv1d_equal_reference(with_state, width):
    """The conv's output (the bias added last) and its new state (the last
    W-1 inputs; none at width 1) ≡ the reference's, with and without a
    state prepended."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((B, 9, 24), dtype=np.float32)
    w = rng.standard_normal((width, 24), dtype=np.float32)
    b = rng.standard_normal((24,), dtype=np.float32)
    st = rng.standard_normal((B, width - 1, 24), dtype=np.float32) \
        if with_state else None
    got, gst = tlayers.causal_conv1d(_t(x), _t(w), _t(b),
                                     None if st is None else _t(st))
    want, wst = jlayers.causal_conv1d(jnp.asarray(x), jnp.asarray(w),
                                      jnp.asarray(b),
                                      None if st is None else jnp.asarray(st))
    assert rel(got, want) < LAYER_TOL
    assert tuple(gst.shape) == tuple(wst.shape) == (B, width - 1, 24)
    np.testing.assert_array_equal(gst.numpy(), np.asarray(wst))


@pytest.mark.parametrize("chunk", (1, 5, 8, 256))
def test_selective_scan_equal_reference(chunk):
    """The chunked scan (chunks of 1, 5, 8 and the whole 40: the
    associative scan at odd and even lengths) ≡ the reference's, and the
    chunk rule too."""
    rng = np.random.default_rng(12)
    s, d, n = PROMPT, 6, 4
    decay = np.exp(-rng.random((B, s, d, n), dtype=np.float32))
    inp = rng.standard_normal((B, s, d, n), dtype=np.float32)
    h0 = rng.standard_normal((B, d, n), dtype=np.float32)
    c_t = rng.standard_normal((B, s, n), dtype=np.float32)
    y, h = tssm.selective_scan(_t(decay), _t(inp), _t(h0), _t(c_t), chunk)
    wy, wh = jssm.selective_scan(*(jnp.asarray(a)
                                   for a in (decay, inp, h0, c_t)), chunk)
    assert rel(y, wy) < LAYER_TOL and rel(h, wh) < LAYER_TOL
    assert tssm.chunk_len(s, chunk) == {1: 1, 5: 5, 8: 8, 256: 40}[chunk]


@pytest.mark.parametrize("chunk", (4, 8, 32))
def test_ssd_chunked_equal_reference_and_sequential(chunk):
    """``ssd_chunked`` ≡ the reference's and ≡ the port's sequential oracle
    (``ssd_sequential_ref``, itself ≡ the reference's); at chunk 32 two
    chunks carry the state across."""
    rng = np.random.default_rng(13)
    s, h, dh, n = 64, 3, 8, 4
    xh = rng.standard_normal((B, s, h, dh), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, s, h), dtype=np.float32)))
    a = -np.exp(rng.standard_normal((h,), dtype=np.float32) * 0.3)
    b_t, c_t = (rng.standard_normal((B, s, n), dtype=np.float32)
                for _ in range(2))
    h0 = rng.standard_normal((B, h, dh, n), dtype=np.float32)
    args = (xh, dt, a, b_t, c_t, h0)
    y, hl = tssm.ssd_chunked(*map(_t, args), chunk=chunk)
    wy, wh = jssm.ssd_chunked(*map(jnp.asarray, args), chunk=chunk)
    assert rel(y, wy) < LAYER_TOL and rel(hl, wh) < LAYER_TOL
    sy, sh = tssm.ssd_sequential_ref(*map(_t, args))
    ry, rh = jssm.ssd_sequential_ref(*map(jnp.asarray, args))
    assert rel(sy, ry) < LAYER_TOL and rel(sh, rh) < LAYER_TOL
    assert rel(y, sy) < LAYER_TOL and rel(hl, sh) < LAYER_TOL


def test_rms_norm_gated_equal_reference():
    rng = np.random.default_rng(14)
    x = rng.standard_normal((B, 5, 64), dtype=np.float32)
    w = rng.standard_normal((64,), dtype=np.float32) * 0.1
    assert rel(tssm.rms_norm_gated(_t(x), _t(w)),
               jssm.rms_norm_gated(jnp.asarray(x), jnp.asarray(w))) \
        < LAYER_TOL


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_mixer_forward_and_decode_equal_reference(arch):
    """The mixer on the reference's weights: a forward from no state (the
    default chunk and chunk 8), a forward continuing from that state, and
    three decode steps: outputs and states ≡ the reference's."""
    cfg, lp, tp, kw, fj, ft = _mixer(arch)
    rng = np.random.default_rng(15)
    x = rng.standard_normal((B, 16, cfg.d_model), dtype=np.float32)
    for chunk in (8, None):
        ck = {} if chunk is None else {"chunk": chunk}
        with torch.no_grad():
            y, st = ft(tp, _t(x), **kw, **ck)
        wy, wst = fj(lp, jnp.asarray(x), **kw, **ck)
        assert rel(y, wy) < LAYER_TOL, chunk
        assert rel(st.ssm, wst.ssm) < LAYER_TOL
        assert rel(st.conv, wst.conv) < LAYER_TOL
    x2 = rng.standard_normal((B, 4, cfg.d_model), dtype=np.float32)
    with torch.no_grad():
        y, st = ft(tp, _t(x2), state=st, **kw)
    wy, wst = fj(lp, jnp.asarray(x2), state=wst, **kw)
    assert rel(y, wy) < LAYER_TOL and rel(st.ssm, wst.ssm) < LAYER_TOL
    for i in range(3):
        x1 = rng.standard_normal((B, 1, cfg.d_model), dtype=np.float32)
        with torch.no_grad():
            y, st = (tssm.mamba1_decode(tp, _t(x1), st, **kw)
                     if cfg.family == "ssm" else
                     ft(tp, _t(x1), state=st, chunk=1, **kw))
        wy, wst = (jssm.mamba1_decode(lp, jnp.asarray(x1), wst, **kw)
                   if cfg.family == "ssm" else
                   fj(lp, jnp.asarray(x1), state=wst, chunk=1, **kw))
        assert rel(y, wy) < LAYER_TOL, i
        assert rel(st.ssm, wst.ssm) < LAYER_TOL, i
    assert st.ssm.dtype == torch.float32


def _bf16_pairs(arch):
    """(name, port output, reference output) in bfloat16 on ``arch``'s
    reduced widths: the conv, the mixer's forward (chunk 8 and whole) and
    a decode step from its state, on the reference's bfloat16 weights; inputs
    from ``default_rng(3)``.  The reference runs op by op (under jit XLA
    keeps float32 between fused ops, so no rounding form matches both)."""
    cfg, lp, tp, kw, fj, ft = _mixer(arch, "bfloat16")
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, PROMPT, cfg.d_model), dtype=np.float32)
    xc = rng.standard_normal((B, PROMPT, lp["conv_w"].shape[1]),
                             dtype=np.float32)
    out = [("conv", tlayers.causal_conv1d(bf16(xc), tp.conv_w, tp.conv_b)[0],
            jlayers.causal_conv1d(jbf16(xc), lp["conv_w"], lp["conv_b"])[0])]
    with torch.no_grad():
        for chunk in (8, 256):
            y, st = ft(tp, bf16(x), chunk=chunk, **kw)
            wy, wst = fj(lp, jbf16(x), chunk=chunk, **kw)
            out.append((f"forward/{chunk}", y, wy))
        # the decode step from the reference's state, so only the step's
        # own arithmetic differs
        st = type(st)(bf16(wst.conv), _t(wst.ssm))
        x1 = rng.standard_normal((B, 1, cfg.d_model), dtype=np.float32)
        y, _ = ft(tp, bf16(x1), state=st, chunk=1, **kw)
    out.append(("decode", y, fj(lp, jbf16(x1), state=wst, chunk=1, **kw)[0]))
    return out


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_bf16_layers_equal_reference(arch):
    """bfloat16 against the reference's in bfloat16, by the share of
    outputs bit-equal (``silu`` and ``softplus`` in the reference's forms,
    each op rounded): the conv 1.0; the mixer's forward and decode at
    least 0.995 and within 1e-3 relative (the readings, PERF.md § 6:
    forward 0.9997-1.0, decode 1.0)."""
    for name, got, want in _bf16_pairs(arch):
        assert got.dtype == torch.bfloat16, name
        share = bit_share(got, want)
        if name == "conv":
            assert share == 1.0
        else:
            assert share >= 0.995, (name, share)
            assert rel(got.float(), want) < 1e-3, name


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_params_equal_reference(arch):
    """The parameter tree: every leaf's shape and dtype ≡ the reference's
    (``params_from_jax`` places each leaf once); ``init``'s starts ≡ the
    reference's (float32 ``a_log``, log(1..N) for Mamba1 and zeros for
    Mamba2, ``dt_bias`` -4.6, ``d_skip`` ones, zero norms and conv bias,
    N(0, 1/fan_in) matrices with the conv width as conv_w's fan-in); the
    count ≡ the reference tree's and the analytic count plus what it
    leaves out (the conv bias and ``dt_bias``; Mamba2 also ``norm_w``)."""
    cfg = treg.reduced_config(treg.get(arch))
    jp = JT.init(jreg.reduced_config(jreg.get(arch)), jax.random.PRNGKey(2))
    tp = TT.params_from_jax(cfg, jax.tree_util.tree_map(np.asarray, jp),
                            device="cpu")
    assert TT.param_count(tp) == JT.param_count(jp)
    got = TT.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    for layer, want in zip(got.layers(), tp.layers()):
        for name, p in want.named_parameters():
            q = getattr(layer, name)
            assert q.shape == p.shape and q.dtype == p.dtype, name
            if name == "a_log":                  # log: within an ulp
                assert rel(q, p.detach().numpy()) < 1e-6
            elif name in ("dt_bias", "d_skip", "conv_b", "norm_w", "ln",
                          "ln1", "ln2"):
                assert torch.equal(q, p), name
    layer = got.blocks[0]
    assert layer.a_log.dtype == torch.float32
    assert float(layer.dt_bias[0]) == pytest.approx(-4.6)
    assert float(layer.d_skip.min()) == float(layer.d_skip.max()) == 1.0
    std = float(layer.conv_w.std()) * math.sqrt(cfg.conv_width)
    assert abs(std - 1) < 0.1
    extra = 2 * cfg.d_inner if cfg.family == "ssm" else \
        (cfg.d_inner + 2 * cfg.ssm_state) + cfg.ssm_heads + cfg.d_inner
    assert TT.param_count(got) == cfg.param_count() + cfg.n_layers * extra


def test_zamba2_units_and_shared_block():
    """zamba2-7b at its published widths (on the meta device): 81 Mamba2
    layers in 13 units of 6 and a tail of 3, so the one shared block runs
    13 times and the cache holds 13 KV caches (the config's docstring says
    14; the reference's code gives 13)."""
    cfg = treg.get("zamba2-7b")
    net = TT.Transformer(cfg, device="meta")
    assert len(net.blocks) == 81 and net.shared_attn is not None
    assert divmod(cfg.n_layers, cfg.attn_every) == (13, 3)
    cache = tkv.init_cache(cfg, 1, 8, device="meta")
    assert cache["k"].shape[0] == 13
    assert tuple(cache["mamba"].ssm.shape[:2]) == (13, 6)
    assert cache["tail"].ssm.shape[0] == 3
    assert TT.param_count(net) == cfg.param_count() + 81 * (
        2 * cfg.d_inner + 2 * cfg.ssm_state + cfg.ssm_heads)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_cache_helpers_equal_reference(arch):
    """``init_cache`` ≡ the reference's tree (shapes, dtypes: the SSM
    states float32, the hybrid's tail and KV caches), zeros; ``pad_cache``
    passes SSM states through and grows the hybrid's KV caches as the
    reference does."""
    tcfg = treg.reduced_config(treg.get(arch))
    jcfg = jreg.reduced_config(jreg.get(arch))
    tc = tkv.init_cache(tcfg, 3, 20, device="cpu")
    jc = jkv.init_cache(jcfg, 3, 20)
    tl, jl = tree_leaves(tc), tree_leaves(jc)
    assert [p for p, _ in tl] == [p for p, _ in jl]
    for (path, g), (_, w) in zip(tl, jl):
        assert tuple(g.shape) == tuple(w.shape), path
        assert str(g.dtype).split(".")[-1] == str(w.dtype), path
        assert float(g.abs().max()) == 0.0
    rng = np.random.default_rng(16)
    jc = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape, np.float32)), jc)
    tc = jax.tree_util.tree_map(lambda a: _t(a), jc)
    if tcfg.family == "hybrid":
        tc = dict(tc, mamba=tssm.Mamba2State(*tc["mamba"]),
                  tail=tssm.Mamba2State(*tc["tail"]))
    else:
        tc = tssm.Mamba1State(*tc)
    got, want = tkv.pad_cache(tcfg, tc, 48), jkv.pad_cache(jcfg, jc, 48)
    for (path, g), (_, w) in zip(tree_leaves(got), tree_leaves(want)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), str(path))
    if tcfg.family == "hybrid":
        assert got["k"].shape[2] == 48
    else:
        assert got is tc


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_forward_logits_equal_reference(built, arch):
    """The full forward's logits ≡ the reference's within 1e-4; no aux
    loss."""
    jcfg, tcfg, jm, tm, jp, tp, _, _, (jb, tb, total) = _pair(built, arch)
    pos = np.broadcast_to(np.arange(total, dtype=np.int32), (B, total))

    def ref(p, b):
        x, _ = jm._embed_batch(p, b)
        h, _, _ = JT.forward(jcfg, p, x, jnp.asarray(pos), remat=False)
        return jm.logits(p, h).astype(jnp.float32)

    x, _ = tm._embed_batch(tp, tb)
    with torch.no_grad():
        h, aux, cache = TT.forward(tcfg, tp, x, _t(pos))
        got = tm.logits(tp, h).float()
    assert cache is None and float(aux) == 0.0
    assert rel(got, jax.jit(ref)(jp, jb)) < LOGIT_TOL


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_prefill_decode_and_generate_equal_reference(built, arch):
    """Prefill, then decode steps fed the reference's greedy tokens: the
    logits ≡ the reference's at every step within 1e-4, every cache leaf
    too (the states updated in place); ``generate``'s greedy tokens ≡ the
    reference's."""
    jcfg, tcfg, jm, tm, jp, tp, prefill, decode, (jb, tb, total) = \
        _pair(built, arch)
    jc, jl, jpos = prefill(jp, jb)
    tc, tl, tpos = tm.prefill(tp, tb, max_len=total + NEW)
    assert tpos == int(jpos) == total
    assert rel(tl, jl) < LOGIT_TOL
    tok = jnp.argmax(jl, -1).astype(jnp.int32)
    want = [np.asarray(tok)]
    for i in range(NEW - 1):
        jl, jc = decode(jp, jc, tok, jnp.int32(total + i))
        tl, tc2 = tm.decode(tp, tc, _t(tok), total + i)
        assert tc2 is tc
        assert rel(tl, jl) < LOGIT_TOL, f"decode step {i}"
        tok = jnp.argmax(jl, -1).astype(jnp.int32)
        want.append(np.asarray(tok))
    for (path, g), (_, w) in zip(tree_leaves(tc), tree_leaves(jc)):
        assert tuple(g.shape) == tuple(w.shape), path
        assert rel(g, w) < LOGIT_TOL, path
    got = generate(tm, tp, tb, NEW)
    np.testing.assert_array_equal(got.numpy(), np.stack(want, axis=1))


if __name__ == "__main__":
    # the readings behind the bfloat16 bounds: relative error and the
    # share of outputs bit-equal to the reference's, per arch and form
    torch.set_num_threads(1)
    for arch in SSM_ARCHS:
        for name, got, want in _bf16_pairs(arch):
            print(f"{arch:16s} {name:12s} relative "
                  f"{rel(got.float(), want):.3e}  bit-equal "
                  f"{bit_share(got, want):.4f}")
