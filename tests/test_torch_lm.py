"""Port (repro_torch) ≡ reference (repro): the LM serving path of the
attention families (dense, audio, vlm; ROADMAP A14a).

The reduced configs (``reduced_config``, float32) of the six attention
archs: tinyllama-1.1b, internlm2-20b (rope θ 1e6), h2o-danube-1.8b and
h2o-danube-3-4b (SWA, the reduced window 32), musicgen-large (audio
prefix, MHA) and paligemma-3b (vlm prefix, MQA).  Both packages get the
same weights (the reference's ``init`` carried over by
``params_from_jax``) and the same tokens and prefix embeddings from
``np.random.default_rng``.  Tolerances, each relative (max |port - ref| /
max |ref|): 1e-5 for the layers, 1e-4 for logits (the reference's own
bound, ``tests/test_models.py``); greedy tokens are equal.  The bfloat16
forms are held at the layer level, with bounds measured on their inputs.
Also: all ten configs and their parameter counts, an unknown layer
pattern, the frontend and KV cache helpers, and ``serve --mode lm
--device cpu``.  The MoE, SSM and hybrid families: ``test_torch_moe`` and
``test_torch_ssm``.
"""
import dataclasses
import inspect
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.transformer as JT
from lm_parity import LAYER_TOL, LOGIT_TOL
from lm_parity import bf16 as _bf16
from lm_parity import bit_share as _bit_share
from lm_parity import pair
from lm_parity import rel as _rel
from repro.configs import base as jbase
from repro.configs import registry as jreg
from repro.models import frontends as jfront
from repro.models import layers as jlayers
from repro.models.model import Model as JModel
from repro.serve import kv_cache as jkv
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg
from repro_torch.launch import serve
from repro_torch.models import frontends as tfront
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as TT
from repro_torch.models.model import Model as TModel
from repro_torch.serve import kv_cache as tkv
from repro_torch.serve.serve_step import generate

ATTN_ARCHS = ("tinyllama-1.1b", "internlm2-20b", "h2o-danube-1.8b",
              "h2o-danube-3-4b", "musicgen-large", "paligemma-3b")
B, PROMPT, NEW = 2, 40, 8        # 40 + 8 > the reduced window of 32


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
    """The models ``_pair`` built in this module, by arch."""
    return {}


def _pair(built, arch):
    """``lm_parity.pair`` for ``arch``'s reduced config, built once per
    arch."""
    if arch not in built:
        built[arch] = pair(arch, B, PROMPT, NEW)
    return built[arch]


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_layers_equal_reference(arch):
    """rms_norm, apply_rope, flash_attention (chunks of 8 < S = 40, so
    blocks are skipped; and the default chunk) and decode_attention (the
    ring buffer past its wrap, or the full cache) ≡ the reference's."""
    cfg = treg.reduced_config(treg.get(arch))
    rng = np.random.default_rng(3)
    h, kv, hd, s = cfg.n_heads, cfg.n_kv, cfg.hd, PROMPT
    x = rng.standard_normal((B, s, cfg.d_model), dtype=np.float32)
    w = rng.standard_normal((cfg.d_model,), dtype=np.float32) * 0.1
    assert _rel(tlayers.rms_norm(torch.from_numpy(x), torch.from_numpy(w)),
                jlayers.rms_norm(jnp.asarray(x), jnp.asarray(w))) \
        < LAYER_TOL
    q, k, v = (rng.standard_normal((B, s, n, hd), dtype=np.float32)
               for n in (h, kv, kv))
    pos = np.broadcast_to(np.arange(s, dtype=np.int32) + 5, (B, s))
    assert _rel(tlayers.apply_rope(torch.from_numpy(q), torch.from_numpy(
        pos.copy()), cfg.rope_theta), jlayers.apply_rope(
        jnp.asarray(q), jnp.asarray(pos), cfg.rope_theta)) < LAYER_TOL
    for chunk in (8, None):
        got = tlayers.flash_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            window=cfg.window, chunk=chunk)
        want = jlayers.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), window=cfg.window,
                                       chunk=chunk)
        assert _rel(got, want) < LAYER_TOL, chunk
    sc = cfg.window or s
    kc, vc = (rng.standard_normal((B, sc, kv, hd), dtype=np.float32)
              for _ in range(2))
    q1 = rng.standard_normal((B, 1, h, hd), dtype=np.float32)
    for p in ((sc - 1, sc + 13) if cfg.window else (sc - 1, 17)):
        got = tlayers.decode_attention(torch.from_numpy(q1),
                                       torch.from_numpy(kc),
                                       torch.from_numpy(vc), p,
                                       window=cfg.window)
        want = jlayers.decode_attention(jnp.asarray(q1), jnp.asarray(kc),
                                        jnp.asarray(vc), jnp.int32(p),
                                        window=cfg.window)
        assert _rel(got, want) < LAYER_TOL, p


def _bf16_pairs(arch):
    """(name, port output, reference output) for the bfloat16 forms on
    ``arch``'s reduced widths, inputs from ``default_rng(3)``, and the
    logits of a float32 head (the form the port must not use) last."""
    cfg = treg.reduced_config(treg.get(arch))
    rng = np.random.default_rng(3)
    h, kv, hd, s = cfg.n_heads, cfg.n_kv, cfg.hd, PROMPT
    q, k, v = (rng.standard_normal((B, s, n, hd), dtype=np.float32)
               for n in (h, kv, kv))
    out = [("flash", tlayers.flash_attention(
        _bf16(q), _bf16(k), _bf16(v), window=cfg.window, chunk=8),
        jlayers.flash_attention(
            *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
            window=cfg.window, chunk=8))]
    sc = cfg.window or s
    kc, vc = (rng.standard_normal((B, sc, kv, hd), dtype=np.float32)
              for _ in range(2))
    q1 = rng.standard_normal((B, 1, h, hd), dtype=np.float32)
    for p in ((sc - 1, sc + 13) if cfg.window else (sc - 1, 17)):
        out.append((f"decode@{p}", tlayers.decode_attention(
            _bf16(q1), _bf16(kc), _bf16(vc), p, window=cfg.window),
            jlayers.decode_attention(
                *(jnp.asarray(a, jnp.bfloat16) for a in (q1, kc, vc)),
                jnp.int32(p), window=cfg.window)))
    x = rng.standard_normal((B, s, cfg.d_model), dtype=np.float32)
    w = rng.standard_normal((cfg.d_model,), dtype=np.float32) * 0.1
    out.append(("rms_norm", tlayers.rms_norm(_bf16(x), _bf16(w)),
                jlayers.rms_norm(jnp.asarray(x, jnp.bfloat16),
                                 jnp.asarray(w, jnp.bfloat16))))
    mats = [rng.standard_normal(shape, dtype=np.float32) / math.sqrt(shape[0])
            for shape in ((cfg.d_model, cfg.d_ff), (cfg.d_model, cfg.d_ff),
                          (cfg.d_ff, cfg.d_model))]
    out.append(("swiglu", tlayers.swiglu(_bf16(x), *(_bf16(m) for m in mats)),
                jlayers.swiglu(*(jnp.asarray(a, jnp.bfloat16)
                                 for a in [x] + mats))))
    # the logits on the reference's weights, in cfg.dtype
    jcfg = dataclasses.replace(jreg.reduced_config(jreg.get(arch)),
                               dtype="bfloat16")
    tcfg = dataclasses.replace(cfg, dtype="bfloat16")
    jm, tm = JModel(jcfg), TModel(tcfg)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tp = TT.params_from_jax(tcfg, jax.tree_util.tree_map(np.asarray, jp),
                            device="cpu")
    hid = _bf16(rng.standard_normal((B, 3, cfg.d_model), dtype=np.float32))
    want = jm.logits(jp, jnp.asarray(hid.float().numpy(), jnp.bfloat16))
    out.append(("logits", tm.logits(tp, hid), want))
    head = tp.embed.t() if tcfg.tie_embeddings else tp.lm_head
    out.append(("logits_f32", tlayers.rms_norm(hid, tp.final_norm).float()
                @ head.float(), want))
    return out


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_bf16_layers_and_logits_equal_reference(arch):
    """The bfloat16 forms against the reference's in bfloat16: rms_norm
    cast back, flash_attention (p cast to v's dtype before the PV
    product), decode_attention (likewise), swiglu in x's dtype and the
    logits in ``cfg.dtype``; every output in bfloat16.

    The two packages' exp differ in the last float32 bits, so attention
    outputs flip a bf16 rounding here and there, and a bound on the
    largest error cannot tell a missing cast of p.  The bounds are on the
    share of outputs bit-equal to the reference's, set from the readings
    that ``python tests/test_torch_lm.py`` prints (PERF.md § 6): at least
    0.75 for flash_attention and 0.72 for decode_attention, each also
    within 1e-2 relative (2.5 bf16 ulps); a copy of the port without the
    cast of p fails both.  rms_norm: a share of at least 0.99.  swiglu
    within 1e-2.  The logits within 1e-3 relative, which logits computed
    in float32 exceed (checked here)."""
    pairs = {name: (got, want) for name, got, want in _bf16_pairs(arch)}
    for name, (got, want) in pairs.items():
        if name == "logits_f32":
            assert _rel(got, want) > 1e-3
            continue
        assert got.dtype == torch.bfloat16, name
        rel, share = _rel(got.float(), want), _bit_share(got, want)
        if name == "logits":
            assert rel < 1e-3
        elif name == "rms_norm":
            assert share >= 0.99
        else:
            assert rel < 1e-2, name
            if name != "swiglu":
                assert share >= (0.75 if name == "flash" else 0.72), name


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_forward_logits_equal_reference(built, arch):
    """The full forward's logits (prefix positions included) ≡ the
    reference's within 1e-4."""
    jcfg, tcfg, jm, tm, jp, tp, _, _, (jb, tb, total) = _pair(built, arch)
    pos = np.broadcast_to(np.arange(total, dtype=np.int32), (B, total))

    def ref(p, b):
        x, _ = jm._embed_batch(p, b)
        h, _, _ = JT.forward(jcfg, p, x, jnp.asarray(pos), remat=False)
        return jm.logits(p, h).astype(jnp.float32)

    x, _ = tm._embed_batch(tp, tb)
    with torch.no_grad():
        h, aux, cache = TT.forward(tcfg, tp, x, torch.from_numpy(pos.copy()))
        got = tm.logits(tp, h).float()
    assert cache is None and float(aux) == 0.0
    assert got.shape == (B, total, tcfg.vocab)
    assert _rel(got, jax.jit(ref)(jp, jb)) < LOGIT_TOL


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_prefill_decode_and_generate_equal_reference(built, arch):
    """Prefill, then decode steps fed the reference's greedy tokens
    (teacher-forced): the logits ≡ the reference's at every step within
    1e-4, the caches too; ``generate``'s greedy tokens ≡ the reference's.
    The prompt outruns the reduced window, so the SWA archs clip their
    prefill cache into the ring and wrap it while decoding."""
    jcfg, tcfg, jm, tm, jp, tp, prefill, decode, (jb, tb, total) = \
        _pair(built, arch)
    jc, jl, jpos = prefill(jp, jb)
    tc, tl, tpos = tm.prefill(tp, tb, max_len=total + NEW)
    assert tpos == int(jpos) == total
    sc = tkv.cache_seq_len(tcfg, total + NEW)
    assert tuple(tc["k"].shape) == tuple(jc["k"].shape) == \
        (tcfg.n_layers, B, sc, tcfg.n_kv, tcfg.hd)
    assert _rel(tc["k"], jc["k"]) < LOGIT_TOL
    assert _rel(tl, jl) < LOGIT_TOL
    tok = jnp.argmax(jl, -1).astype(jnp.int32)
    want = [np.asarray(tok)]
    for i in range(NEW - 1):
        jl, jc = decode(jp, jc, tok, jnp.int32(total + i))
        tl, tc = tm.decode(tp, tc, torch.from_numpy(np.array(tok)),
                           total + i)
        assert _rel(tl, jl) < LOGIT_TOL, f"decode step {i}"
        tok = jnp.argmax(jl, -1).astype(jnp.int32)
        want.append(np.asarray(tok))
    assert _rel(tc["v"], jc["v"]) < LOGIT_TOL
    got = generate(tm, tp, tb, NEW)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.stack(want, axis=1))


def test_tied_embeddings_and_sampling():
    """Tied embeddings (no ``lm_head``: the head is the embedding's
    transpose) ≡ the reference; temperature sampling draws from the
    ``torch.Generator`` it is given (not held to jax.random)."""
    jcfg = dataclasses.replace(jreg.reduced_config(jreg.get("paligemma-3b")),
                               tie_embeddings=True)
    tcfg = dataclasses.replace(treg.reduced_config(treg.get("paligemma-3b")),
                               tie_embeddings=True)
    jm, tm = JModel(jcfg), TModel(tcfg)
    jp = jm.init_params(jax.random.PRNGKey(4))
    assert "lm_head" not in jp
    tp = TT.params_from_jax(tcfg, jax.tree_util.tree_map(np.asarray, jp),
                            device="cpu")
    assert tp.lm_head is None and tp.frontend_norm is not None
    rng = np.random.default_rng(5)
    h = rng.standard_normal((B, 3, jcfg.d_model), dtype=np.float32)
    assert _rel(tm.logits(tp, torch.from_numpy(h)),
                jm.logits(jp, jnp.asarray(h))) < LOGIT_TOL
    toks = torch.from_numpy(rng.integers(0, 256, (B, 12)).astype(np.int32))
    fe = torch.from_numpy(rng.standard_normal(
        (B, tcfg.frontend_tokens, tcfg.d_model), dtype=np.float32))
    batch = {"tokens": toks, "frontend": fe}
    draws = [generate(tm, tp, batch, 6, temperature=1.0,
                      generator=torch.Generator().manual_seed(s))
             for s in (1, 1, 2)]
    assert torch.equal(draws[0], draws[1])
    assert not torch.equal(draws[0], draws[2])
    assert all(int(d.min()) >= 0 and int(d.max()) < tcfg.vocab
               for d in draws)


def test_configs_equal_reference():
    """All ten configs, their reduced forms, the derived widths and the
    parameter counts ≡ the reference's; the shape table and
    ``cell_runnable`` too."""
    tall, jall = treg.all_archs(), jreg.all_archs()
    assert sorted(tall) == sorted(jall) and len(tall) == 10
    fields = [f.name for f in dataclasses.fields(jbase.ModelConfig)]
    assert fields == [f.name for f in dataclasses.fields(tbase.ModelConfig)]
    for name in tall:
        for t, j in ((tall[name], jall[name]),
                     (treg.reduced_config(tall[name]),
                      jreg.reduced_config(jall[name]))):
            assert dataclasses.asdict(t) == dataclasses.asdict(j), name
            for prop in ("hd", "d_inner", "ssm_heads", "dt_rank"):
                assert getattr(t, prop) == getattr(j, prop), (name, prop)
            assert t.param_count() == j.param_count(), name
            assert t.active_param_count() == j.active_param_count(), name
        for shape in jbase.SHAPES:
            assert tbase.cell_runnable(tall[name], tbase.get_shape(
                shape.name)) == jbase.cell_runnable(jall[name], shape)
    assert [dataclasses.astuple(s) for s in tbase.SHAPES] == \
        [dataclasses.astuple(s) for s in jbase.SHAPES]
    # the served arch at its published widths: ~1.1B parameters
    cfg = treg.get("tinyllama-1.1b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.d_ff,
            cfg.vocab, cfg.dtype) == (22, 2048, 32, 4, 5632, 32000,
                                      "bfloat16")
    assert 1.0e9 < cfg.param_count() < 1.2e9


@pytest.mark.parametrize("change", (dict(family="rnn"), dict(moe_every=3)))
def test_unknown_layer_pattern_raises(change):
    """Every family of the registry runs (``test_torch_ssm``,
    ``test_torch_moe``); a family the reference does not know, or an MoE
    interleave its ``init`` does not stack, raises ValueError."""
    cfg = dataclasses.replace(
        treg.reduced_config(treg.get("grok-1-314b")), **change)
    with pytest.raises(ValueError):
        TModel(cfg)
    with pytest.raises(ValueError):
        tkv.init_cache(cfg, 2, 16, device="cpu")
    with pytest.raises(ValueError):
        TT.Transformer(cfg, device="meta")


def test_init_and_kv_cache_helpers():
    """``init`` draws N(0, 1/fan_in) in float32 and casts to the config's
    dtype, norms zero, reproducibly from its generator; ``init_cache``,
    ``pad_cache`` and ``cache_seq_len`` ≡ the reference's shapes and
    values; a position past a full-attention cache raises."""
    cfg = dataclasses.replace(treg.reduced_config(treg.get("tinyllama-1.1b")),
                              dtype="bfloat16")
    nets = [TT.init(cfg, torch.Generator().manual_seed(s), device="cpu")
            for s in (0, 0)]
    blk = nets[0].blocks[0]
    assert blk.wq.dtype == torch.bfloat16 and blk.wq.requires_grad
    assert torch.equal(blk.w_down, nets[1].blocks[0].w_down)
    assert float(blk.ln1.abs().max()) == 0.0
    # 16,384 draws: the sample std lies within 5% of 1/sqrt(fan_in)
    std = float(nets[0].lm_head.float().std())
    assert abs(std * math.sqrt(cfg.d_model) - 1) < 0.05
    assert TT.param_count(nets[0]) == cfg.param_count()
    for arch in ("tinyllama-1.1b", "h2o-danube-1.8b"):
        tcfg = treg.reduced_config(treg.get(arch))
        jcfg = jreg.reduced_config(jreg.get(arch))
        for n in (16, 40, 64):
            assert tkv.cache_seq_len(tcfg, n) == jkv.cache_seq_len(jcfg, n)
        tc = tkv.init_cache(tcfg, 2, 48, device="cpu")
        jc = jkv.init_cache(jcfg, 2, 48)
        assert tuple(tc["k"].shape) == tuple(jc["k"].shape)
        assert tc["v"].dtype == torch.float32
        kv = np.random.default_rng(1).standard_normal(
            (tcfg.n_layers, 2, 10, tcfg.n_kv, tcfg.hd), dtype=np.float32)
        got = tkv.pad_cache(tcfg, {"k": torch.from_numpy(kv),
                                   "v": torch.from_numpy(kv)}, 48)
        want = jkv.pad_cache(jcfg, {"k": jnp.asarray(kv),
                                    "v": jnp.asarray(kv)}, 48)
        np.testing.assert_array_equal(got["k"].numpy(), np.asarray(want["k"]))
    # the builders run on the card unless the caller asks for the CPU
    for fn in (TT.init, TT.params_from_jax, TT.Transformer,
               TModel.init_params, tkv.init_cache,
               tfront.synth_frontend_embeds):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    tm = TModel(tcfg := treg.reduced_config(treg.get("tinyllama-1.1b")))
    tp = tm.init_params(torch.Generator().manual_seed(0), device="cpu")
    cache = tkv.init_cache(tcfg, 1, 4, device="cpu")
    with pytest.raises(ValueError, match="past the cache"):
        tm.decode(tp, cache, torch.zeros((1,), dtype=torch.int32), 4)


@pytest.mark.parametrize("arch", ("musicgen-large", "paligemma-3b"))
def test_frontend_helpers(arch):
    """``frontend_input_shape`` ≡ the reference's for all ten configs;
    ``apply_frontend`` ≡ the reference's within 1e-5 on the same weights;
    ``synth_frontend_embeds`` draws unit gaussians of that shape in
    ``cfg.dtype`` from its generator, reproducibly."""
    for name in treg.all_archs():
        assert tfront.frontend_input_shape(treg.get(name), 3) == \
            jfront.frontend_input_shape(jreg.get(name), 3)
    jcfg = jreg.reduced_config(jreg.get(arch))
    tcfg = treg.reduced_config(treg.get(arch))
    rng = np.random.default_rng(9)
    w = rng.standard_normal((tcfg.d_model,), dtype=np.float32) * 0.1
    fe = rng.standard_normal((B, tcfg.frontend_tokens, tcfg.d_model),
                             dtype=np.float32)
    got = tfront.apply_frontend(tcfg, types.SimpleNamespace(
        frontend_norm=torch.from_numpy(w)), torch.from_numpy(fe))
    assert _rel(got, jfront.apply_frontend(jcfg, {"frontend_norm": w},
                                           jnp.asarray(fe))) < LAYER_TOL
    draws = [tfront.synth_frontend_embeds(
        tcfg, torch.Generator().manual_seed(s), 4, device="cpu")
        for s in (0, 0, 1)]
    assert draws[0].shape == tfront.frontend_input_shape(tcfg, 4)
    assert draws[0].dtype == torch.float32 and draws[0].device.type == "cpu"
    assert torch.equal(draws[0], draws[1])
    assert not torch.equal(draws[0], draws[2])
    assert abs(float(draws[0].std()) - 1) < 0.05


def test_serve_lm_cpu(capsys):
    """``serve --mode lm --device cpu`` serves the reduced tinyllama-1.1b
    and prints tok/s; the same seed gives the same tokens.  Every mode of
    the reference is served (no ``NOT_PORTED`` table is left); a mode it
    lacks exits."""
    argv = ["--mode", "lm", "--device", "cpu", "--batch-size", "4"]
    out = serve.main(argv)
    assert "tok/s" in capsys.readouterr().out
    assert out["tok_per_s"] > 0 and out["tokens"].shape == (4, 16)
    np.testing.assert_array_equal(serve.main(argv)["tokens"], out["tokens"])
    assert not hasattr(serve, "NOT_PORTED")
    with pytest.raises(SystemExit):
        serve.main(["--mode", "sql", "--device", "cpu"])


if __name__ == "__main__":
    # the readings behind the bfloat16 bounds: relative error and the
    # share of outputs bit-equal to the reference's, per arch and form
    torch.set_num_threads(1)
    for arch in ATTN_ARCHS:
        for name, got, want in _bf16_pairs(arch):
            rel = _rel(got.float(), want)
            print(f"{arch:16s} {name:12s} relative {rel:.3e}  bit-equal "
                  f"{_bit_share(got, want):.3f}")
