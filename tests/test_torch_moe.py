"""Port (repro_torch) ≡ reference (repro): LM serving of the MoE family
(ROADMAP A14b): grok-1-314b (every layer attention + MoE, top-2) and
llama4-maverick-400b-a17b (dense and MoE layers interleaved, top-1).

``moe_ffn`` (GShard's grouped one-hot dispatch: groups, capacity drops,
the aux loss, the dropped share) on inputs from ``np.random.default_rng``,
and the reduced configs (``reduced_config``, float32, dropless) end to end
on the reference's weights (``params_from_jax``).  Tolerances, relative
(max |port - ref| / max |ref|): 1e-5 for the layers, 1e-4 for logits;
greedy tokens equal.  bfloat16 is held at the layer level by the share of
outputs bit-equal to the reference run op by op (``python
tests/test_torch_moe.py`` prints the readings).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.transformer as JT
from lm_parity import (LAYER_TOL, LOGIT_TOL, bf16, bit_share, jbf16, pair,
                       rel, tree_leaves)
from repro.configs import registry as jreg
from repro.models import moe as jmoe
from repro.serve import kv_cache as jkv
from repro_torch.configs import registry as treg
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as TT
from repro_torch.models.model import Model as TModel
from repro_torch.serve import kv_cache as tkv
from repro_torch.serve.serve_step import generate

MOE_ARCHS = ("grok-1-314b", "llama4-maverick-400b-a17b")
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


def _experts(rng, t, d, e, f, router_scale=1.0):
    """Tokens (t, d), a float32 router (d, E) and the experts' weights."""
    x = rng.standard_normal((t, d), dtype=np.float32)
    rw = rng.standard_normal((d, e)) * router_scale / np.sqrt(d)
    ws = [rng.standard_normal(s) / np.sqrt(s[1])
          for s in ((e, d, f), (e, d, f), (e, f, d))]
    return x, rw.astype(np.float32), [w.astype(np.float32) for w in ws]


@pytest.mark.parametrize("capacity", (None, 1.25, 0.5))
@pytest.mark.parametrize("groups", (1, 2, 4, 5))
def test_moe_ffn_equal_reference(groups, capacity):
    """``moe_ffn`` ≡ the reference's: output within 1e-5, the aux loss and
    the dropped share within 1e-6, the experts it reports each token routed
    to ≡ the reference router's top-k (the float32 rounding of a mean: XLA
    multiplies by 1/n where PyTorch divides), dropless and under capacities
    that drop (0.5 always; 1.25 with the groups' skew), in 1, 2 and 4
    groups, and 5, which does not divide the 48 tokens and falls back to
    one group, as the reference's does."""
    rng = np.random.default_rng(21)
    x, rw, ws = _experts(rng, 48, 16, 4, 24, router_scale=3.0)
    got, gm = tmoe.moe_ffn(_t(x), _t(rw), *map(_t, ws), top_k=2,
                           capacity_factor=capacity, n_groups=groups)
    want, wm = jmoe.moe_ffn(jnp.asarray(x), jnp.asarray(rw),
                            *map(jnp.asarray, ws), top_k=2,
                            capacity_factor=capacity, n_groups=groups)
    assert rel(got, want) < LAYER_TOL
    assert abs(float(gm.dropped_frac) - float(wm.dropped_frac)) < 1e-6
    assert abs(float(gm.aux_loss) - float(wm.aux_loss)) < 1e-6
    _, top = jax.lax.top_k(jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(rw)),
                           2)
    np.testing.assert_array_equal(gm.gate_idx.numpy(), np.asarray(top))
    if capacity == 0.5:
        assert float(gm.dropped_frac) > 0.4
    if capacity is None:
        assert float(gm.dropped_frac) == 0.0


def test_moe_ffn_ties_and_drops_equal_reference():
    """A zero router (every probability tied): top-1 picks expert 0, as
    ``jax.lax.top_k`` does, so at capacity 1.0 expert 0 overflows; the
    dropped share and aux loss ≡ the reference's; top-2 picks experts 0
    and 1, ties to the lower index."""
    rng = np.random.default_rng(22)
    x, _, ws = _experts(rng, 64, 8, 2, 16)
    rw = np.zeros((8, 2), np.float32)
    for k in (1, 2):
        got, gm = tmoe.moe_ffn(_t(x), _t(rw), *map(_t, ws), top_k=k,
                               capacity_factor=1.0)
        want, wm = jmoe.moe_ffn(jnp.asarray(x), jnp.asarray(rw),
                                *map(jnp.asarray, ws), top_k=k,
                                capacity_factor=1.0)
        assert rel(got, want) < LAYER_TOL, k
        assert float(gm.dropped_frac) == pytest.approx(
            float(wm.dropped_frac), abs=1e-6)
        assert float(gm.aux_loss) == pytest.approx(float(wm.aux_loss),
                                                   abs=1e-6)
    assert float(gm.dropped_frac) == 0.0 and float(wm.aux_loss) >= 0.99


def _bf16_pairs(arch):
    """(name, port output, reference output) of ``moe_ffn`` in bfloat16 on
    ``arch``'s reduced widths (64 tokens), dropless and at the published
    capacity 1.25 and 0.5 (which drops), inputs from ``default_rng(3)``;
    the reference runs op by op."""
    cfg = treg.reduced_config(treg.get(arch))
    rng = np.random.default_rng(3)
    x, rw, ws = _experts(rng, 64, cfg.d_model, cfg.n_experts, cfg.d_ff,
                         router_scale=3.0)
    out = []
    for cap in (None, 1.25, 0.5):
        got, gm = tmoe.moe_ffn(bf16(x), _t(rw), *map(bf16, ws),
                               top_k=cfg.top_k, capacity_factor=cap)
        want, wm = jmoe.moe_ffn(jbf16(x), jnp.asarray(rw),
                                *map(jbf16, ws), top_k=cfg.top_k,
                                capacity_factor=cap)
        out.append((f"moe/{cap}", got, want))
        assert float(gm.dropped_frac) == pytest.approx(
            float(wm.dropped_frac), abs=1e-6)
    return out


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_bf16_moe_equal_reference(arch):
    """bfloat16 ``moe_ffn`` against the reference's in bfloat16: the same
    routing and drops, at least 0.99 of the outputs bit-equal (``silu`` in
    the reference's form) and within 1e-2 relative (the readings, PERF.md
    § 6: 0.998-1.0)."""
    for name, got, want in _bf16_pairs(arch):
        assert got.dtype == torch.bfloat16, name
        assert bit_share(got, want) >= 0.99, name
        assert rel(got.float(), want) < 1e-2, name


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_params_equal_reference(arch):
    """The layer pattern (grok-1: MoE every layer; llama4: dense and MoE
    alternating, layer 2u from ``ln1``/``ln2``/``attn1``/``mlp`` and 2u+1
    from ``ln3``/``ln4``/``attn2``/``moe``), every leaf's shape and dtype
    ≡ the reference's (a float32 router), each leaf placed once; the
    count ≡ the reference tree's and the analytic count; ``init`` draws
    the (E, d, f) experts N(0, 1/fan_in) a slice at a time."""
    cfg = treg.reduced_config(treg.get(arch))
    jcfg = jreg.reduced_config(jreg.get(arch))
    jp = JT.init(jcfg, jax.random.PRNGKey(2))
    tp = TT.params_from_jax(cfg, jax.tree_util.tree_map(np.asarray, jp),
                            device="cpu")
    kinds = [type(b).__name__ for b in tp.blocks]
    assert kinds == (["MoEBlock"] * 4 if cfg.moe_every == 1 else
                     ["Block", "MoEBlock"] * 2)
    assert TT.param_count(tp) == JT.param_count(jp) == cfg.param_count()
    blocks = jp["blocks"]
    if cfg.moe_every == 2:
        np.testing.assert_array_equal(tp.blocks[2].wq.detach().numpy(),
                                      np.asarray(blocks["attn1"]["wq"][1]))
        np.testing.assert_array_equal(tp.blocks[3].ln1.detach().numpy(),
                                      np.asarray(blocks["ln3"][1]))
        np.testing.assert_array_equal(tp.blocks[3].w_down.detach().numpy(),
                                      np.asarray(blocks["moe"]["w_down"][1]))
    else:
        np.testing.assert_array_equal(tp.blocks[3].router.detach().numpy(),
                                      np.asarray(blocks["moe"]["router"][3]))
    blk = tp.blocks[1]
    assert blk.router.dtype == torch.float32
    assert tuple(blk.w_gate.shape) == (cfg.n_experts, cfg.d_model, cfg.d_ff)
    bcfg = dataclasses.replace(cfg, dtype="bfloat16")
    net = TT.init(bcfg, torch.Generator().manual_seed(0), device="cpu")
    moe = net.blocks[1]
    assert moe.router.dtype == torch.float32
    assert moe.w_up.dtype == torch.bfloat16
    for e in range(cfg.n_experts):         # each slice its own draw
        std = float(moe.w_down[e].float().std()) * np.sqrt(cfg.d_ff)
        assert abs(std - 1) < 0.05, e
    assert not torch.equal(moe.w_gate[0], moe.w_gate[1])
    assert float(moe.ln1.abs().max()) == 0.0


@pytest.mark.parametrize("arch,layers,billions", (
    ("grok-1-314b", 4, 21.3), ("llama4-maverick-400b-a17b", 2, 18.4)))
def test_published_widths_cut_in_depth(arch, layers, billions):
    """The cells the card serves: the published widths cut to ``layers``
    (meta device, no memory): the module's count ≡ the analytic count,
    ~``billions`` parameters."""
    cfg = dataclasses.replace(treg.get(arch), n_layers=layers)
    n = TT.param_count(TT.Transformer(cfg, device="meta"))
    assert n == cfg.param_count()
    assert abs(n / 1e9 - billions) < 0.05


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_cache_helpers_equal_reference(arch):
    """``init_cache`` ≡ the reference's {"k", "v"} (L, B, S, K, hd);
    ``pad_cache`` grows them as the reference's does."""
    tcfg = treg.reduced_config(treg.get(arch))
    jcfg = jreg.reduced_config(jreg.get(arch))
    tc = tkv.init_cache(tcfg, 3, 20, device="cpu")
    jc = jkv.init_cache(jcfg, 3, 20)
    for (path, g), (_, w) in zip(tree_leaves(tc), tree_leaves(jc)):
        assert tuple(g.shape) == tuple(w.shape), path
    kv = np.random.default_rng(23).standard_normal(
        tuple(jc["k"].shape), dtype=np.float32)
    got = tkv.pad_cache(tcfg, {"k": _t(kv), "v": _t(kv)}, 48)
    want = jkv.pad_cache(jcfg, {"k": jnp.asarray(kv), "v": jnp.asarray(kv)},
                         48)
    np.testing.assert_array_equal(got["v"].numpy(), np.asarray(want["v"]))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_forward_logits_and_aux_equal_reference(built, arch):
    """The full forward's logits ≡ the reference's within 1e-4, and its
    aux loss (summed over the MoE layers) within 1e-5 relative."""
    jcfg, tcfg, jm, tm, jp, tp, _, _, (jb, tb, total) = _pair(built, arch)
    pos = np.broadcast_to(np.arange(total, dtype=np.int32), (B, total))

    def ref(p, b):
        x, _ = jm._embed_batch(p, b)
        h, aux, _ = JT.forward(jcfg, p, x, jnp.asarray(pos), remat=False)
        return jm.logits(p, h).astype(jnp.float32), aux

    x, _ = tm._embed_batch(tp, tb)
    with torch.no_grad():
        h, aux, cache = TT.forward(tcfg, tp, x, _t(pos))
        got = tm.logits(tp, h).float()
    want, waux = jax.jit(ref)(jp, jb)
    assert cache is None and aux.dtype == torch.float32
    assert rel(got, want) < LOGIT_TOL
    assert rel(aux, waux) < LAYER_TOL and float(aux) > 0


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_decode_and_generate_equal_reference(built, arch):
    """Prefill, then decode steps (dropless) fed the reference's greedy
    tokens: the logits ≡ the reference's at every step within 1e-4, the
    KV caches too; ``generate``'s greedy tokens ≡ the reference's."""
    jcfg, tcfg, jm, tm, jp, tp, prefill, decode, (jb, tb, total) = \
        _pair(built, arch)
    jc, jl, jpos = prefill(jp, jb)
    tc, tl, tpos = tm.prefill(tp, tb, max_len=total + NEW)
    assert tpos == int(jpos) == total
    assert tuple(tc["k"].shape) == tuple(jc["k"].shape)
    assert rel(tl, jl) < LOGIT_TOL
    tok = jnp.argmax(jl, -1).astype(jnp.int32)
    want = [np.asarray(tok)]
    for i in range(NEW - 1):
        jl, jc = decode(jp, jc, tok, jnp.int32(total + i))
        tl, tc = tm.decode(tp, tc, _t(tok), total + i)
        assert rel(tl, jl) < LOGIT_TOL, f"decode step {i}"
        tok = jnp.argmax(jl, -1).astype(jnp.int32)
        want.append(np.asarray(tok))
    assert rel(tc["k"], jc["k"]) < LOGIT_TOL
    assert rel(tc["v"], jc["v"]) < LOGIT_TOL
    got = generate(tm, tp, tb, NEW)
    np.testing.assert_array_equal(got.numpy(), np.stack(want, axis=1))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_decode_routes_equal_forward(built, arch):
    """Forward hooks on each MoE layer's ``moe`` see prefill's and every
    decode step's routing; in float32 they ≡ a teacher-forced forward's
    over the same tokens, token by token and layer by layer."""
    _, tcfg, _, tm, _, tp, _, _, (_, tb, total) = _pair(built, arch)
    routes = {}
    hooks = [blk.moe.register_forward_hook(
        lambda m, a, out, li=li: routes.setdefault(li, []).append(
            out[1].gate_idx)) for li, blk in enumerate(tp.blocks)
        if isinstance(blk, TT.MoEBlock)]
    toks = [tb["tokens"]]
    with torch.no_grad():
        cache, last, pos = tm.prefill(tp, tb, max_len=total + NEW)
        for i in range(NEW - 1):
            toks.append(last.argmax(dim=-1).to(torch.int32)[:, None])
            last, cache = tm.decode(tp, cache, toks[-1][:, 0], pos + i)
        decoded = {li: torch.cat([r.reshape(B, -1, tcfg.top_k) for r in rs],
                                 dim=1) for li, rs in routes.items()}
        routes.clear()
        x, _ = tm._embed_batch(tp, {"tokens": torch.cat(toks, dim=1)})
        TT.forward(tcfg, tp, x, torch.arange(x.shape[1]).expand(B, -1))
    for h in hooks:
        h.remove()
    assert len(decoded) == sum(isinstance(b, TT.MoEBlock) for b in tp.blocks)
    for li, (r,) in routes.items():
        assert decoded[li].shape[1] == total + NEW - 1
        assert torch.equal(decoded[li], r.reshape(B, -1, tcfg.top_k)), li


def test_published_capacity_prefill_drops():
    """At the published capacity (1.25) a prefill drops pairs where the
    dropless copy does not; the MoE layers report it through their
    metrics (forward hooks see each layer's ``MoEMetrics``)."""
    cfg = dataclasses.replace(treg.reduced_config(treg.get("grok-1-314b")),
                              moe_capacity=1.25)
    tm = TModel(cfg)
    tp = tm.init_params(torch.Generator().manual_seed(0), device="cpu")
    seen = []
    hooks = [b.register_forward_hook(lambda m, a, out: seen.append(out[3]))
             for b in tp.blocks]
    toks = torch.from_numpy(np.random.default_rng(24).integers(
        0, cfg.vocab, (B, PROMPT)).astype(np.int32))
    tm.prefill(tp, {"tokens": toks})
    for h in hooks:
        h.remove()
    assert len(seen) == cfg.n_layers
    assert max(float(m.dropped_frac) for m in seen) > 0


if __name__ == "__main__":
    # the readings behind the bfloat16 bounds: relative error and the
    # share of outputs bit-equal to the reference's, per arch and form
    torch.set_num_threads(1)
    for arch in MOE_ARCHS:
        for name, got, want in _bf16_pairs(arch):
            print(f"{arch:26s} {name:10s} relative "
                  f"{rel(got.float(), want):.3e}  bit-equal "
                  f"{bit_share(got, want):.4f}")
