"""Helpers of the LM parity tests (``test_torch_lm``, ``test_torch_ssm``,
``test_torch_moe``): the same reduced config, weights, tokens and prefix
embeddings in the reference (``repro``) and the port (``repro_torch``), and
the error measures the tests bound."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import registry as jreg
from repro.models.model import Model as JModel
from repro_torch.configs import registry as treg
from repro_torch.models import transformer as TT
from repro_torch.models.model import Model as TModel

LAYER_TOL, LOGIT_TOL = 1e-5, 1e-4


def rel(got, want) -> float:
    """max |got - want| / max |want|, in float64."""
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def bf16(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def jbf16(a):
    return jnp.asarray(np.asarray(a, np.float32), jnp.bfloat16)


def bit_share(got, want) -> float:
    """Share of ``got``'s elements bit-equal to ``want``'s."""
    want = np.asarray(jnp.asarray(want, jnp.float32))
    return float((got.detach().float().numpy() == want).mean())


def pair(arch, batch: int, prompt: int, new: int, seed: int = 7):
    """(ref config, port config, ref model, port model, ref params, port
    params, ref jitted prefill, ref jitted decode, (ref batch, port batch,
    total positions)) for ``arch``'s reduced config: the reference's
    ``init`` (PRNGKey(0)) carried over by ``params_from_jax``, tokens and
    prefix embeddings from ``default_rng(seed)``."""
    jcfg = jreg.reduced_config(jreg.get(arch))
    tcfg = treg.reduced_config(treg.get(arch))
    jm, tm = JModel(jcfg), TModel(tcfg)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tp = TT.params_from_jax(tcfg, jax.tree_util.tree_map(np.asarray, jp),
                            device="cpu")
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jcfg.vocab, (batch, prompt)).astype(np.int32)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if jcfg.frontend != "none":
        fe = rng.standard_normal((batch, jcfg.frontend_tokens, jcfg.d_model),
                                 dtype=np.float32)
        jb["frontend"], tb["frontend"] = jnp.asarray(fe), torch.from_numpy(fe)
    total = prompt + (jcfg.frontend_tokens if jcfg.frontend != "none" else 0)
    prefill = jax.jit(lambda p, b: jm.prefill(p, b, max_len=total + new))
    decode = jax.jit(lambda p, c, t, pos: jm.decode(p, c, t, pos))
    return (jcfg, tcfg, jm, tm, jp, tp, prefill, decode, (jb, tb, total))


def tree_leaves(tree):
    """(path, leaf) of a nested mapping (NamedTuples as their fields),
    sorted by path: the reference's and the port's caches compare by
    this."""
    out = []

    def walk(node, path):
        if node is None:
            out.append((path, None))
        elif isinstance(node, dict):
            for k in node:
                walk(node[k], path + (k,))
        elif isinstance(node, tuple) and hasattr(node, "_fields"):
            for k in node._fields:
                walk(getattr(node, k), path + (k,))
        else:
            out.append((path, node))

    walk(tree, ())
    return sorted(out, key=lambda kv: kv[0])
