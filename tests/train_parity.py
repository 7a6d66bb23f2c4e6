"""Helpers of the training parity tests (``test_torch_train``,
``test_torch_train_grads``, ``test_torch_train_loop``): the same reduced
float32 config and weights in the reference (``repro``) and the port
(``repro_torch``), batches from numpy, and the per-leaf error the tests
bound."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import registry as jreg
from repro.models.model import Model as JModel
from repro_torch.configs import registry as treg
from repro_torch.models import transformer as TT
from repro_torch.models.model import Model as TModel

# relative, float32: losses and metrics; grads, params and optimizer
# state (per leaf, norm-relative: ||got - want|| / ||want||)
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4

# one reduced config of each layer pattern
PATTERN_ARCHS = ("tinyllama-1.1b", "h2o-danube-1.8b", "musicgen-large",
                 "paligemma-3b", "grok-1-314b", "llama4-maverick-400b-a17b",
                 "falcon-mamba-7b", "zamba2-7b")


def configs(arch):
    """(reference config, port config): ``reduced_config`` in float32."""
    return tuple(dataclasses.replace(reg.reduced_config(reg.get(arch)),
                                     dtype="float32")
                 for reg in (jreg, treg))


def models(arch, seed: int = 0):
    """(ref config, port config, ref model, port model, ref params, port
    params): the reference's ``init`` (``PRNGKey(seed)``, jitted) carried
    over by ``params_from_jax``."""
    jcfg, tcfg = configs(arch)
    jm, tm = JModel(jcfg), TModel(tcfg)
    jp = jax.jit(jm.init_params)(jax.random.PRNGKey(seed))
    tp = TT.params_from_jax(tcfg, jax.tree_util.tree_map(np.asarray, jp),
                            device="cpu")
    return jcfg, tcfg, jm, tm, jp, tp


def batches(np_batch):
    """A numpy batch → (the reference's, the port's)."""
    return ({k: jnp.asarray(v) for k, v in np_batch.items()},
            {k: torch.from_numpy(np.array(v)) for k, v in np_batch.items()})


def paths(tree):
    """A reference tree's leaves as numpy arrays by path."""
    return {tuple(getattr(k, "key", getattr(k, "name", k)) for k in p):
            np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def leaf_err(got, want) -> float:
    """||got - want|| / ||want|| in float64 (0 when both are zero)."""
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    diff = np.linalg.norm(got - want)
    return float(diff / np.linalg.norm(want)) if diff else 0.0


def worst(got: dict, want: dict):
    """(key, error) of the leaf with the largest ``leaf_err``; the two
    dicts must hold the same keys."""
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    return max(((k, leaf_err(got[k], want[k])) for k in want),
               key=lambda kv: kv[1])


def port_leaves(leaves, values=None):
    """The port's per-leaf tensors (the parameters by default) stacked,
    by the reference's path."""
    vals = values or [leaf.params for leaf in leaves]
    return {leaf.path: TT.stack(leaf, v) for leaf, v in zip(leaves, vals)}
