"""An emulation, for torch versions that allow it, of an older DTensor
rule: a strict view (``aten.view``, as ``einsum`` flattens its batch
dims) refuses to flatten a group of dims when a dim past the group's first
is sharded.  torch 2.11 raises there; 2.13 rewrites the placement as a
strided shard.  ``strict_flatten()`` patches the view analyser of
``torch.distributed.tensor._ops._view_ops`` to raise as 2.11 does, for as
long as the context lasts, and clears DTensor's cached sharding decisions
on entry and exit."""
import contextlib


class FlattenRefused(RuntimeError):
    pass


def _clear_cache():
    from torch.distributed.tensor import DTensor
    prop = DTensor._op_dispatcher.sharding_propagator
    for name in ("propagate_op_sharding", "_propagate_tensor_meta"):
        fn = getattr(prop, name, None)
        if hasattr(fn, "cache_clear"):
            fn.cache_clear()


@contextlib.contextmanager
def strict_flatten():
    from torch.distributed.tensor._ops import _view_ops as V
    cls = V._ViewShardingPropagator
    orig = cls._analyze_flatten

    def analyze(self, cmd):
        if self.strict_view:
            for i, dim in enumerate(cmd.input_dims):
                if i and isinstance(dim, V.InputDim) and \
                        self._find_plain_shard(dim)[0] is not None:
                    raise FlattenRefused(
                        f"flatten of {cmd.input_dims} with input dim "
                        f"{dim.input_dim} sharded behind the first "
                        f"(placements {self.input_src_placements})")
        return orig(self, cmd)

    _clear_cache()
    cls._analyze_flatten = analyze
    try:
        yield
    finally:
        cls._analyze_flatten = orig
        _clear_cache()
