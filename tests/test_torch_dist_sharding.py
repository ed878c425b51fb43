"""``repro_torch.dist.sharding`` and ``lowering.param_pspecs`` against the
JAX package, in-process (the functions are pure).

For qwen3-8b, deepseek-coder-33b and granite-moe-1b-a400m at the
meshes (1, 2), (2, 2), (1, 8), (2, 4) and (1, 16): each package
specializes its own decode plan, each plan goes through both packages'
functions, and ``param_pspecs``, ``cache_pspecs``
(the dense cache, and the paged pool whose 1-D or 2-D split the plan's
geometry picks), ``resolve_pspec`` and ``mesh_sizes`` agree entry for
entry.  No process group is needed: specs are resolved from mesh sizes.
"""

import jax
import numpy as np
import pytest

from repro.configs import ShapeConfig as RShape
from repro.configs import get_arch as rget_arch
from repro.core import specialize as rspecialize
from repro.core.passes.lowering import param_pspecs as rparam_pspecs
from repro.dist import sharding as rsh
from repro.models import lm as rlm
from repro_torch.configs import ShapeConfig as TShape
from repro_torch.configs import get_arch as tget_arch
from repro_torch.core import specialize as tspecialize
from repro_torch.core.passes.lowering import param_pspecs as tparam_pspecs
from repro_torch.dist import sharding as tsh
from repro_torch.models import lm as tlm

ARCHS = ("qwen3-8b", "deepseek-coder-33b", "granite-moe-1b-a400m")
MESHES = ((1, 2), (2, 2), (1, 8), (2, 4), (1, 16))


def _flat(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{path}/{k}"))
        return out
    return {path: tree}


def _rflat(tree):
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {"/" + "/".join(str(k.key) for k in p): v for p, v in leaves}


class _Shape:
    def __init__(self, shape):
        self.shape = tuple(shape)


def _plans(name, mesh, **kw):
    shape = ("serve_sh", "decode", 2048, 8)
    rplan = rspecialize(rget_arch(name), RShape(*shape),
                        mesh_axes=("data", "model"), mesh_shape=mesh, **kw)
    tplan = tspecialize(tget_arch(name), TShape(*shape),
                        mesh_axes=("data", "model"), mesh_shape=mesh, **kw)
    return tplan, rplan


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("name", ARCHS)
def test_param_and_cache_pspecs_match_the_reference(name, mesh):
    """Each plan (the port's ``h100-sxm`` one and the reference's
    ``tpu-v5e`` one, whose strategies differ) goes through both
    packages' functions: the specs agree entry for entry."""
    sizes = dict(zip(("data", "model"), mesh))
    rarch, tarch = rget_arch(name), tget_arch(name)
    for plan in _plans(name, mesh):
        want = _rflat(rparam_pspecs(plan, rarch, sizes))
        got = _flat(tparam_pspecs(plan, tarch, sizes))
        assert set(got) == set(want)
        for k in want:
            assert tuple(got[k]) == tuple(want[k]), (k, got[k], want[k])
        # the cache trees the plans size: dense stripes and block pools
        # whose sizes split 2-D, 1-D or not at all
        L, hd = tarch.n_layers, tarch.hd
        kvh = int(plan.estimates.get("kv_heads_padded", 0)) \
            or tarch.n_kv_heads
        B, Sq = 8, 2048
        caches = [{"pos": (B,), "k": (L, B, Sq, kvh, hd),
                   "v": (L, B, Sq, kvh, hd)}]
        for n in (64, 63, 128):
            caches.append({"pos": (B,), "k": (L, n, 32, kvh, hd),
                           "v": (L, n, 32, kvh, hd), "block_tbl": (B, 64)})
        for c in caches:
            shapes = {k: _Shape(v) for k, v in c.items()}
            want = rsh.cache_pspecs(plan, rarch, shapes, sizes)
            got = tsh.cache_pspecs(plan, tarch, shapes, sizes)
            assert {k: tuple(v) for k, v in got.items()} == \
                {k: tuple(v) for k, v in want.items()}, (c, got, want)


@pytest.mark.parametrize("name", ARCHS)
def test_param_pspecs_against_handed_shapes(name):
    """Resolved against the tree handed (reduced shapes): the padded
    dims' divisibility repair agrees with the reference's."""
    plan, _ = _plans(name, (1, 8))
    sizes = {"data": 1, "model": 8}
    rarch, tarch = rget_arch(name).reduced(), tget_arch(name).reduced()
    rshapes = rlm.param_shapes(rarch, *plan.padded_sizes())
    tshapes = tlm.param_shapes(tarch, *plan.padded_sizes())
    want = _rflat(rparam_pspecs(plan, rarch, sizes, shapes=rshapes))
    got = _flat(tparam_pspecs(plan, tarch, sizes, shapes=tshapes))
    assert {k: tuple(v) for k, v in got.items()} == \
        {k: tuple(v) for k, v in want.items()}


@pytest.mark.parametrize("seed", range(4))
def test_resolve_pspec_matches_the_reference(seed):
    rng = np.random.default_rng(seed)
    axes = ("batch", "heads", "embed", "ff", None)
    sizes = {"data": 2, "model": 4, "pod": 2}
    for _ in range(200):
        rules = {a: [None, "data", "model", ("data", "model"), ("pod", "data"),
                     "absent"][rng.integers(0, 6)]
                 for a in axes if a is not None}
        nd = int(rng.integers(1, 5))
        shape = tuple(int(x) for x in rng.choice([1, 2, 4, 6, 8, 16], nd))
        ax = tuple(axes[int(i)] for i in rng.integers(0, len(axes), nd))
        want = rsh.resolve_pspec(rules, shape, ax, sizes)
        got = tsh.resolve_pspec(rules, shape, ax, sizes)
        assert tuple(got) == tuple(want), (rules, shape, ax)


def test_mesh_sizes_matches_the_reference():
    class MeshModel:
        axes = ("data", "model")
        shape = (2, 4)

    class DeviceMeshLike:
        mesh_dim_names = ("data", "model")
        shape = (2, 4)

    for m in ({"data": 2, "model": 4}, MeshModel()):
        assert tsh.mesh_sizes(m) == rsh.mesh_sizes(m)
    assert tsh.mesh_sizes(DeviceMeshLike()) == {"data": 2, "model": 4}
    for bad in (object(), type("M", (), {"axes": ("a",), "shape": (1, 2)})()):
        with pytest.raises(TypeError):
            rsh.mesh_sizes(bad)
        with pytest.raises(TypeError):
            tsh.mesh_sizes(bad)


def test_placements_shard_data_major():
    """A dim over ``(data, model)`` is ``Shard(d)`` on both mesh dims
    (DTensor splits in mesh order: data-major, the reference's layout);
    a spec naming them the other way round raises."""
    from torch.distributed.tensor import Replicate, Shard

    class M:
        mesh_dim_names = ("data", "model")
    assert tsh.placements(M(), tsh.P(None, ("data", "model"))) == \
        [Shard(1), Shard(1)]
    assert tsh.placements(M(), tsh.P("model", None)) == [Replicate(), Shard(0)]
    with pytest.raises(ValueError, match="order"):
        tsh.placements(M(), tsh.P(("model", "data"),))


@pytest.mark.parametrize("name,coord", [
    ("qwen3-8b", {"data": 1, "model": 2}),
    ("granite-moe-1b-a400m", {"data": 0, "model": 3}),
    ("mamba2-2.7b", {"data": 1, "model": 1}),
    ("llama4-maverick-400b-a17b", {"data": 1, "model": 0})])
def test_init_params_builds_a_ranks_pieces_of_the_whole(name, coord,
                                                        monkeypatch):
    """``lm.init_params(pieces=...)`` holds exactly the whole weights'
    entries in each piece (the rank's pieces under the (2, 4) plan's
    ``param_pspecs``, at the rank ``coord``), with the padded heads'
    zeros and the SSM's fixed values in place.  A small staging buffer
    makes the draws span several leading dims, as a full-width leaf's
    do."""
    import torch

    from repro_torch.models import common
    monkeypatch.setattr(common, "STAGING", 384)
    arch = tget_arch(name).reduced()
    plan = tspecialize(arch, TShape("serve_sh", "decode", 64, 8),
                       mesh_axes=("data", "model"), mesh_shape=(2, 4),
                       cache=False)
    sizes = {"data": 2, "model": 4}
    shapes = tlm.param_shapes(arch, *plan.padded_sizes())
    specs = tparam_pspecs(plan, arch, sizes, shapes=shapes)

    def piece(shape, spec):
        start, size = [], []
        for d, n_d in enumerate(shape):
            i, n = 0, 1
            for a in tsh._names(spec[d] if d < len(spec) else None):
                i, n = i * sizes[a] + coord[a], n * sizes[a]
            start.append(i * (n_d // n))
            size.append(n_d // n)
        return tuple(start), tuple(size)

    def tree(fn, *ts):
        if isinstance(ts[0], dict):
            return {k: tree(fn, *(t[k] for t in ts)) for k in ts[0]}
        return fn(*ts)

    pieces = tree(piece, shapes, specs)
    whole = tlm.init_params(arch, torch.Generator().manual_seed(5),
                            *plan.padded_sizes())
    mine = tlm.init_params(arch, torch.Generator().manual_seed(5),
                           *plan.padded_sizes(), pieces=pieces)
    split = 0
    for path, (start, size) in _flat(pieces).items():
        w, got = _flat(whole)[path], _flat(mine)[path]
        want = w[tuple(slice(a, a + n) for a, n in zip(start, size))]
        assert torch.equal(got, want), path
        split += tuple(size) != tuple(w.shape)
    assert split >= 4
