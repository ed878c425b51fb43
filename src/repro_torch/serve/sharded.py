"""Where each rank's pieces of a serving engine lie on a DeviceMesh.

``ServeEngine.from_plan(mesh=...)`` places the weights through
:func:`repro_torch.core.passes.lowering.param_pspecs` and the session
cache through :func:`repro_torch.dist.sharding.cache_pspecs`
(``src/repro/serve/engine.py:697-715`` ``_place_on_mesh``): every rank
keeps only its piece of a split leaf, as a plain tensor the model code
runs on.  :class:`MeshPieces` records the layout and does the engine's
cache writes and block reads through it:

* a dense cache piece holds the slots of the rank's data shard (where
  the batch splits; several data axes are one data-major index) and the
  rows of its model shard (where the seq dim splits), its kv heads
  (where those split) or its columns of every kv head (where head_dim
  splits: ``kv_split == "head_dim"``; rows cross the engine whole, and
  :meth:`MeshPieces.cut_cols` / :meth:`MeshPieces.whole_cols` cut and
  gather the columns on every write and read);
* a pool piece holds the blocks of the rank's shard (1-D over the model
  axis, or 2-D data-major over ``(data, model)``) or its kv heads;
* an SSM arch's per-slot state pieces (``ssm``: the rank's heads;
  ``conv``: the channels of its ``conv_w`` piece) hold the slots of the
  rank's data shard where the batch splits (:meth:`MeshPieces
  .write_state`, :meth:`MeshPieces.read_state`);
* ``pos`` and ``block_tbl`` stay whole on every rank: they are the
  host's per-slot state, rewritten every tick, and the decode step cuts
  the rows it needs (``cache_pspecs`` splits them over data, and the
  JAX package's partitioner moves them where its ``shard_map`` wants
  them).

The host spill tier behind a paged pool (the engine's ``_host``) has one
piece a rank, of :attr:`MeshPieces.host_kv_heads` kv heads and every
host block: where the kv heads split (``kv_split == "heads"``) a rank's
host rows are its own heads of every spilled block, so a spill and a
promote copy rank-local rows only; where the pool splits by blocks
(``"rows"``) every rank holds every head of every spilled block, a whole
copy of the tier: a spill gathers the block's rows from its owner
(:meth:`MeshPieces.read_blocks`) onto every rank of the pool's axes, and
a promote writes each new id's rows on the rank that owns it
(:meth:`MeshPieces.write_blocks`), whichever data shard that is, with no
further collective.  Rows made with every head (a prefill worker's
chunks) are cut to the rank's heads by :meth:`MeshPieces.cut_heads`, and
a rank's rows are made whole again by :meth:`MeshPieces.whole_heads`.

Every rank runs the same engine loop on the same requests; the host
decisions are the same on every rank, so the collectives in the model
code and in :meth:`MeshPieces.read_blocks` line up.  What only one rank
learns (a prefill fleet's events, owned by the mesh's first rank) reaches
the others through :meth:`MeshPieces.bcast` and
:meth:`MeshPieces.bcast_object` before any rank acts on it.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.dist import collectives, fsdp, sharding
from repro_torch.dist.sharding import P

#: cache keys the engine keeps whole on every rank
WHOLE = ("pos", "block_tbl")
#: the value a cache key starts at where it is not 0 (as
#: ``lm.init_paged_cache`` allocates it: no block assigned)
FILL = {"block_tbl": -1}


def _tree(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _piece(mesh, shape: Sequence[int], spec: Sequence[Any]
           ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """``(start, shape)`` of this rank's piece of a ``shape`` tensor laid
    out by ``spec``."""
    start, size = [], []
    for d, n_d in enumerate(shape):
        e = spec[d] if d < len(spec) else None
        i, n = sharding.shard_index(mesh, e) if e else (0, 1)
        start.append(i * (n_d // n))
        size.append(n_d // n)
    return tuple(start), tuple(size)


def param_pieces(mesh, plan, arch) -> Dict[str, Any]:
    """Each parameter leaf's ``(start, shape)`` on this rank of ``mesh``
    under the plan's placement
    (:func:`repro_torch.core.passes.lowering.param_pspecs`): what
    ``lm.init_params(..., pieces=)`` builds, so that a rank never holds
    the whole weights."""
    from repro_torch.core.passes.lowering import param_pspecs
    from repro_torch.models import lm
    whole = lm.param_shapes(arch, *plan.padded_sizes())
    specs = param_pspecs(plan, arch, sharding.mesh_sizes(mesh), shapes=whole)
    return _tree(lambda w, sp: _piece(mesh, w, sp), whole, specs)


def cache_split(plan, arch) -> Tuple[str, int, bool]:
    """``(kv_split, ways, paged)`` of a plan's KV cache on its own mesh,
    resolved as :class:`MeshPieces` resolves the engine's cache
    (:func:`repro_torch.dist.sharding.cache_pspecs` on the plan's cache
    geometry): ``kv_split`` as :attr:`MeshPieces.kv_split`, ``ways`` the
    model ranks a head_dim split spans (0 where it does not split
    head_dim), ``paged`` the residency.  What
    :func:`repro_torch.models.lm.kernel_instances` needs to name a
    rank's decode kernel before any weight exists."""
    from types import SimpleNamespace
    est = plan.estimates
    paged = str(est.get("kv_residency", "dense")) == "paged"
    if not arch.has_attention or "cache.k" not in plan.placements:
        return "none", 0, paged
    sizes = {a: int(n) for a, n in zip(plan.mesh_axes, plan.mesh_shape)}
    K = int(est.get("kv_heads_padded", 0)) or arch.n_kv_heads
    B, S = int(plan.global_batch or 1), int(plan.seq_len or 1)
    if paged:
        bl = int(est.get("kv_block_len", 0)) or S
        N = int(est.get("kv_n_blocks", 0)) or B * -(-S // bl)
        shapes = {"k": (arch.n_layers, N, bl, K, arch.hd),
                  "block_tbl": (B, -(-S // bl))}
    else:
        shapes = {"k": (arch.n_layers, B, S, K, arch.hd)}
    spec = sharding.cache_pspecs(
        plan, arch, {k: SimpleNamespace(shape=v) for k, v in shapes.items()},
        sizes)["k"]
    kind = split_kind(spec, paged)
    n = 1
    for a in sharding._names(spec[4]):
        n *= sizes[a]
    return kind, (n if kind == "head_dim" else 0), paged


def split_kind(spec, paged: bool) -> str:
    """The ``kv_split`` a cache ``k`` spec gives: ``"heads"`` where the
    kv heads split, ``"rows"`` where the seq (a pool's block) dim does,
    ``"head_dim"`` where only head_dim does, else ``"none"``."""
    if spec[3] is not None:
        return "heads"
    if spec[1 if paged else 2] is not None:
        return "rows"
    return "head_dim" if spec[4] is not None else "none"


class MeshPieces:
    """The layout of one engine's pieces on ``mesh``.

    ``param_specs`` / ``cache_specs`` are the resolved specs (a
    :class:`~repro_torch.dist.sharding.P` a leaf), ``param_shapes`` /
    ``cache_shapes`` the whole shapes.  ``kv_split`` is ``"heads"``,
    ``"rows"`` or ``"none"`` (:class:`repro_torch.models.lm.RunCfg`)."""

    def __init__(self, mesh, plan, arch, params, cache: Dict[str, Any]):
        from repro_torch.core.passes.lowering import param_pspecs
        from repro_torch.models import lm
        self.mesh = mesh
        self.sizes = sharding.mesh_sizes(mesh)
        whole = lm.param_shapes(arch, *plan.padded_sizes())
        specs = param_pspecs(plan, arch, self.sizes, shapes=whole)

        def shape_of(w, t, spec):
            # a leaf handed whole or as the rank's piece is measured
            # against the plan's whole shape; any other shape is resolved
            # as handed (the reference resolves against the arrays given)
            w, got = tuple(w), tuple(t.shape)
            return w if got in (w, self.piece_shape(w, spec)) else got

        self.param_shapes = _tree(shape_of, whole, params, specs)
        self.param_specs = param_pspecs(plan, arch, self.sizes,
                                        shapes=self.param_shapes)
        self.cache_shapes = {k: tuple(v.shape) for k, v in cache.items()}
        self.cache_specs = sharding.cache_pspecs(plan, arch, cache,
                                                 self.sizes)
        for k in WHOLE:
            if k in self.cache_specs:
                self.cache_specs[k] = P(*(None,) * len(self.cache_shapes[k]))
        self.paged = "block_tbl" in cache
        spec = self.cache_specs.get("k")
        self.kv_split = "none" if spec is None \
            else split_kind(spec, self.paged)
        # the rank's columns of every kv head (all of them unless the
        # cache splits on head_dim), and the axes they split over
        self.col0, self.coln, self.col_axes = 0, 0, ()
        if spec is not None:
            D = self.cache_shapes["k"][4]
            i, n = sharding.shard_index(mesh, spec[4]) if spec[4] \
                else (0, 1)
            self.col0, self.coln = i * (D // n), D // n
            self.col_axes = sharding._names(spec[4])
        # the rank's ranges: dense (batch, seq); paged pool blocks
        self.b0 = self.s0 = self.start = 0
        if spec is not None and self.paged:
            i, n = sharding.shard_index(mesh, spec[1]) if spec[1] \
                else (0, 1)
            self.n_local = self.cache_shapes["k"][1] // n
            self.start = i * self.n_local
            self.pool_axes = sharding._names(spec[1])
        elif spec is not None:
            B, S = self.cache_shapes["k"][1:3]
            i, n = sharding.shard_index(mesh, spec[1]) if spec[1] \
                else (0, 1)
            self.b0, self.bn = i * (B // n), B // n
            i, n = sharding.shard_index(mesh, spec[2]) if spec[2] \
                else (0, 1)
            self.s0, self.sn = i * (S // n), S // n
        # the rank's kv heads of the whole cache (all of them unless the
        # heads split), and the axes a dense stripe's slots and rows
        # split over
        self.kv_h0, self.kv_hn, self.head_axes = 0, 0, ()
        self.slot_axes: Tuple[str, ...] = ()
        if spec is not None:
            K = self.cache_shapes["k"][3]
            i, n = sharding.shard_index(mesh, spec[3]) if spec[3] \
                else (0, 1)
            self.kv_h0, self.kv_hn = i * (K // n), K // n
            self.head_axes = sharding._names(spec[3])
            if not self.paged:
                self.slot_axes = (sharding._names(spec[1])
                                  + sharding._names(spec[2]))
        # the per-slot SSM states' slots (all of them where the batch
        # does not split)
        st = self.cache_specs.get("ssm")
        self.state_axes = sharding._names(st[1]) if st is not None else ()
        if st is not None:
            B = self.cache_shapes["ssm"][1]
            i, n = sharding.shard_index(mesh, st[1]) if st[1] else (0, 1)
            self.st0, self.stn = i * (B // n), B // n

    @property
    def host_kv_heads(self) -> int:
        """The kv heads of this rank's piece of the host spill tier: its
        own where the heads split, every head otherwise."""
        return self.kv_hn

    @property
    def is_root(self) -> bool:
        """This rank is the mesh's first: the one that owns what lives
        in one process only (a prefill fleet)."""
        return dist.get_rank() == int(self.mesh.mesh.flatten()[0])

    def piece_shape(self, shape: Sequence[int], spec: Sequence[Any]
                    ) -> Tuple[int, ...]:
        out = []
        for d, e in zip(shape, spec):
            n = 1
            for a in sharding._names(e):
                n *= self.sizes[a]
            out.append(d // n)
        return tuple(out)

    # ------------------------------------------------------------------
    def place_params(self, params):
        """The rank's pieces of ``params`` (leaves whole, or pieces
        already)."""
        def cut(t, spec, whole):
            if tuple(t.shape) == tuple(whole):
                return sharding.local_shard(t, self.mesh, spec)
            return t
        return _tree(cut, params, self.param_specs, self.param_shapes)

    def place_cache(self, cache: Dict[str, torch.Tensor], device
                    ) -> Dict[str, torch.Tensor]:
        """The rank's pieces of ``cache`` on ``device``: cut from its
        tensors, or, for a cache on the ``meta`` device (its shapes
        alone), allocated at the pieces' shapes, so that the whole cache
        is never allocated."""
        out = {}
        for k, v in cache.items():
            _, shape = _piece(self.mesh, v.shape, self.cache_specs[k])
            if v.is_meta:
                out[k] = torch.full(shape, FILL.get(k, 0), dtype=v.dtype,
                                    device=device)
            else:
                out[k] = sharding.local_shard(v, self.mesh,
                                              self.cache_specs[k])
        return out

    # ------------------------------------------------------------------
    def write_slots(self, t: torch.Tensor, slots: np.ndarray,
                    rows: torch.Tensor, plen: int) -> None:
        """Dense prefill: ``t[:, slot, :plen] = rows[:, i]`` for the
        slots and rows this rank holds (``rows`` ``(L, n, >= plen, K,
        hd)`` in the cache's head layout)."""
        slots = np.asarray(slots)
        mine = np.nonzero((slots >= self.b0)
                          & (slots < self.b0 + self.bn))[0]
        if not len(mine):
            return
        lo, hi = self.s0, min(plen, self.s0 + self.sn)
        if hi <= lo:
            return
        dev = t.device
        st = torch.as_tensor(slots[mine] - self.b0, device=dev)
        src = self.cut_cols(rows[:, torch.as_tensor(mine,
                                                    device=rows.device)])
        t[:, st, :hi - lo] = src[:, :, lo:hi]

    def write_blocks(self, t: torch.Tensor, ids: Sequence[int],
                     rows: torch.Tensor) -> None:
        """``t[:, id] = rows[:, i]`` for the blocks this rank's pool
        piece holds (``rows`` ``(L, n, bl, K, hd)`` in the pool's head
        layout, on any device: a promote's come from the host)."""
        ids = np.asarray(ids, np.int64)
        loc = ids - self.start
        mine = np.nonzero((loc >= 0) & (loc < t.shape[1]))[0]
        if not len(mine):
            return
        dev = t.device
        t[:, torch.as_tensor(loc[mine], device=dev)] = self.cut_cols(
            rows[:, torch.as_tensor(mine, device=rows.device)]).to(dev)

    def read_slots(self, t: torch.Tensor, slots: Sequence[int], n: int
                   ) -> torch.Tensor:
        """The first ``n`` rows of dense stripes ``slots``, ``(L,
        len(slots), n, K, hd)`` in the cache's head layout, on every
        rank: each rank puts in the slots and rows its piece holds, and
        the ranks the batch and seq dims split over add them up (one
        all-reduce an axis in fp32, exact: every row is held once).  The
        inverse of :meth:`write_slots`."""
        loc = np.asarray(slots, np.int64) - self.b0
        mine = (loc >= 0) & (loc < self.bn)
        idx = torch.as_tensor(np.where(mine, loc, 0), device=t.device)
        out = torch.zeros((t.shape[0], len(loc), n, *t.shape[3:]),
                          dtype=torch.float32, device=t.device)
        lo, hi = self.s0, min(n, self.s0 + self.sn)
        if hi > lo:
            keep = torch.as_tensor(mine, device=t.device).view(
                1, -1, 1, 1, 1)
            out[:, :, lo:hi] = torch.where(
                keep, t[:, idx, :hi - lo].float(), out[:, :, lo:hi])
        for axis in self.slot_axes:
            dist.all_reduce(out, group=self.mesh.get_group(axis))
        return self.whole_cols(out.to(t.dtype))

    def write_state(self, t: torch.Tensor, slots: Sequence[int],
                    rows: torch.Tensor) -> None:
        """``t[:, slot] = rows[:, i]`` for the slots of an SSM state
        piece (``ssm`` or ``conv``) this rank holds; ``rows`` ``(L, n,
        ...)`` are the rank's heads or channels of each slot's state."""
        loc = np.asarray(slots, np.int64) - self.st0
        mine = np.nonzero((loc >= 0) & (loc < self.stn))[0]
        if not len(mine):
            return
        t[:, torch.as_tensor(loc[mine], device=t.device)] = \
            rows[:, torch.as_tensor(mine, device=rows.device)].to(t.device)

    def read_state(self, t: torch.Tensor, slots: Sequence[int]
                   ) -> torch.Tensor:
        """The ``(L, n, ...)`` rows of ``slots`` of an SSM state piece on
        every rank of its data shards: each rank puts in the slots it
        holds, and the ranks the batch splits over add them up (one
        all-reduce in fp32, exact: every slot is held once)."""
        loc = np.asarray(slots, np.int64) - self.st0
        if not self.state_axes:
            return t[:, torch.as_tensor(loc, device=t.device)]
        mine = (loc >= 0) & (loc < self.stn)
        idx = torch.as_tensor(np.where(mine, loc, 0), device=t.device)
        keep = torch.as_tensor(mine, device=t.device).view(
            1, -1, *(1,) * (t.dim() - 2))
        out = torch.where(keep, t[:, idx], torch.zeros(
            (), dtype=t.dtype, device=t.device)).float()
        for axis in self.state_axes:
            dist.all_reduce(out, group=self.mesh.get_group(axis))
        return out.to(t.dtype)

    def read_blocks(self, t: torch.Tensor, ids: Sequence[int]
                    ) -> torch.Tensor:
        """The ``(L, n, bl, K, hd)`` rows of blocks ``ids`` on every
        rank: each rank puts in the blocks its piece holds, and the
        pool's ranks add them up (one all-reduce; none where the pool
        is not split by blocks)."""
        ids = np.asarray(ids, np.int64)
        if self.kv_split != "rows":
            return self.whole_cols(t[:, torch.as_tensor(ids,
                                                        device=t.device)])
        loc = ids - self.start
        mine = (loc >= 0) & (loc < t.shape[1])
        idx = torch.as_tensor(np.where(mine, loc, 0), device=t.device)
        out = t[:, idx] * torch.as_tensor(mine, device=t.device).view(
            1, -1, 1, 1, 1).to(t.dtype)
        out = out.float()
        for axis in self.pool_axes:
            dist.all_reduce(out, group=self.mesh.get_group(axis))
        return out.to(t.dtype)

    # ------------------------------------------------------------------
    def cut_cols(self, rows: torch.Tensor) -> torch.Tensor:
        """This rank's head_dim columns of rows with every column
        (``(..., hd)``); the rows as they are where the cache does not
        split on head_dim."""
        if self.kv_split != "head_dim":
            return rows
        return rows.narrow(-1, self.col0, self.coln)

    def whole_cols(self, rows: torch.Tensor) -> torch.Tensor:
        """Every head_dim column of rows of this rank's columns, gathered
        from the ranks the columns split over (one all-gather an axis;
        none where the cache does not split on head_dim)."""
        if self.kv_split != "head_dim":
            return rows
        return collectives.all_gather(
            rows, rows.dim() - 1,
            collectives.axes_groups(self.mesh, self.col_axes))

    def cut_heads(self, rows: torch.Tensor) -> torch.Tensor:
        """This rank's kv heads of rows made with every head (``(...,
        K, hd)``: a prefill worker's chunks, a whole host row); the
        rows as they are where the heads do not split."""
        if self.kv_split != "heads":
            return rows
        return rows.narrow(-2, self.kv_h0, self.kv_hn)

    def whole_heads(self, rows: torch.Tensor) -> torch.Tensor:
        """Every kv head of rows in the pool's head layout (``(..., K,
        hd)``), gathered from the ranks the heads split over (one
        all-gather an axis; none where they do not split)."""
        if self.kv_split != "heads":
            return rows
        return collectives.all_gather(
            rows, rows.dim() - 2,
            collectives.axes_groups(self.mesh, self.head_axes))

    def param_bytes(self, params) -> Tuple[int, int]:
        """``(bytes this rank holds, bytes of the whole weights)`` of
        ``params``, the rank's pieces."""
        held, whole = [0], [0]

        def add(t, w):
            held[0] += t.numel() * t.element_size()
            whole[0] += int(np.prod(w)) * t.element_size()
        _tree(add, params, self.param_shapes)
        return held[0], whole[0]

    def whole_params(self, params) -> Dict[str, Any]:
        """The whole weights from the ranks' pieces, on the mesh's first
        rank: each leaf gathered over the axes its spec splits it across
        (:func:`repro_torch.dist.fsdp.whole`).  Every rank of the mesh
        must call it; the others get ``None`` leaves (each whole leaf
        dropped as soon as it is gathered)."""
        def gather(t, spec):
            t = fsdp.whole(t, spec, self.mesh)
            return t if self.is_root else None
        return _tree(gather, params, self.param_specs)

    def _stages(self):
        """``(group, source global rank)`` of the broadcast stages this
        rank takes part in to carry a value of the mesh's first rank to
        every rank: stage ``j`` runs along mesh dim ``j`` from its
        coordinate 0 among the ranks whose later coordinates are 0, so
        after the last stage every rank has it."""
        coord = list(self.mesh.get_coordinate())
        grid = self.mesh.mesh
        out = []
        for j in range(grid.dim()):
            if grid.shape[j] == 1 or any(coord[j + 1:]):
                continue
            src = list(coord)
            src[j] = 0
            out.append((self.mesh.get_group(j), int(grid[tuple(src)])))
        return out

    def bcast(self, t: torch.Tensor) -> torch.Tensor:
        """Broadcast ``t`` in place from the mesh's first rank to every
        rank of the mesh (``torch.distributed.broadcast``, which gloo
        carries for CUDA tensors too); returns ``t``."""
        for g, src in self._stages():
            dist.broadcast(t, src=src, group=g)
        return t

    def bcast_object(self, obj: Any) -> Any:
        """The mesh's first rank's ``obj`` (picklable) on every rank."""
        box = [obj]
        for g, src in self._stages():
            dist.broadcast_object_list(box, src=src, group=g)
        return box[0]
