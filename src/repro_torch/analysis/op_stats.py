"""Operation counts of one eager step on fake tensors.

The port of ``repro/analysis/hlo_stats.py``.  The reference compiles the
step for the whole mesh and reads the per-device HLO; the port has no
compiler, so it runs rank 0's eager step on fake tensors (shapes, no
storage: nothing is allocated and nothing launched) under
:class:`OpStats`, a ``TorchDispatchMode`` stacked on
``FakeTensorMode``, and counts what the step dispatches:

* FLOPs — 2·|out|·K for every matmul-family aten op (``torch.utils
  .flop_counter``'s formulas: mm, addmm, bmm, baddbmm, convolutions), as
  ``parse_hlo`` counts ``dot``s, plus each kernel entry's ``work()``
  (:mod:`repro_torch.kernels.fake`);
* HBM bytes — Σ (input + output bytes) over every aten op that is not a
  view, an allocation or a metadata op (the eager twin of "operand +
  output bytes over top-level instructions": eager PyTorch fuses
  nothing, so every op's operands cross HBM), plus the kernels' bytes;
* collective bytes — by kind, per device, with the reference's ring
  model (:func:`collective_bytes`), at the ``c10d`` ops
  ``torch.distributed`` dispatches, so every call site is counted;
  bytes of a group whose ranks lie in two pods (:data:`POD` ranks a
  pod) count as DCN;
* ``peak_live_bytes`` — the largest sum of live fake-storage bytes seen
  during the step, the arguments included: the twin of
  ``compiled.memory_analysis()``.

The result has the keys of ``parse_hlo``'s dict that
``roofline.analyze`` reads, a per-entry kernel breakdown (``kernels``:
calls, flops, bytes by ``ops.launch_counts()`` key) and
``peak_live_bytes``.
"""

from __future__ import annotations

import weakref
from collections import defaultdict
from typing import Any, Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

#: ranks a pod: a group spanning two is DCN traffic (the reference's
#: 256-chip pod boundary)
POD = 256

#: aten ops that move no bytes: allocations (their output is written by
#: the op that fills it), metadata reads and aliasing
_NO_BYTES = {
    "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "detach", "alias", "lift_fresh", "set_",
    "resize_", "_local_scalar_dense", "sym_size", "sym_stride",
    "sym_numel", "sym_storage_offset", "is_same_size", "_unsafe_view",
    "record_stream",
}

#: indexed writes into their first argument: their traffic is what they
#: write and read beside it, twice (read and write), not the whole
#: destination (the reference counts a dynamic-update-slice so)
_INDEXED_WRITES = {
    "index_put_", "index_put", "_index_put_impl_", "scatter_", "scatter",
    "index_copy_", "index_copy", "masked_scatter_", "index_add_",
    "index_add", "scatter_add_", "scatter_add", "slice_scatter",
    "select_scatter",
}

#: c10d op -> (kind, index of the input tensors, index of the outputs);
#: the bytes of an all-gather are its output's, every other kind's its
#: input's
_C10D = {
    "allreduce_": ("all-reduce", 0, 0),
    "allreduce_coalesced_": ("all-reduce", 0, 0),
    "allgather_": ("all-gather", 1, 0),
    "_allgather_base_": ("all-gather", 1, 0),
    "allgather_coalesced_": ("all-gather", 1, 0),
    "allgather_into_tensor_coalesced_": ("all-gather", 1, 0),
    "reduce_scatter_": ("reduce-scatter", 1, 0),
    "_reduce_scatter_base_": ("reduce-scatter", 1, 0),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1, 0),
    "alltoall_": ("all-to-all", 1, 0),
    "alltoall_base_": ("all-to-all", 1, 0),
    "send": ("collective-permute", 0, 0),
    "broadcast_": ("broadcast", 0, 0),
}


def collective_bytes(kind: str, out_bytes: float, in_bytes: float,
                     g: int) -> float:
    """Ring-model per-device bytes on the wire (the reference's
    ``_collective_bytes``); a broadcast, which the reference's HLO never
    holds, moves its buffer's ``(g - 1) / g`` a device as a pipelined
    ring does."""
    if g <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * in_bytes * (g - 1) / g
    if kind == "all-gather":
        return out_bytes * (g - 1) / g
    if kind == "reduce-scatter":
        return in_bytes * (g - 1) / g
    if kind == "all-to-all":
        return in_bytes * (g - 1) / g
    if kind == "collective-permute":
        return float(in_bytes)
    if kind == "broadcast":
        return in_bytes * (g - 1) / g
    return 0.0


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _tensors(x) -> List[torch.Tensor]:
    return [t for t in tree_leaves(x) if isinstance(t, torch.Tensor)]


def _group_ranks(args) -> List[int]:
    """The global ranks of the process group among a c10d op's
    arguments."""
    import torch.distributed as dist
    for a in args:
        if isinstance(a, torch.ScriptObject):
            try:
                pg = dist.ProcessGroup.unbox(a)
            except (RuntimeError, TypeError):
                continue
            return list(dist.get_process_group_ranks(pg))
    return []


class OpStats(TorchDispatchMode):
    """Counts FLOPs, HBM bytes, collective bytes and live storage over
    the ops dispatched while it is active (enter it inside a
    ``FakeTensorMode``); kernel entries report through
    :func:`repro_torch.kernels.fake.recording`.  :meth:`result` gives
    the counts."""

    def __init__(self, pod: int = POD):
        super().__init__()
        self.pod = pod
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.coll_bytes = 0.0
        self.coll_dcn = 0.0
        self.coll_by_kind: Dict[str, float] = defaultdict(float)
        self.coll_calls: Dict[str, int] = defaultdict(int)
        self.kernels: Dict[str, Dict[str, float]] = {}
        self.n_ops = 0
        self.live = 0
        self.peak = 0
        self._refs: Dict[int, List[int]] = {}     # storage -> [tensors, bytes]
        self._rec = None

    # ---- kernels ----------------------------------------------------
    def _kernel(self, name: str, flops: float, nbytes: float) -> None:
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0.0,
                                           "bytes": 0.0})
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes
        self.flops += flops
        self.hbm_bytes += nbytes

    def __enter__(self):
        from repro_torch.kernels import fake
        self._rec = fake.recording(self._kernel)
        self._rec.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._rec.__exit__(*exc)

    # ---- live storage -----------------------------------------------
    def track(self, tree: Any) -> None:
        """Count the storages of ``tree``'s tensors as live (tensors made
        before the mode was entered)."""
        for t in _tensors(tree):
            self._hold(t)

    def _hold(self, t: torch.Tensor) -> None:
        if t.device.type == "meta":     # shapes alone, on any device
            return
        try:
            st = t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return
        key = st._cdata
        ent = self._refs.get(key)
        if ent is None:
            ent = self._refs[key] = [0, st.nbytes()]
            self.live += ent[1]
            self.peak = max(self.peak, self.live)
        ent[0] += 1
        weakref.finalize(t, self._drop, key)

    def _drop(self, key: int) -> None:
        ent = self._refs.get(key)
        if ent is None:
            return
        ent[0] -= 1
        if ent[0] == 0:
            self.live -= ent[1]
            del self._refs[key]

    # ---- dispatch ---------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.n_ops += 1
        ns, name = func.namespace, func._opname
        if ns == "c10d":
            self._collective(name, args)
        elif ns == "aten":
            self._aten(func, name, args, kwargs, out)
        for t in _tensors(out):
            self._hold(t)
        return out

    def _aten(self, func, name, args, kwargs, out) -> None:
        from torch.utils.flop_counter import flop_registry
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
        outs = _tensors(out)
        if func.is_view or name in _NO_BYTES or any(
                t.device.type == "meta" for t in outs):
            return
        ins = _tensors((args, kwargs))
        if name in _INDEXED_WRITES and ins:
            self.hbm_bytes += 2 * sum(_nbytes(t) for t in ins[1:])
            return
        self.hbm_bytes += sum(_nbytes(t) for t in ins)
        self.hbm_bytes += sum(_nbytes(t) for t in outs)

    def _collective(self, name: str, args) -> None:
        spec = _C10D.get(name)
        if spec is None:
            return
        kind, i_in, i_out = spec
        in_b = sum(_nbytes(t) for t in _tensors(args[i_in]))
        out_b = sum(_nbytes(t) for t in _tensors(args[i_out]))
        ranks = _group_ranks(args)
        g = len(ranks) or 1
        b = collective_bytes(kind, out_b, in_b, g)
        self.coll_bytes += b
        self.coll_by_kind[kind] += b
        self.coll_calls[kind] += 1
        if ranks and min(ranks) // self.pod != max(ranks) // self.pod:
            self.coll_dcn += b

    def result(self) -> Dict[str, Any]:
        """``parse_hlo``'s keys that the roofline reads, with the kernel
        breakdown and the peak of live storage."""
        return {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "collective_bytes": self.coll_bytes,
            "collective_bytes_dcn": self.coll_dcn,
            "collective_by_kind": dict(self.coll_by_kind),
            "collective_calls": dict(self.coll_calls),
            "n_computations": self.n_ops,
            "kernels": {k: dict(v) for k, v in sorted(self.kernels.items())},
            "peak_live_bytes": self.peak,
        }

