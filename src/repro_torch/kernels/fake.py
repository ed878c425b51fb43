"""The kernel entries' path for fake tensors: the dry run's.

A fake tensor (``torch._subclasses.fake_tensor.FakeTensor``) has a
shape, a dtype and a device but no storage: ops on it compute shapes
only.  The dry run (:mod:`repro_torch.launch.dryrun`) drives a whole
step on such tensors, so every kernel entry of
:mod:`repro_torch.kernels.ops` (and the autograd functions behind it)
takes a third route beside the plain version and the kernel: it returns
outputs of the kernel's shapes and dtypes, builds nothing, launches
nothing and hands the call's work — the ``work()`` of its kernel module,
``(flops, bytes)`` — to every active sink under the key
``ops.launch_counts()`` uses.  No fake tensor ever runs a plain version.
"""

from __future__ import annotations

import contextlib
from typing import Callable, List, Tuple

#: the active sinks: ``sink(name, flops, nbytes)`` per fake call
_sinks: List[Callable[[str, float, float], None]] = []


def is_fake(t) -> bool:
    """Whether ``t`` is a fake tensor (no storage, shapes only)."""
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor)


def record(name: str, work: Tuple[float, float]) -> None:
    """Hand one fake call's ``(flops, bytes)`` to every active sink."""
    for sink in list(_sinks):
        sink(name, float(work[0]), float(work[1]))


@contextlib.contextmanager
def recording(sink: Callable[[str, float, float], None]):
    """Send the fake calls made inside the block to ``sink``."""
    _sinks.append(sink)
    try:
        yield sink
    finally:
        _sinks.remove(sink)


def lengths(cache_len, B: int, capacity: int) -> List[int]:
    """Each slot's cache length where it is an int, else the whole
    ``capacity`` (a fake tensor's values are not known): what a fake
    decode call counts."""
    if isinstance(cache_len, int):
        return [min(cache_len, capacity)] * B
    return [capacity] * B
