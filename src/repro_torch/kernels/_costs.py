"""What each kernel launch declares to an active trace counter.

``roofline.trace_analysis.TraceCounter`` counts the aten ops a step runs;
a kernel here is a ``ctypes`` entry point, which no dispatch mode sees. So
each wrapper, where it counts a launch in its ``LAUNCHES``, calls
:func:`report` with the launch's dot FLOPs and the bytes it must move
(each input read once, each output written once: the counts of the bound
column of ``PERF.md``'s kernel table). Outside a counter this is one list
test.
"""

from __future__ import annotations

from typing import List

# the active trace counters, innermost last
COUNTERS: List = []


def report(name: str, dot_flops: int, nbytes: int) -> None:
    if COUNTERS:
        COUNTERS[-1].add_kernel(name, dot_flops, nbytes)
