"""Every CUDA kernel the profiler saw in the traced window (copies and
fills left out), over the queries completed in it: how many launches the
executor's host loop pays a query."""

import numpy as np

from portbench import trace


def read(rec):
    if not rec["queries"] or not rec["names"]:
        return None
    copy = np.array([trace.is_copy(n) for n in rec["names"]], dtype=bool)
    n = int((~copy[rec["name_idx"]]).sum())
    return n / rec["queries"], "launches/query"
