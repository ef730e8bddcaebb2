"""remap_s: host seconds in the port's remap set-up (``RemapSpec.
from_counts``, ``remap_table``, ``dlrm.add_remap``), each synchronised."""


def read(run):
    return run.remap_s
