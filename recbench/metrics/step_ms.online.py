"""step_ms.online: host milliseconds of one online step (the batch's copy
in, the forward and the logits back on the host), the mean over the
window's steps."""

import numpy as np


def read(run):
    if not run.step_s:
        return None
    return 1e3 * float(np.mean(run.step_s))
