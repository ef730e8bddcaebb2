"""launches_per_step.online: device operations (kernels, copies, sets) per
step in the traced window, from the profiler's trace."""


def read(run):
    t = run.trace
    if t is None or not t.steps or not t.n_ops:
        return None
    return t.n_ops / t.steps
