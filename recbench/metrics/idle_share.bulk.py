"""idle_share.bulk: the share of the traced window in which no
operation ran on the device (one minus the union of the device
operations' intervals over the window)."""


def read(run):
    t = run.trace
    if t is None or not t.n_ops or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
