"""inferences_per_s: samples scored over the window's wall time, the last
step synchronised."""


def read(run):
    if not run.samples:
        return None
    return run.samples / run.window_s
