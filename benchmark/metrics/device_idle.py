"""Share of the traced window in which nothing ran on the cell's first card
(no kernel, copy or set), from the device trace."""


def read(r):
    if r.busy_s is None or not r.window_s:
        return None
    return 100.0 * (1.0 - r.busy_s / r.window_s)
