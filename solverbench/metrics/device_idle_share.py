"""device_idle_share: 1 - (union of the device's operation intervals in
the traced steps) / (those steps' length at the measured window's pace),
in percent.  The profiler stretches the traced steps on the host (1.1-2.1x
on an H100) and not the device's operations, so their busy time is set
against the time the same steps take untraced."""


def read(run):
    tr, window_s = run.trace, run.device_window_s()
    if tr is None or not window_s or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / window_s)
