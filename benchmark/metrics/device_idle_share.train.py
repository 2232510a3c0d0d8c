"""The share of the untraced window in which no operation ran on the device,
during the train steps: 1 - busy / time, each per call. The busy time is
that of the traced calls (the union of every kernel's, copy's and set's
interval, user annotations left out); the time is that of the untraced
window run ahead of them, which the profiler's cost on the host does not
enter."""


def read(run):
    trace, counters, window = run['trace'], run['counters'], run.get('window')
    if not trace.launches or not counters.get('calls') or not window \
            or window['seconds'] <= 0 or not window['counters'].get('calls'):
        return None
    busy = trace.busy_s() / counters['calls']
    return 1.0 - busy / (window['seconds'] / window['counters']['calls'])
