"""Device operations (kernels, copies, sets) in the traced window per call: the
host's dispatch of the predictor, whose launch rate paces it."""


def read(run):
    trace, counters = run['trace'], run['counters']
    if not trace.launches or not counters.get('calls'):
        return None
    return trace.launches / counters['calls']
