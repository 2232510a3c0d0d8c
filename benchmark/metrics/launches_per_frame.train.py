"""Device operations (kernels, copies, sets) in the traced window per frame
stepped: the host's dispatch of the train step, whose launch rate paces it."""


def read(run):
    trace, counters = run['trace'], run['counters']
    if not trace.launches or not counters.get('frames'):
        return None
    return trace.launches / counters['frames']
