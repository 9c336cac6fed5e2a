"""Drivers: one module per kind of traffic.  Each gives

    E2E, UNITS                      the end-to-end metrics it measures
    setup(run) -> state             inputs from the seed, the model, the warm-up
    unit(run, state, i) -> record   one unit of work of the window
    traced(run, state) -> int       the traced segment's work (units run)
    end_to_end(run, state) -> dict  the window's end-to-end metrics
    attempted_failed(run) -> (int, int)
    check(run, state) -> [(name, value, limit)]   the comparison with the reference
"""
