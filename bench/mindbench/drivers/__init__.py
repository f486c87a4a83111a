"""One driver per kind of configuration, named by the configuration's
``driver`` key.  A driver module gives:

``run(cell, seed, seconds, traced, device, t_start, sync)``
    set-up, the measured window and the drain; a dict with ``setup_s``,
    ``attempted``, ``failed``, ``e2e`` (the end-to-end metrics it measures)
    and, traced, ``run`` (what the per-layer metrics read), ``spans`` and
    ``devtrace``, plus what ``check`` needs;
``check(cell, out)``
    ``[(name, value, limit)]`` of the comparison with the plain reference;
``control(cell, seed, seconds, device, sync)``
    the control's readings (and the program's, where one window gives
    both), for ``bench/control.py``.
"""
