"""One driver per kind of window. A driver's ``run(cell, seed, seconds,
trace, device, fault=None)`` makes the inputs, warms up, runs the window
and holds the program's outputs against the plain reference. It returns
the outcome the harness turns into the result line:

* ``window_start``: wall time (``time.time()``) the window opened;
* ``e2e``: the end-to-end metrics by the host's clock;
* ``layer``: what the per-layer readers read (``window_s``, ``trace``, ...);
* ``readings``: the numbers that decide `correct`;
* ``attempted``, ``failed``, ``kind``, ``memory_peak_bytes``.

``fault`` plants one of `kobench.faults` in the program for a check of the
check; a benchmark run never passes it.
"""
