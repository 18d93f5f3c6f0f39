"""One traffic kind a module, found by the ``kind`` of the cell's traffic
file.  A module exposes ``Session(cell, seed, device)`` with:

  * ``setup()``: builds the program's object and warms up every shape the
    cell's traffic uses (for training, the first checked steps);
  * ``unit(i) -> dict``: the window's ``i``-th unit of work (a step or a
    request), synchronised, with ``tokens`` (real tokens done),
    ``latency_s`` and the counts the per-layer readers need
    (``model_flops``, ``gemm_bound_s``, ``flash_bound_s``);
  * ``finish() -> dict``: the program's readings for the comparison, the
    program's state freed after;
  * ``reference(readings, precision) -> dict``: the comparison's numbers,
    the reference run at ``precision`` on the same inputs.
"""
