"""Query shapes: one file each, found by name. A shape stages its query on
the program (``build``) and counts the bytes its inputs need
(``input_bytes``, for ``hbm_roofline``); its answer comes from the file
of the same name in ``perfbench/reference/``."""
