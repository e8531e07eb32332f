"""The benchmark's general parts: finding a cell's configuration, mix,
loop and metrics by name (``registry``), the seeded scene and weights
(``scene``, ``weights``), the record of one run (``runs``), the server
the serving loops drive (``served``), the trace reading (``trace``), the
comparison with the reference (``correct``) and the arithmetic the
metric readers share (``layer``)."""
