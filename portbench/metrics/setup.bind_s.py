"""Seconds of the engine's set-up: ``Trainer.__init__``, whose
``FullGraphSource.bind`` builds the ELL on the host (``core/graph.to_ell``),
uploads it with the features and labels, and builds the reverse index
(``ops.build_reverse_index``); host clock with a synchronise after."""
UNIT = "s"


def read(record):
    return record["setup"]["bind_s"]
