"""layout_s: host seconds of the arena layer at set-up: the dense CSR
(``models/arena.py:csr_dense_from_edges``) and its grouped inline layout
(``bench2hop.layout``), uploads included."""


def read(run):
    return run.layout_s
