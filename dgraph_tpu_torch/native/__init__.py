"""Native (C++) N-Quad scanner of the bulk-ingest path (port of
``dgraph_tpu/native/__init__.py``).

The ingest hot loop (N-Quad scanning + string interning) is C++ behind
ctypes: ``nquad_scan.cpp`` beside this file, compiled with ``g++`` at
first use into the git-ignored ``dgraph_tpu_torch/_build/`` by the
port's build helper (``ops/_build.host_lib``).  Unlike the reference,
a failed compile or load RAISES, with the compiler's output: no path
quietly falls back to the Python parser.  Two routes to the Python
parser stay, as in the reference: ``DGRAPH_TPU_NO_NATIVE=1``, the
explicit switch (read on every call), under which :func:`scan` returns
None; and a body the scanner declines (a malformed one, stars in a set
block: ``serve/bulk.py``).
"""

from __future__ import annotations

import ctypes
import os
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "nquad_scan.cpp"

_lock = threading.Lock()
_lib = None

# flag bits — keep in sync with nquad_scan.cpp
F_OBJ_LITERAL = 1 << 0
F_HAS_LANG = 1 << 1
F_HAS_TYPE = 1 << 2
F_HAS_FACETS = 1 << 3
F_SUBJ_STAR = 1 << 4
F_PRED_STAR = 1 << 5
F_OBJ_STAR = 1 << 6
F_LIT_ESCAPED = 1 << 7
F_HAS_LABEL = 1 << 8


def enabled() -> bool:
    """False under ``DGRAPH_TPU_NO_NATIVE`` (the explicit switch to the
    Python parser)."""
    return not os.environ.get("DGRAPH_TPU_NO_NATIVE")


def scanner():
    """The loaded scanner library, built on first use.  Raises
    RuntimeError when it cannot be built, OSError when it cannot be
    loaded."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            from dgraph_tpu_torch.ops._build import host_lib

            lib = ctypes.CDLL(str(host_lib(SOURCE)))
            # buf, len, max_quads, then 27 output pointers (nq_scan)
            lib.nq_scan.argtypes = ([ctypes.c_char_p, ctypes.c_long, ctypes.c_long]
                                    + [ctypes.c_void_p] * 27)
            lib.nq_scan.restype = ctypes.c_long
            _lib = lib
        return _lib


class ScanResult:
    """SoA view of one scanned buffer (see nq_scan in nquad_scan.cpp)."""

    __slots__ = (
        "buf", "n", "subj_idx", "pred_idx", "obj_idx", "lang_idx", "type_idx",
        "lit_s", "lit_e", "facet_s", "facet_e", "flags",
        "subj_spans", "subj_uid", "pred_spans", "obj_spans", "obj_uid",
        "lang_spans", "type_spans",
    )

    def strings(self, spans) -> list:
        b = self.buf
        return [b[s:e].decode("utf-8", errors="replace") for s, e in spans]


def scan(text: str) -> Optional[ScanResult]:
    """Scan a block of N-Quads.  Returns None under
    ``DGRAPH_TPU_NO_NATIVE``; raises ValueError (with byte offset
    context) on malformed input — callers then parse with the Python
    parser for identical error surfaces."""
    if not enabled():
        return None
    lib = scanner()
    buf = text.encode("utf-8")
    ln = len(buf)
    # worst case one quad per 7 bytes ("* * * ."); size to line count + 1
    max_q = buf.count(b"\n") + 2 if ln else 1
    I32, I64, U16 = np.int32, np.int64, np.uint16
    r = ScanResult()
    r.buf = buf
    subj_idx = np.empty(max_q, I32); pred_idx = np.empty(max_q, I32)
    obj_idx = np.empty(max_q, I32); lang_idx = np.empty(max_q, I32)
    type_idx = np.empty(max_q, I32)
    lit_s = np.empty(max_q, I32); lit_e = np.empty(max_q, I32)
    facet_s = np.empty(max_q, I32); facet_e = np.empty(max_q, I32)
    flags = np.empty(max_q, U16)
    us_s = np.empty(max_q, I32); us_e = np.empty(max_q, I32); us_u = np.empty(max_q, I64)
    up_s = np.empty(max_q, I32); up_e = np.empty(max_q, I32)
    uo_s = np.empty(max_q, I32); uo_e = np.empty(max_q, I32); uo_u = np.empty(max_q, I64)
    ul_s = np.empty(max_q, I32); ul_e = np.empty(max_q, I32)
    ut_s = np.empty(max_q, I32); ut_e = np.empty(max_q, I32)
    counts = (ctypes.c_long * 5)()
    # the address of counts[i]: the unique tables' sizes come back there
    n_at = [ctypes.addressof(counts) + i * ctypes.sizeof(ctypes.c_long)
            for i in range(5)]

    def p(a):
        return a.ctypes.data

    got = lib.nq_scan(
        buf, ln, max_q,
        p(subj_idx), p(pred_idx), p(obj_idx), p(lang_idx), p(type_idx),
        p(lit_s), p(lit_e), p(facet_s), p(facet_e), p(flags),
        p(us_s), p(us_e), p(us_u), n_at[0],
        p(up_s), p(up_e), n_at[1],
        p(uo_s), p(uo_e), p(uo_u), n_at[2],
        p(ul_s), p(ul_e), n_at[3],
        p(ut_s), p(ut_e), n_at[4],
    )
    if got < 0:
        off = -got - 1
        snippet = buf[off : off + 60].decode("utf-8", errors="replace")
        raise ValueError(f"bad N-Quad at byte {off}: {snippet!r}")
    n = int(got)
    ns, npre, no, nl, nt = (int(counts[i]) for i in range(5))
    r.n = n
    r.subj_idx = subj_idx[:n]; r.pred_idx = pred_idx[:n]; r.obj_idx = obj_idx[:n]
    r.lang_idx = lang_idx[:n]; r.type_idx = type_idx[:n]
    r.lit_s = lit_s[:n]; r.lit_e = lit_e[:n]
    r.facet_s = facet_s[:n]; r.facet_e = facet_e[:n]; r.flags = flags[:n]
    r.subj_spans = np.stack([us_s[:ns], us_e[:ns]], axis=1) if ns else np.empty((0, 2), I32)
    r.subj_uid = us_u[:ns]
    r.pred_spans = np.stack([up_s[:npre], up_e[:npre]], axis=1) if npre else np.empty((0, 2), I32)
    r.obj_spans = np.stack([uo_s[:no], uo_e[:no]], axis=1) if no else np.empty((0, 2), I32)
    r.obj_uid = uo_u[:no]
    r.lang_spans = np.stack([ul_s[:nl], ul_e[:nl]], axis=1) if nl else np.empty((0, 2), I32)
    r.type_spans = np.stack([ut_s[:nt], ut_e[:nt]], axis=1) if nt else np.empty((0, 2), I32)
    return r
