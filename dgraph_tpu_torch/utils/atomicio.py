"""Atomic, fsync'd file replacement — THE way durable files change (copy
of ``dgraph_tpu/utils/atomicio.py``).

Every durability-relevant file of the port (store snapshots, client
checkpoints) must reach its final
name through the same three-step dance or a crash can observe a half
state: write to ``path + ".tmp"``, fsync the tmp, ``os.replace`` onto
the final name, then fsync the DIRECTORY so the rename itself is
durable (on ext4/xfs a crash right after replace can otherwise resurrect
the old name).

``site`` threads crash-test failpoints through the helper:
``<site>.tmp`` fires while the tmp is being written (a crash here leaves
only garbage that boot cleanup removes) and ``<site>.replace`` fires
after the tmp is durable but before the rename (a crash here keeps the
OLD file).
"""

from __future__ import annotations

import os
from typing import Iterable, Union

from dgraph_tpu_torch.utils.failpoints import fail


def fsync_dir(path: str) -> None:
    """Make a rename/creation in ``path`` durable.  Best-effort on
    filesystems that refuse O_RDONLY directory fsync (some network
    mounts): the replace is still atomic, only crash-durability of the
    rename itself degrades to the filesystem's default."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write_file(
    path: str,
    data: Union[bytes, Iterable[bytes]],
    site: str = "",
) -> None:
    """Durably replace ``path`` with ``data`` (bytes or an iterable of
    byte chunks, written streaming).  Raises OSError on any failure; the
    target file is either the complete old content or the complete new
    content, never a mix."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        if site:
            fail.point(site + ".tmp")
        if isinstance(data, (bytes, bytearray, memoryview)):
            f.write(data)
        else:
            for chunk in data:
                f.write(chunk)
        f.flush()
        os.fsync(f.fileno())
    if site:
        fail.point(site + ".replace")
    os.replace(tmp, path)
    fsync_dir(os.path.dirname(os.path.abspath(path)))
