"""A lock that runs the mesh test files' heavy subprocesses one at a time.

The mesh files (``tests/test_torch_mesh*.py``, ``test_torch_dryrun_memory.py``)
run the JAX reference on 8 forced host devices and the port's 8 gloo ranks
in subprocesses, each under a time limit, and pytest-xdist runs the files
side by side. Two such subprocesses at once starve each other past their
limits on a loaded CPU, so each is started under this lock; the wait for
it falls outside the subprocess's limit. The lock file lives beside the
session's base temp directory, which every xdist worker shares.
"""
from __future__ import annotations

import contextlib
import fcntl
import os


@contextlib.contextmanager
def cpu_lock(tmp: str):
    """Hold the lock around a heavy subprocess. ``tmp`` is a directory made
    by ``tmp_path_factory`` or ``tmp_path``: its parent is the worker's base
    temp directory, and that one's parent is shared by the session."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(tmp))),
                        "mesh-tests.lock")
    with open(path, "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)
