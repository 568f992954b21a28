# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""Repo-wide test isolation: every test sees the process environment it
started with, whatever the tests before it set.

A test may write `os.environ` through code it calls (bench.py exports
the tuning plan's hash with `setdefault`, and `monkeypatch.delenv` on an
absent variable records nothing to undo), and the variable would then
reach every later test in the same process.  The snapshot below is
taken before each test and restored after it: a test that passes alone
passes in any file order.

Under pytest-xdist each worker runs torch's CPU ops on one thread.  The
port's tests work on tiny tensors, and with several workers (and the
gloo ranks they spawn) on the cores, every intra-op parallel region of
an 8-thread pool waits on threads the kernel has descheduled: six
copies of tests/test_torch_spec.py side by side on an 8-core host took
531 s with torch's default pool and 69 s with one thread each (59.8 s
alone).  The spawned gloo ranks already set one thread.
"""

import os

import pytest

if os.environ.get("PYTEST_XDIST_WORKER"):
    try:
        import torch
    except ImportError:  # the JAX package's tests run without torch
        torch = None
    if torch is not None:
        torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _restore_environ():
    saved = dict(os.environ)
    yield
    for key in set(os.environ) - set(saved):
        del os.environ[key]
    for key, value in saved.items():
        if os.environ.get(key) != value:
            os.environ[key] = value
