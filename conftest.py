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
"""

import os

import pytest


@pytest.fixture(autouse=True)
def _restore_environ():
    saved = dict(os.environ)
    yield
    for key in set(os.environ) - set(saved):
        del os.environ[key]
    for key, value in saved.items():
        if os.environ.get(key) != value:
            os.environ[key] = value
