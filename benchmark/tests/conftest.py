"""The `tiny` fixture: bench_tiny.make_tiny under the test's tmp_path."""

import pytest

from bench_tiny import make_tiny


@pytest.fixture
def tiny(tmp_path):
    return make_tiny(tmp_path)
