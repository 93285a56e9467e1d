"""Test helpers of the port: :func:`.testing.execute_multiprocess` and the
multi-process scenario script (:mod:`.scripts.multihost_script`)."""

from .testing import execute_multiprocess

__all__ = ["execute_multiprocess"]
