"""Safe set of the port: the LMPC terminal-constraint data structure."""

from racing_lmpc_torch.safeset.safe_set import (
    SafeSetManager, SafeSetRecorder, SSQuery, SSResult)

__all__ = ["SafeSetManager", "SafeSetRecorder", "SSQuery", "SSResult"]
