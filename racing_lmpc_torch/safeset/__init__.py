"""Safe set of the port: the LMPC terminal-constraint data structure and
the error-dynamics regression."""

from racing_lmpc_torch.safeset.safe_set import (
    RegQuery, RegResult, SafeSetManager, SafeSetRecorder, SSQuery, SSResult)

__all__ = ["SafeSetManager", "SafeSetRecorder", "SSQuery", "SSResult",
           "RegQuery", "RegResult"]
