"""Numerical-debug helpers (SURVEY.md §5 "race detection/sanitizers").

XLA's execution model has no shared-memory races; the analogues of
the reference's debug build (-ggdb -DDBG, make_linux:19) are NaN
tracing and value checking:

- `nan_debug()`: context manager flipping jax_debug_nans so the first
  NaN-producing primitive raises with a traceback;
- `checked(fn)`: jax.experimental.checkify wrapper surfacing NaN/index
  errors from inside jitted code as returnable errors.
"""

from __future__ import annotations

import contextlib

import jax


@contextlib.contextmanager
def nan_debug(enable: bool = True):
    old = jax.config.read("jax_debug_nans")
    jax.config.update("jax_debug_nans", enable)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", old)


def checked(fn):
    """Returns g(*args) -> (error, out); error.throw() raises if any
    NaN / division / OOB fired inside."""
    from jax.experimental import checkify

    return checkify.checkify(
        fn, errors=checkify.float_checks | checkify.index_checks)
