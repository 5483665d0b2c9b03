"""Ecosystem compatibility shims.

The reference ships madsim-tokio: the same ``tokio::`` API surface that
transparently switches between the real runtime and the simulator at
build time (reference madsim-tokio/src/lib.rs:1-52). The Python analog is
:mod:`madsim_tpu_torch.compat.asyncio`: the asyncio API surface that dispatches
per call — inside a simulation it maps onto the deterministic runtime;
outside it delegates to the real asyncio, so one import works in tests
and in production:

    from madsim_tpu_torch.compat import asyncio   # instead of `import asyncio`

``install()`` registers the shim under the name ``asyncio`` in
``sys.modules`` for code you cannot edit (the Cargo-patch analog); call
``uninstall()`` to undo.
"""

import sys

from . import asyncio  # noqa: F401

_real_asyncio = None


def install() -> None:
    """Replace ``sys.modules['asyncio']`` with the dispatching shim."""
    global _real_asyncio
    import asyncio as real

    if real is not asyncio:
        _real_asyncio = real
        sys.modules["asyncio"] = asyncio


def uninstall() -> None:
    global _real_asyncio
    if _real_asyncio is not None:
        sys.modules["asyncio"] = _real_asyncio
        _real_asyncio = None
