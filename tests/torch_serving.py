"""Fixtures of the port's serving tests (tests/test_torch_serve.py,
test_torch_streaming.py, test_torch_baselines_cli.py).

``no_thread_outlives_module``: every test module that serves imports it
(an autouse, module-scoped fixture, so it is set up before the module's
services and HTTP servers and torn down after them); at teardown every
thread started during the module must have ended: the service loops, the
stream batchers, the HTTP servers and their handler threads.  A thread
left behind keeps its buffers alive in the test worker, where later
tests (the JAX package's serving soak among them) measure their memory.

``http_server``: an HTTP server on a free port, served from a thread that
is shut down and joined at teardown.
"""

from __future__ import annotations

import contextlib
import threading

import pytest

JOIN_SECONDS = 10.0


@pytest.fixture(scope="module", autouse=True)
def no_thread_outlives_module():
    before = set(threading.enumerate())
    yield
    left = [t for t in threading.enumerate() if t not in before]
    for t in left:
        t.join(JOIN_SECONDS)
    alive = [t.name for t in left if t.is_alive()]
    assert not alive, f"threads outlive their module: {alive}"


@contextlib.contextmanager
def http_server(service):
    """-> the base URL of ``make_http_server(service)`` on a free port;
    shuts the server down and joins its thread on exit."""
    from ha2g_torch.serve import make_http_server
    httpd = make_http_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True,
                              name="ha2g-test-http")
    thread.start()
    try:
        yield f"http://127.0.0.1:{httpd.server_address[1]}"
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(JOIN_SECONDS)
