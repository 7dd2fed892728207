"""A ``python -m spectral_tpu_torch render ...`` process driven the way a
user of the live view drives it, shared by the CPU tests
(``test_torch_viewer.py``, ``test_torch_cli_live.py``) and the card's
``chip_smoke.py`` (phase ``live_view``). Imports neither package.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def http_get(url):
    """(status, body) of a GET; 10 s timeout; an HTTP error raises."""
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.read()


def http_post(url, body: bytes):
    """(status, body) of a POST, an HTTP error's too; 10 s timeout."""
    req = urllib.request.Request(url, data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


class LiveRender:
    """``render`` with ``args`` in a process of its own, run from ``cwd``
    (a checkout of the repository), its stderr gathered by a thread so
    that no read blocks a wait. Every wait raises once the process has
    exited or ``deadline_s`` from the start has passed (or the wait's own,
    earlier deadline); ``close`` (and leaving a ``with`` block) kills the
    process if it still runs."""

    def __init__(self, args, deadline_s: float, cwd=REPO):
        self.end = time.monotonic() + deadline_s
        self.proc = subprocess.Popen([sys.executable, "-m", "spectral_tpu_torch", "render",
                                      *map(str, args)], cwd=cwd, stderr=subprocess.PIPE)
        self.last = None  # the last /status read
        self._err = bytearray()
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self):
        for chunk in iter(lambda: self.proc.stderr.read1(4096), b""):
            self._err.extend(chunk)

    @property
    def text(self) -> str:
        return bytes(self._err).decode(errors="replace")

    def wait(self, what, label: str, deadline_s: float | None = None):
        """Poll ``what()`` until it is truthy and return its value."""
        end = self.end if deadline_s is None else min(self.end, time.monotonic() + deadline_s)
        while True:
            got = what()
            if got:
                return got
            if self.proc.poll() is not None:
                raise AssertionError(f"the render exited waiting for {label}:\n{self.text}")
            if time.monotonic() > end:
                raise AssertionError(f"no {label} in time (last status {self.last}):\n"
                                     f"{self.text}")
            time.sleep(0.05)

    def url(self, deadline_s: float | None = None) -> str:
        """The live view's URL, from the ``live view at`` line."""
        found = self.wait(lambda: re.search(r"live view at (http://\S+)", self.text),
                          "'live view at'", deadline_s)
        return found.group(1)

    def status(self, url) -> dict:
        self.last = json.loads(http_get(url + "status")[1])
        return self.last

    def wait_status(self, url, pred, deadline_s: float | None = None) -> dict:
        """The first ``/status`` that ``pred`` accepts."""
        return self.wait(lambda: (lambda s: s if pred(s) else None)(self.status(url)),
                         "the /status awaited", deadline_s)

    def finish(self) -> str:
        """Wait for the exit, within the deadline, and return stderr."""
        self.proc.wait(timeout=max(1.0, self.end - time.monotonic()))
        self._reader.join(timeout=10)
        return self.text

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=10)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
