"""One decoder on both sides of a port-against-JAX image comparison.

The JAX package's ``data/native`` builds its decoder with g++ straight onto
its final path, with no lock, the first time a process decodes. Under
pytest-xdist one worker can load the library while another is still
writing it: the loser keeps ``_LIB = None`` for the rest of its life and
decodes with PIL's bicubic resize, while the port's decoder (built to a
temporary file and renamed) stays native and bilinear.

``same_decoder(monkeypatch)`` runs before a test calls the JAX loader.
Where the JAX module holds no library, it resets ``_TRIED`` and calls the
module's own ``_load()`` again, a few times with a short wait, under a lock
file that the port's tests share, until it loads or ``LIMIT`` seconds have
passed: a build that another worker started has then finished writing.
Only where the JAX library cannot be had (no g++ or no libjpeg, where the
port's own build fails too, or the limit ran out) is the port's side made
to decode with PIL as well. Either way both sides then decode alike, and
the comparison stays byte for byte.
"""

from __future__ import annotations

import fcntl
import shutil
import tempfile
import time
from pathlib import Path

LIMIT = 60.0   # seconds to wait for a JAX build another worker started
WAIT = 0.5     # between two attempts
LOCK = "mmb_jax_decoder.lock"


def same_decoder(monkeypatch) -> None:
    """Load the JAX module's native decoder; where it cannot be had, patch
    the port's decoder to PIL for this test (``monkeypatch`` undoes it)."""
    from multimodal_baby_tpu.data import native as jnative
    from multimodal_baby_tpu_torch.data import native as tnative

    buildable = shutil.which("g++") is not None and tnative.available()
    if jnative._LIB is None and buildable:
        deadline = time.monotonic() + LIMIT
        with open(Path(tempfile.gettempdir()) / LOCK, "a") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            try:
                while True:
                    jnative._TRIED = False
                    if jnative._load() is not None \
                            or time.monotonic() > deadline:
                        break
                    time.sleep(WAIT)
            finally:
                fcntl.flock(lock, fcntl.LOCK_UN)
    if jnative._LIB is None:
        monkeypatch.setattr(tnative, "_load", lambda: None)
