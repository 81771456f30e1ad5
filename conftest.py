"""Build the native host library once, before pytest-xdist starts its workers.

``native/libaudiohost.so`` is built by ``make`` at its first use in a
process, under a lock that holds only within that process, and the Makefile
links straight onto its target. Under ``-n N`` several workers would run
``make`` at once; the ones that lose see no library, skip the tests marked
``skipif(not native.available())`` and fail those that decode FLAC. So the
controller (the process without ``workerinput``) builds the library when it
is absent. A failed build is left to the loader, as before.
"""

import os
import subprocess

NATIVE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native")


def pytest_configure(config):
    if hasattr(config, "workerinput"):
        return
    if os.path.exists(os.path.join(NATIVE, "libaudiohost.so")):
        return
    try:
        subprocess.run(["make", "-C", NATIVE], check=True, capture_output=True, timeout=120)
    except Exception:
        pass
