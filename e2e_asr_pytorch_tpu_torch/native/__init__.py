"""Native (C++) runtime components, loaded via ctypes.

Build happens lazily on first import: each .cpp is compiled with g++ -O3 into
a shared object next to the source. A pure-Python fallback is used if no
compiler is available (keeps the framework importable anywhere).
"""

import ctypes
import os
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
_LOCK = threading.Lock()
_LIBS = {}


def _build(name: str) -> str:
    src = os.path.join(_HERE, name + ".cpp")
    so = os.path.join(_HERE, name + ".so")
    if (not os.path.exists(so)) or os.path.getmtime(so) < os.path.getmtime(src):
        cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", src, "-o", so]
        subprocess.run(cmd, check=True, capture_output=True)
    return so


def load(name: str):
    """Load (building if needed) a native library; returns ctypes CDLL or None."""
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
        try:
            lib = ctypes.CDLL(_build(name))
        except Exception:
            lib = None
        _LIBS[name] = lib
        return lib
