"""Build + ctypes bindings for ``libdeeprec_processor.so``.

The shared library itself (``processor.cc``) is the deliverable — any
RPC framework can ``dlopen`` it and call ``initialize`` / ``process`` /
``batch_process`` (the reference C ABI,
``serving/processor/serving/processor.h:4-12``).  This module compiles
it from ``processor.cc`` with the system ``g++`` when the library is
missing or older than its source (same pattern as
``deeprec_tpu/native``); no prebuilt binary is shipped, and a failed
build raises.  It also exposes a thin Python driver used by tests and
by Python hosts that want the ABI surface.

Each ``initialize`` spawns a serving worker process that opens the
accelerator. A JAX process reserves most of a card's memory when it
first uses it, so the host process that loads this library must not
itself hold the card: it stays off JAX, or runs JAX on the CPU.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "processor.cc")
_lock = threading.Lock()
_lib = None


def so_path() -> str:
    return os.path.join(_HERE, "libdeeprec_processor.so")


def build() -> str:
    """Compile ``processor.cc`` if the library is missing or stale;
    returns its path. Raises RuntimeError if the compiler fails."""
    out = so_path()
    if (os.path.exists(out)
            and os.path.getmtime(out) >= os.path.getmtime(_SRC)):
        return out
    with tempfile.TemporaryDirectory() as td:
        tmp = os.path.join(td, "p.so")
        try:
            subprocess.run(
                ["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
                 "-o", tmp, _SRC],
                check=True, capture_output=True, text=True, timeout=120)
        except (OSError, subprocess.SubprocessError) as e:
            detail = getattr(e, "stderr", None) or str(e)
            raise RuntimeError(
                f"building libdeeprec_processor.so from processor.cc "
                f"failed: {detail}") from e
        os.replace(tmp, out)
    return out


def load():
    """CDLL with argtypes bound (builds the library first if needed)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())
        vp = ctypes.c_void_p
        ip = ctypes.POINTER(ctypes.c_int)
        lib.initialize.restype = vp
        lib.initialize.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ip]
        lib.process.restype = ctypes.c_int
        lib.process.argtypes = [vp, ctypes.c_char_p, ctypes.c_int,
                                ctypes.POINTER(vp), ip]
        lib.batch_process.restype = ctypes.c_int
        lib.batch_process.argtypes = [
            vp, ctypes.POINTER(ctypes.c_char_p), ip, ctypes.c_int,
            ctypes.POINTER(vp), ip]
        lib.get_serving_model_info.restype = ctypes.c_int
        lib.get_serving_model_info.argtypes = [vp, ctypes.POINTER(vp), ip]
        lib.get_serving_endpoint.restype = ctypes.c_int
        lib.get_serving_endpoint.argtypes = [vp, ctypes.c_char_p,
                                             ctypes.c_int, ip]
        lib.deinitialize.restype = None
        lib.deinitialize.argtypes = [vp]
        _lib = lib
        return _lib


def _take_output(lib, out_p: ctypes.c_void_p, n: int) -> bytes:
    data = ctypes.string_at(out_p, n)
    libc = ctypes.CDLL(None)
    libc.free(ctypes.c_void_p(out_p))
    return data


class Processor:
    """Python driver over the C ABI (what an RPC host would do in C)."""

    def __init__(self, model_entry: str, model_config: dict):
        self._lib = load()
        cfg = dict(model_config)
        cfg.setdefault("python", sys.executable)
        state = ctypes.c_int(-1)
        self._h = self._lib.initialize(
            model_entry.encode(), json.dumps(cfg).encode(),
            ctypes.byref(state))
        if not self._h or state.value != 0:
            raise RuntimeError("processor initialize failed")

    def process(self, request: dict) -> dict:
        body = json.dumps(request).encode()
        out = ctypes.c_void_p()
        n = ctypes.c_int(0)
        rc = self._lib.process(self._h, body, len(body),
                               ctypes.byref(out), ctypes.byref(n))
        data = _take_output(self._lib, out.value, n.value) if out.value \
            else b""
        if rc != 0:
            raise RuntimeError(f"process rc={rc}: {data[:200]!r}")
        return json.loads(data)

    def batch_process(self, requests: list[dict]) -> list[dict]:
        bodies = [json.dumps(r).encode() for r in requests]
        n = len(bodies)
        ins = (ctypes.c_char_p * n)(*bodies)
        in_sizes = (ctypes.c_int * n)(*[len(b) for b in bodies])
        outs = (ctypes.c_void_p * n)()
        out_sizes = (ctypes.c_int * n)()
        rc = self._lib.batch_process(self._h, ins, in_sizes, n, outs,
                                     out_sizes)
        results = []
        for i in range(n):
            if outs[i]:
                results.append(json.loads(
                    _take_output(self._lib, outs[i], out_sizes[i])))
            else:
                results.append(None)
        if rc != 0:
            raise RuntimeError(f"batch_process rc={rc}")
        return results

    def endpoint(self) -> tuple[str, int]:
        host = ctypes.create_string_buffer(256)
        port = ctypes.c_int(0)
        rc = self._lib.get_serving_endpoint(self._h, host, 256,
                                            ctypes.byref(port))
        if rc != 0:
            raise RuntimeError(f"get_serving_endpoint rc={rc}")
        return host.value.decode(), port.value

    def model_info(self) -> dict:
        out = ctypes.c_void_p()
        n = ctypes.c_int(0)
        rc = self._lib.get_serving_model_info(
            self._h, ctypes.byref(out), ctypes.byref(n))
        data = _take_output(self._lib, out.value, n.value) if out.value \
            else b""
        if rc != 0:
            raise RuntimeError(f"get_serving_model_info rc={rc}")
        return json.loads(data)

    def close(self):
        if self._h:
            self._lib.deinitialize(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
